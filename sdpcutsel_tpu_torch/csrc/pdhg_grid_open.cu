// The grid route's open form with the cut pool (pdhg_grid.cuh,
// GridForm<kOpen>: the 2048-column form with its owned entries' buffer and
// its x entries in global memory, so that a CTA may own any number of
// them), its replicas in shared memory and the far form: the block, checked
// block and norm of each, for 2048 < n <= kOpenMax (pdhg_grid.cu's entry
// points call open_cuts).  A translation unit of its own, so that nvcc
// builds these kernels in parallel with the other forms'.

#include "pdhg_grid.cuh"

namespace pdhg_grid {

int open_cuts(const FarCall& c, bool far) { return wide_call<true, kOpen>(c, far); }

}  // namespace pdhg_grid
