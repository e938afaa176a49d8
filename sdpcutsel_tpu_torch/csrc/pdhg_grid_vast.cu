// The grid route's 2048-column forms with the cut pool (pdhg_grid.cuh,
// GridForm<kVast>: the owned state in global memory, the dense rows read in
// place), their replicas in shared memory and the far form: the block,
// checked block and norm of each, for 1024 < n <= 2048 (pdhg_grid.cu's entry
// points call vast_cuts).  A translation unit of its own, so that nvcc
// builds these kernels in parallel with the other forms'.

#include "pdhg_grid.cuh"

namespace pdhg_grid {

int vast_cuts(const FarCall& c, bool far) { return wide_call<true, kVast>(c, far); }

}  // namespace pdhg_grid
