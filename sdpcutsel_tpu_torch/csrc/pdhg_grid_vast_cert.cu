// The grid route's 2048-column forms without cuts (pdhg_grid.cuh,
// GridForm<kVast>), the certifier's pool past n = 1024: the block, checked
// block and norm, their replica of yD in shared memory and the far form
// (pdhg_grid.cu's entry points call vast_cert).  A translation unit of its
// own, so that nvcc builds these kernels in parallel with the other forms'.

#include "pdhg_grid.cuh"

namespace pdhg_grid {

int vast_cert(const FarCall& c, bool far) { return wide_call<false, kVast>(c, far); }

}  // namespace pdhg_grid
