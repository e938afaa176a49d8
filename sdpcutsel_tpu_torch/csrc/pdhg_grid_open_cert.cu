// The grid route's open form without cuts (pdhg_grid.cuh, GridForm<kOpen>),
// the certifier's pool past n = 2048: the block, checked block and norm,
// their replica of yD in shared memory and the far form (pdhg_grid.cu's
// entry points call open_cert).  A translation unit of its own, so that
// nvcc builds these kernels in parallel with the other forms'.

#include "pdhg_grid.cuh"

namespace pdhg_grid {

int open_cert(const FarCall& c, bool far) { return wide_call<false, kOpen>(c, far); }

}  // namespace pdhg_grid
