// The grid route's far form without cuts (pdhg_grid.cuh, kFar), the
// certifier's pool, at the four column widths: its block, checked block and
// norm, for the dense route's rows past what K7 (n <= 256) or the shared
// layout's replica of yD holds (pdhg_grid.cu's entry points call far_cert).
// A translation unit of its own, so that nvcc builds these kernels in
// parallel with the other forms'.

#include "pdhg_grid.cuh"

namespace pdhg_grid {

int far_cert(const FarCall& c) { return far_call<false>(c); }

}  // namespace pdhg_grid
