// The grid route's far form with the cut pool (pdhg_grid.cuh, kFar) at the
// four column widths: its block, checked block and norm, for the shapes whose
// replicas of yD and of the cut weights do not fit a CTA's shared memory, or
// whose pool has more than kThreads slots a CTA (pdhg_grid.cu's entry points
// call far_cuts).  A translation unit of its own, so that nvcc builds these
// kernels in parallel with the other forms'.

#include "pdhg_grid.cuh"

namespace pdhg_grid {

int far_cuts(const FarCall& c) { return far_call<true>(c); }

}  // namespace pdhg_grid
