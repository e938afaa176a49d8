// The grid route's entry points and its forms up to 1024 columns whose
// replicas of yD and of the cut weights live in each CTA's shared memory:
// the kernels' templates, the layouts and the design are in pdhg_grid.cuh;
// the far forms' launches (the replicas and the slots in global memory) are
// built from the same templates in pdhg_grid_far.cu (with cuts) and
// pdhg_grid_far_cert.cu (the certifier's pool), the 2048-column forms
// (both, at n > 1024) in pdhg_grid_vast.cu and pdhg_grid_vast_cert.cu, and
// the open forms (both, past n = 2048) in pdhg_grid_open.cu and
// pdhg_grid_open_cert.cu, each its own nvcc, in parallel.  `far` picks the
// form (lp/pdhg_grid.py grid_form chooses it by shape).

#include "pdhg_grid.cuh"

namespace pdhg_grid {

// a call of a form built apart: at 2048 columns and in the open form either
// form, else a far form; with cuts, or the certifier's pool
int apart(bool cuts, bool far_form, const FarCall& c) {
  if (c.cols == kOpen) return cuts ? open_cuts(c, far_form) : open_cert(c, far_form);
  if (c.cols == kVast) return cuts ? vast_cuts(c, far_form) : vast_cert(c, far_form);
  return cuts ? far_cuts(c) : far_cert(c);
}

// the forms built apart: the far forms, and every form at 2048 columns and
// past them
bool built_apart(int cols, bool far_form) { return far_form || cols == kVast || cols == kOpen; }

// The grid of the form at (cols, cuts, far).
int grid_of(int cols, bool cuts, bool far_form, int smem, int* P) {
  if (built_apart(cols, far_form))
    return apart(cuts, far_form, FarCall{FarCall::kCtas, cols, nullptr, nullptr, {}, 0, nullptr,
                                         smem, P, nullptr});
  if (!cuts) {
    return cols == kHuge ? FormLaunch<false, kHuge, false>::ctas(smem, P)
                         : FormLaunch<false, kWidest, false>::ctas(smem, P);
  }
  return at_width<true, false>(cols, [&](auto form) { return form.ctas(smem, P); });
}

// The layout of the form at cols (one of the five widths, or the open form).
GridLayout layout_of(int cols, int n, int m, int M, bool cuts, bool far) {
  switch (cols) {
    case kNarrow: return grid_layout<kNarrow>(n, m, M, cuts, far);
    case kWide: return grid_layout<kWide>(n, m, M, cuts, far);
    case kWidest: return grid_layout<kWidest>(n, m, M, cuts, far);
    case kHuge: return grid_layout<kHuge>(n, m, M, cuts, far);
    case kVast: return grid_layout<kVast>(n, m, M, cuts, far);
    default: return grid_layout<kOpen>(n, m, M, cuts, far);
  }
}

// The caller's plan against this file's: the width n's (cols_for; or the
// open form forced where the 2048-column form takes n, a measurement's), a
// pool of cuts of width 2..5 at any width, the certifier's pool (capacity 1,
// width 1) at 512 columns and past them and, in the far form, at any, and
// smem the layout's.
int check_form(int n, int M, int k, int m, int cols, int cuts, int far, int smem) {
  const bool forced_open = cols == kOpen && cols_for(n) == kVast;
  if (cols_for(n) == 0 || (cols != cols_for(n) && !forced_open) || m < 0 || M < 1)
    return kErrLayout;
  if (cuts ? (k < 2 || k > 5) : ((!far && cols < kWidest) || M != 1 || k != 1)) return kErrLayout;
  const GridLayout L = layout_of(cols, n, m, M, cuts != 0, far != 0);
  if (4 * static_cast<size_t>(L.words) != static_cast<size_t>(smem) ||
      4 * static_cast<size_t>(L.words) > 4 * static_cast<size_t>(kSmemWords))
    return kErrLayout;
  return 0;
}

// The block's launches (kCheck: its checked form) of the form at (cols,
// cuts, far).
int launch_block(bool checked, const BlockArgs& a, const Walk& w, int count, const int* ids,
                 int cols, int cuts, int far_form, int smem, int* grid, cudaStream_t st) {
  if (built_apart(cols, far_form != 0)) {
    return apart(cuts != 0, far_form != 0,
                 FarCall{checked ? FarCall::kChecked : FarCall::kBlock, cols, &a, nullptr, w,
                         count, ids, smem, grid, st});
  }
  const auto run = [&](auto form) { return form.block(checked, a, w, count, ids, smem, grid, st); };
  if (!cuts) {
    return cols == kHuge ? run(FormLaunch<false, kHuge, false>{})
                         : run(FormLaunch<false, kWidest, false>{});
  }
  return at_width<true, false>(cols, run);
}

// The norm's launches of the form at (cols, cuts, far).
int launch_norm(const NormArgs& a, const Walk& w, int B, int cols, int cuts, int far_form,
                int smem, int* grid, cudaStream_t st) {
  if (built_apart(cols, far_form != 0)) {
    return apart(cuts != 0, far_form != 0,
                 FarCall{FarCall::kNorm, cols, nullptr, &a, w, B, nullptr, smem, grid, st});
  }
  const auto run = [&](auto form) { return form.norm(a, w, B, smem, grid, st); };
  if (!cuts) {
    return cols == kHuge ? run(FormLaunch<false, kHuge, false>{})
                         : run(FormLaunch<false, kWidest, false>{});
  }
  return at_width<true, false>(cols, run);
}

// The walk's strides (count and ids are the launch's)
Walk walk(int ex, int eX, long long sG, long long sg) {
  Walk w{};
  w.ex = ex;
  w.eX = eX;
  w.sG = sG;
  w.sg = sg;
  return w;
}

// One instance's strides: its own rows, rounded up to 4 floats
Walk one(int n, int m) {
  const long long NN = static_cast<long long>(n) * n;
  return walk(0, 0, (m * NN + 3) & ~3LL, (static_cast<long long>(m) * n + 3) & ~3LL);
}

Problem problem(int n, int M, int k, int m, const float* G, const float* g, const int* idx,
                const float* lin, const float* quad, const float* rhs, const float* act,
                const int* xoff, const int* xcut, const float* xcoef, const int* Xoff,
                const int* Xcut, const float* Xcoef) {
  return Problem{n, m, M, k, G, g, idx, lin, quad, rhs, act, xoff, xcut, xcoef, Xoff, Xcut,
                 Xcoef};
}

}  // namespace pdhg_grid

using namespace pdhg_grid;

// `iters` iterations of the grid route's block for the instances
// ids[0..count) (increasing) of a batch stacked along the leading axis of
// every array, one after another in one launch, each with the steps and stop
// flag of its control record rec + ids[s] kRecWords (device memory, (B,
// kRecWords) int32): state x, X, yA, yB, yC, yD and sums ax, aX, aA, aB, ayC,
// ayD in, the same out (the outputs may be the inputs: the launch then
// updates the listed instances in place; without cuts yC and ayC are left as
// they are).  The pool (idx (M, k) int32, lin, quad, rhs, act) and its cut
// index (xoff, xcut, xcoef, Xoff, Xcut, Xcoef: build_cut_index; ex and eX the
// strides of its term rows) with cuts = 1; cuts = 0: the certifier's pool
// (M = 1, k = 1), whose arrays are not read.  G (m, n, n), g (m, n), h (m,):
// the dense rows, read in place, G and g 16-byte aligned with instance
// strides sG and sg floats (multiples of 4, at least m n n and m n).  cols:
// n's column width (cols_for; kOpen also forces the open form where kVast
// takes n); smem: the layout's bytes (lp/pdhg_grid.py block_words); work:
// work_words(n, m, M, P, cuts, false, far) floats, and in the open form
// open_words(n) more, the last the barrier's counter bar, zeroed here; P the
// grid (pdhg_grid_ctas), into *grid; far: 1 for the far form (the replicas and the slots in global
// memory), 0 for the form whose replicas are in shared memory.  Each
// instance computes the bits it computes alone.  Returns 0, a CUDA error,
// kErrLayout or kErrNoCluster.
extern "C" int pdhg_grid_block_batched_launch(
    int n, int M, int k, int m, int iters, int cols, int cuts, int smem, int count,
    const int* ids, const int* rec, int ex, int eX, long long sG, long long sg,
    const float* cx, const float* cX, const float* G, const float* g, const float* h,
    const int* idx, const float* lin, const float* quad, const float* rhs, const float* act,
    const int* xoff, const int* xcut, const float* xcoef, const int* Xoff, const int* Xcut,
    const float* Xcoef,
    const float* x, const float* X, const float* yA, const float* yB, const float* yC,
    const float* yD, const float* ax, const float* aX, const float* aA, const float* aB,
    const float* ayC, const float* ayD,
    float* xo, float* Xo, float* yAo, float* yBo, float* yCo, float* yDo,
    float* axo, float* aXo, float* aAo, float* aBo, float* ayCo, float* ayDo,
    float* work, unsigned* bar, int* grid, void* stream, int far) {
  const int err = check_form(n, M, k, m, cols, cuts, far, smem);
  if (err != 0) return err;
  if (iters < 0 || (count > 0 && ids == nullptr)) return kErrLayout;
  const BlockArgs a{problem(n, M, k, m, G, g, idx, lin, quad, rhs, act, xoff, xcut, xcoef, Xoff,
                            Xcut, Xcoef),
                    iters, const_cast<int*>(rec), cx, cX, h,
                    x, X, yA, yB, yC, yD, ax, aX, aA, aB, ayC, ayD,
                    xo, Xo, yAo, yBo, yCo, yDo, axo, aXo, aAo, aBo, ayCo, ayDo, work, bar};
  return launch_block(false, a, walk(ex, eX, sG, sg), count, ids, cols, cuts, far, smem, grid,
                      static_cast<cudaStream_t>(stream));
}

// The batch of one of pdhg_grid_block_batched_launch: instance 0 with the
// record rec (kRecWords int32).
extern "C" int pdhg_grid_block_launch(
    int n, int M, int k, int m, int iters, int cols, int cuts, int smem, const int* rec,
    const float* cx, const float* cX, const float* G, const float* g, const float* h,
    const int* idx, const float* lin, const float* quad, const float* rhs, const float* act,
    const int* xoff, const int* xcut, const float* xcoef, const int* Xoff, const int* Xcut,
    const float* Xcoef,
    const float* x, const float* X, const float* yA, const float* yB, const float* yC,
    const float* yD, const float* ax, const float* aX, const float* aA, const float* aB,
    const float* ayC, const float* ayD,
    float* xo, float* Xo, float* yAo, float* yBo, float* yCo, float* yDo,
    float* axo, float* aXo, float* aAo, float* aBo, float* ayCo, float* ayDo,
    float* work, unsigned* bar, int* grid, void* stream, int far) {
  const int id0 = 0;
  const Walk w = one(n, m);
  return pdhg_grid_block_batched_launch(
      n, M, k, m, iters, cols, cuts, smem, 1, &id0, rec, w.ex, w.eX, w.sG, w.sg, cx, cX, G, g, h,
      idx, lin, quad, rhs, act, xoff, xcut, xcoef, Xoff, Xcut, Xcoef, x, X, yA, yB, yC, yD, ax,
      aX, aA, aB, ayC, ayD, xo, Xo, yAo, yBo, yCo, yDo, axo, aXo, aAo, aBo, ayCo, ayDo, work, bar,
      grid, stream, far);
}

// The checked block, the grid route's solve step, for every instance b < B
// of a batch, one after another in one launch: `check_every` iterations of
// the block in place on the state and sums, then the checked block's
// control in place on the state, sums, anchor (zx, zX, zA, zB, zC, zD) and
// the record rec + b kRecWords; an instance whose record has stopped is
// left as it is, with everything else.  Arguments as for
// pdhg_grid_block_batched_launch, work holding work_words(n, m, M, P, cuts,
// true, far) floats (and open_words(n) in the open form).  Returns 0, a CUDA error, kErrLayout or kErrNoCluster.
extern "C" int pdhg_grid_block_checked_batched_launch(
    int n, int M, int k, int m, int check_every, int cols, int cuts, int smem, int B,
    int restart_period, int max_iters, float tol, int* rec, int ex, int eX, long long sG,
    long long sg,
    const float* cx, const float* cX, const float* G, const float* g, const float* h,
    const int* idx, const float* lin, const float* quad, const float* rhs, const float* act,
    const int* xoff, const int* xcut, const float* xcoef, const int* Xoff, const int* Xcut,
    const float* Xcoef,
    float* x, float* X, float* yA, float* yB, float* yC, float* yD,
    float* ax, float* aX, float* aA, float* aB, float* ayC, float* ayD,
    float* zx, float* zX, float* zA, float* zB, float* zC, float* zD,
    float* work, unsigned* bar, int* grid, void* stream, int far) {
  const int err = check_form(n, M, k, m, cols, cuts, far, smem);
  if (err != 0) return err;
  if (check_every < 1 || B < 1) return kErrLayout;
  const BlockArgs a{problem(n, M, k, m, G, g, idx, lin, quad, rhs, act, xoff, xcut, xcoef, Xoff,
                            Xcut, Xcoef),
                    check_every, rec, cx, cX, h,
                    x, X, yA, yB, yC, yD, ax, aX, aA, aB, ayC, ayD,
                    x, X, yA, yB, yC, yD, ax, aX, aA, aB, ayC, ayD, work, bar,
                    zx, zX, zA, zB, zC, zD, restart_period, max_iters, tol};
  return launch_block(true, a, walk(ex, eX, sG, sg), B, nullptr, cols, cuts, far, smem, grid,
                      static_cast<cudaStream_t>(stream));
}

// The batch of one of pdhg_grid_block_checked_batched_launch.
extern "C" int pdhg_grid_block_checked_launch(
    int n, int M, int k, int m, int check_every, int cols, int cuts, int smem,
    int restart_period, int max_iters, float tol, int* rec,
    const float* cx, const float* cX, const float* G, const float* g, const float* h,
    const int* idx, const float* lin, const float* quad, const float* rhs, const float* act,
    const int* xoff, const int* xcut, const float* xcoef, const int* Xoff, const int* Xcut,
    const float* Xcoef,
    float* x, float* X, float* yA, float* yB, float* yC, float* yD,
    float* ax, float* aX, float* aA, float* aB, float* ayC, float* ayD,
    float* zx, float* zX, float* zA, float* zB, float* zC, float* zD,
    float* work, unsigned* bar, int* grid, void* stream, int far) {
  const Walk w = one(n, m);
  return pdhg_grid_block_checked_batched_launch(
      n, M, k, m, check_every, cols, cuts, smem, 1, restart_period, max_iters, tol, rec, w.ex,
      w.eX, w.sG, w.sg, cx, cX, G, g, h, idx, lin, quad, rhs, act, xoff, xcut, xcoef, Xoff, Xcut,
      Xcoef, x, X, yA, yB, yC, yD, ax, aX, aA, aB, ayC, ayD, zx, zX, zA, zB, zC, zD, work, bar,
      grid, stream, far);
}

// ||K|| 1.02 + 1e-12 over the McCormick rows, the pool's cut rows (cuts = 1)
// and the m dense rows of every instance b < B of a batch, one after another
// in one launch, after `iters` power iterations from the start vector y
// (n,), Y (n, n), every instance's, read only, into out[b]; the pool and
// dense arguments, their strides, cols, smem and far as for
// pdhg_grid_block_batched_launch; work: norm_work_words(n, m, M, P, cuts)
// floats (and open_words(n) in the open form), the last the barrier's
// counter bar.  Returns 0, a CUDA error,
// kErrLayout or kErrNoCluster.
extern "C" int pdhg_grid_norm_batched_launch(
    int n, int M, int k, int m, int B, int iters, int cols, int cuts, int smem, int ex, int eX,
    long long sG, long long sg, const float* G, const float* g, const int* idx, const float* lin,
    const float* quad, const float* act, const int* xoff, const int* xcut, const float* xcoef,
    const int* Xoff, const int* Xcut, const float* Xcoef, const float* y, const float* Y,
    float* work, unsigned* bar, float* out, int* grid, void* stream, int far) {
  const int err = check_form(n, M, k, m, cols, cuts, far, smem);
  if (err != 0) return err;
  if (iters < 0 || B < 1) return kErrLayout;
  const NormArgs a{problem(n, M, k, m, G, g, idx, lin, quad, nullptr, act, xoff, xcut, xcoef,
                           Xoff, Xcut, Xcoef),
                   iters, y, Y, work, bar, out};
  return launch_norm(a, walk(ex, eX, sG, sg), B, cols, cuts, far, smem, grid,
                     static_cast<cudaStream_t>(stream));
}

// The batch of one of pdhg_grid_norm_batched_launch, into out[0].
extern "C" int pdhg_grid_norm_launch(
    int n, int M, int k, int m, int iters, int cols, int cuts, int smem, const float* G,
    const float* g, const int* idx, const float* lin, const float* quad, const float* act,
    const int* xoff, const int* xcut, const float* xcoef, const int* Xoff, const int* Xcut,
    const float* Xcoef, const float* y, const float* Y, float* work, unsigned* bar, float* out,
    int* grid, void* stream, int far) {
  const Walk w = one(n, m);
  return pdhg_grid_norm_batched_launch(n, M, k, m, 1, iters, cols, cuts, smem, w.ex, w.eX, w.sG,
                                       w.sg, G, g, idx, lin, quad, act, xoff, xcut, xcoef, Xoff,
                                       Xcut, Xcoef, y, Y, work, bar, out, grid, stream, far);
}

// The CTAs of the grid route's form at (n, M, k, m, far) with smem bytes a CTA:
// the blocks an SM holds at once of each of its kernels
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) times the SMs, into *grid.
// Returns 0, a CUDA error, kErrLayout or kErrNoCluster.
extern "C" int pdhg_grid_ctas(int n, int M, int k, int m, int cols, int cuts, int smem, int far,
                              int* grid) {
  const int err = check_form(n, M, k, m, cols, cuts, far, smem);
  if (err != 0) return err;
  return grid_of(cols, cuts != 0, far != 0, smem, grid);
}
