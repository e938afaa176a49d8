"""Wrappers of the grid route's kernels (``csrc/pdhg_grid.cu``, templates in
``csrc/pdhg_grid.cuh``): the PDHG solve over a cooperative grid of one CTA
an SM, for the shapes K2's cluster (``lp/pdhg_kernel.py``) does not hold in
its shared memory: n up to 46,340, any pool larger than K2's bands leave room
for, and any number of a QCQP's dense rows past the few K2 holds at n > 128.
One instance, or a batch of one shape whose instances one launch walks one
after another, each over the whole grid.

- ``pdhg_grid_block`` / ``pdhg_grid_block_steps``: ``iters`` iterations of
  ``lp/pdhg.py::_one_iter`` with the ergodic sums, with host steps (the
  twin's and steering's) or in place with the steps and stop flag of the
  solve's control record.  Twins ``pdhg_block_plain`` and
  ``pdhg_block_steps_plain``.
- ``grid_checked_step`` / ``pdhg_grid_block_checked``: the solve's step, one
  launch of the block's checked form, whose epilogue is the checked block's
  control (K5's work) on the slices each CTA owns.  Twins
  ``pdhg_block_steps_plain`` then ``pdhg_check_plain``.
- ``pdhg_grid_norm``: ||K|| by the power iteration in one launch (K6's
  work), on the block's layout.  Twin ``estimate_norm_plain``.

- the instance axis (``parallel/round.py``'s batched round):
  ``pdhg_grid_block_batched`` (the instances ``ids``; twin
  ``pdhg_block_batched_plain``), ``pdhg_grid_block_steps_batched`` (twin
  ``pdhg_block_steps_batched_plain``), ``grid_checked_step(...,
  batched=True)`` / ``pdhg_grid_block_checked_batched`` (twins
  ``pdhg_block_steps_batched_plain`` then ``pdhg_check_batched_plain``) and
  ``pdhg_grid_norm_batched`` (twin ``estimate_norm_batched_plain``).  Each
  instance computes the bits it computes alone (the same partition and sum
  orders); one whose record has stopped is skipped.  ``dense_layout`` lays
  a batch's dense rows out with instance strides of 4 floats, once a solve.

They take the arguments of K2's, its checked form's and K6's wrappers
(single and batched), so the solve's loops (``lp/pdhg.py::_solve_impl``,
``_solve_batched``) run the route as they run K2's.  The kernels come in
two forms: a pool of cuts (k = 2..5, with its cut index) at the column
widths 128, 256, 512, 1024 and 2048 and in the open form past n = 2048
(``pdhg_kernel.columns``), and the certifier's pool without cuts at 512
columns and past them, which the dense route (``lp/pdhg_dense.py``) takes
past n = 256 (one instance).  ``grid_refusal`` says where the route does
not take a shape (n outside 1..46,340, past which an index of X's entries
would leave 32 bits; k outside 2..5).  The reference runs these shapes in XLA (its
Pallas kernel takes n <= 128, a pool of at most 1024 slots and no dense row,
``sdpcutsel_tpu/lp/pdhg.py:291-301``).

The layout (``block_words``) keeps the owned entries' state, the cut weights
and the dense rows' duals in a CTA's shared memory and gives the rest to the
dense rows' owned segments, resident for the launch where they fit and
streamed otherwise; at 1024 and 2048 columns the owned entries' state
stays in global memory (the outputs, updated in place, and the scratch),
since a CTA owns up to ~7,950 and ~31,800 entries there, and at 2048
columns the passes read the dense rows in place, a row's span being larger
than a ring stage.  The open form (n > 2048) is the 2048-column form with
no cap on what a CTA owns: its owned entries' buffer and its x entries
live in the global scratch and the outputs too (``open_words`` more
floats), every sum in the 2048-column form's order; ``_open`` forces it
where the 2048-column form takes n (measurements).  Where the replicas of the weights
and of the duals do not fit beside the rest (``grid_form``), or a CTA would
own more than 512 slots, the kernels' far form takes the shape: no
replica, the passes reading yD and the weights from global memory, each
CTA's slots in place in the outputs; it keeps every sum's order, so a shape
that fits either form gives the same bits in both.  The grid is every CTA
the card co-schedules (``grid_ctas``), whose global scratch ``work_words``
and ``norm_work_words`` give; the solve's step allocates it once a solve.

Device rule: CPU tensors take the twins; CUDA tensors launch the kernel; any
other device raises.  ``pdhg_grid_block.launches`` counts the block launches
of every block wrapper, the checked ones too (the dense route's past n = 256
among them); ``pdhg_grid_block_checked.launches`` the checked ones,
``pdhg_grid_norm.launches`` the norm's; a batched call counts one launch,
whatever B.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..relax.batched import batch_of_one
from ..relax.cutbuffer import CutIndex, CutPool
from ..relax.denserows import DenseRows
from .pdhg import (PDHGState, estimate_norm_batched_plain, estimate_norm_plain,
                   pdhg_check_batched_plain, pdhg_check_plain, start_vector)
from .pdhg_kernel import (_ERRORS, NMAX, OPEN, OPEN_NMAX, SMEM_MAX, VAST, _checked_args,
                          check_record, columns, pdhg_block_batched_plain, pdhg_block_plain,
                          pdhg_block_steps_batched_plain, pdhg_block_steps_plain, steps_record)

GRID_NMAX = OPEN_NMAX       # csrc/pdhg_common.cuh kOpenMax: the largest n the route takes
_THREADS = 512              # csrc/pdhg_common.cuh kThreads: a CTA's slots in the shared form
# csrc/pdhg_grid.cu GridForm<Cols>: (kMaxE, kChunks, kScratch, kStages, kState) by column width
FORMS = {128: (496, 1, 2048, 4, 8), 256: (500, 1, 2048, 4, 8), 512: (2036, 4, 8192, 3, 8),
         1024: (8180, 1, 2048, 4, 0), 2048: (31808, 1, 2304, 0, 0), OPEN: (0, 1, 2304, 0, 0)}
_STAGE = 8192               # kStage: floats a ring stage
_SMEM_WORDS = SMEM_MAX // 4
_NS, _ND = 10, 6            # kNS: a check point's sums; kND: the distances' partials
_META = 192                 # kMeta: the words of a CTA's Slices and its instance's
                            # arguments, first in its shared memory


def max_entries(n: int) -> int:
    """kMaxE at n's column width: the entries of X and x one CTA may own."""
    return FORMS[columns(n)][0]


def block_words(n: int, M: int, m: int, cuts: bool, far: bool = False,
                cols: int | None = None) -> int:
    """4-byte words of one CTA's shared memory for the block, its checked
    form and the norm at (n, pool capacity M, m dense rows): the sum of
    ``csrc/pdhg_grid.cuh``'s ``grid_layout`` at n's column width (the
    CTA's slices, the scratch, the slab of the dense rows' owned segments, which takes what
    the rest leaves and at least the ring, none without dense rows or at
    2048 columns, where the passes read the rows in place; the replicas of
    yD and, with cuts, of the pool's weights, none in the far form; the
    owned entries' buffer and their eight state arrays, none at 1024 and
    2048 columns, where the state lives in global memory; in the open form
    neither, the buffer in global memory too).  ``cols``: the form's width
    where it is not n's (the open form forced)."""
    kmax, _, scratch, stages, state = FORMS[columns(n) if cols is None else cols]
    replicas = 0 if far else m + (M if cuts else 0)
    rest = _META + scratch + replicas + (1 + state) * kmax
    free4 = (_SMEM_WORDS - rest) & ~3
    slab = max(free4, stages * _STAGE) if m * stages > 0 else 0
    return _META + scratch + slab + replicas + kmax + state * kmax


def work_words(n: int, m: int, M: int, P: int, cuts: bool, checked: bool,
               far: bool = False) -> int:
    """Floats of the block's global scratch on a grid of P CTAs:
    ``csrc/pdhg_grid.cuh``'s ``work_words`` (S, xb, the dense rows' partials;
    with cuts Xb and the weights; the checked form's M at the average, the
    average's partials, each CTA's sums and distances, in the far form with
    cuts the average's weights; the barrier's counter last)."""
    NN, Pm = n * n, P * m
    return (NN + n + Pm + ((NN + M) if cuts else 0)
            + ((NN + Pm + P * (2 * _NS + _ND)) if checked else 0)
            + (M if checked and far and cuts else 0) + 1)


def open_words(n: int) -> int:
    """Floats the open form's global scratch holds past ``work_words`` or
    ``norm_work_words`` (before the barrier's counter): the owned entries'
    buffer, each CTA's slice of [X | x] after the last one's, the owned x
    entries' three sums and the norm's second buffer of y
    (``csrc/pdhg_grid.cuh``'s ``open_words``)."""
    return n * n + 5 * n


def norm_work_words(n: int, m: int, M: int, P: int, cuts: bool) -> int:
    """Floats of the norm's global scratch on a grid of P CTAs:
    ``csrc/pdhg_grid.cuh``'s ``norm_work_words`` (the iterate Y and y, gX, the
    dense rows' partials, kD, with cuts the weights, each CTA's five sums;
    the barrier's counter last)."""
    return 2 * n * n + n + P * m + m + (M if cuts else 0) + 5 * P + 1


def grid_refusal(n: int, M: int, k: int, m: int) -> str | None:
    """Why the grid route does not take n, a pool of capacity M and width k,
    and m dense rows, or None where it does: 1 <= n <= 46,340 (past it an
    index of X's n n + n entries leaves 32 bits) and k = 2..5, any M >= 1
    and m >= 0 (the far form takes what the shared layout does not hold).
    Memory is torch's to refuse, at allocation."""
    if not 1 <= n <= GRID_NMAX:
        return f"the grid route takes 1 <= n <= {GRID_NMAX}, got {n}"
    if not 2 <= k <= 5:
        return f"the grid route takes cuts of width k = 2..5, got {k}"
    return None


def grid_form(n: int, M: int, m: int, cuts: bool) -> bool:
    """Whether the grid route takes (n, M, m) in its far form (True) by
    shape: where the shared layout's replicas of the weights and of yD do
    not fit a CTA beside the rest (``block_words``), and for the
    certifier's pool at n <= 256, which the route takes only past K7's rows.
    The launch also takes the far form where a CTA of the card's grid would
    own more than 512 slots (``_form``)."""
    return (not cuts and n <= NMAX) or 4 * block_words(n, M, m, cuts) > SMEM_MAX


def _args(cx, cX, pool: CutPool, index: CutIndex, states, dense: DenseRows | None, name: str):
    """Check a launch's arguments (one instance) with K2's checks; returns
    (n, M, k, m, cuts, the problem's contiguous tensors, dense)."""
    n, M, k, m = cx.shape[0], *pool.idx.shape, 0 if dense is None else dense.m
    cuts = (M, k) != (1, 1)
    if cuts:
        why = grid_refusal(n, M, k, m)
    else:
        from .pdhg_dense import dense_route_refusal, k7_takes

        why = dense_route_refusal(n, M, k, m)
        if why is None and k7_takes(n, m):
            why = (f"the grid route takes the certifier's pool past n = 256 or past K7's "
                   f"rows, got n={n}, m={m}")
    if why is not None:
        raise ValueError(f"{name}: {why}")
    _checked_args(cx[None], cX[None], batch_of_one(pool), batch_of_one(index),
                  [batch_of_one(s) for s in states],
                  None if dense is None else batch_of_one(dense), name)
    if dense is not None and any(t.data_ptr() % 16 or not t.is_contiguous()
                                 for t in (dense.G, dense.g)):
        dense = DenseRows(dense.G.contiguous().clone(), dense.g.contiguous().clone(), dense.h)
    problem = [t.contiguous() for t in (cx, cX, index.idx, pool.lin, pool.quad, pool.rhs,
                                        pool.active, index.xoff, index.xcut, index.xcoef,
                                        index.Xoff, index.Xcut, index.Xcoef)]
    d = [] if dense is None else [dense.G, dense.g, dense.h.contiguous()]
    return n, M, k, m, cuts, problem, d


def grid_ctas(n: int, M: int, k: int, m: int, far: bool | None = None) -> int:
    """The CTAs of the route's grid at (n, M, k, m) on the current card (the
    certifier's pool: M = k = 1), in the far form or not (None: the form
    the launch takes, ``_form``): those it co-schedules at the layout's
    shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs,
    asked once a device and size)."""
    return _form(n, M, k, m, far)[2]


def _ctas(n: int, M: int, k: int, m: int, far: bool, cols: int) -> int:
    cuts = (M, k) != (1, 1)
    out = ctypes.c_int(0)
    err = _build.lib().pdhg_grid_ctas(n, M, k, m, cols, int(cuts),
                                      4 * block_words(n, M, m, cuts, far, cols), int(far),
                                      ctypes.byref(out))
    if err in _ERRORS:
        raise RuntimeError(f"pdhg_grid_ctas: {_ERRORS[err]} (n={n}, M={M}, m={m}, far={far})")
    _build.check(err, "pdhg_grid_ctas")
    return out.value


def _form(n: int, M: int, k: int, m: int, far: bool | None = None,
          open_: bool = False) -> tuple[bool, int, int, int]:
    """(far, shared bytes a CTA, CTAs, column width) of a launch at (n, M,
    k, m): the far form where ``grid_form`` says so by shape, or where the
    card's grid would give a CTA of the shared form more than 512 pool
    slots; ``far`` forces a form, and ``open_`` the open form where the
    2048-column form takes n (a measurement's)."""
    cuts = (M, k) != (1, 1)
    cols = columns(n)
    if open_:
        if cols != VAST:
            raise ValueError(f"the open form is forced only where the 2048-column form takes n "
                             f"(1024 < n <= 2048), got n={n}")
        cols = OPEN
    forced = far is not None
    far = grid_form(n, M, m, cuts) if far is None else bool(far)
    P = _ctas(n, M, k, m, far, cols)
    if not (forced or far) and cuts and -(-M // P) > _THREADS:
        far = True
        P = _ctas(n, M, k, m, far, cols)
    return far, 4 * block_words(n, M, m, cuts, far, cols), P, cols


def _work(words: int, n: int, cols: int, dev) -> torch.Tensor:
    """A launch's global scratch: ``words`` floats (``work_words`` or
    ``norm_work_words``), and in the open form ``open_words(n)`` more."""
    extra = open_words(n) if cols == OPEN else 0
    return torch.empty(words + extra, dtype=torch.float32, device=dev)


def _pointers(problem, d):
    """(cx, cX, G, g, h, idx, lin, quad, rhs, act, xoff, xcut, xcoef, Xoff,
    Xcut, Xcoef) pointers in the C entries' order."""
    cx, cX, *pool = (t.data_ptr() for t in problem)
    return [cx, cX, *([t.data_ptr() for t in d] or [None] * 3), *pool]


def _raise(err: int, what: str, n: int, M: int, m: int):
    if err in _ERRORS:
        raise RuntimeError(f"{what}: {_ERRORS[err]} (n={n}, M={M}, m={m})")
    _build.check(err, what)


def _launch_block(cx, cX, pool: CutPool, index: CutIndex, ins, outs, rec, iters: int,
                  dense: DenseRows | None, far: bool | None = None, open_: bool = False) -> int:
    """The block's launch from the states ``ins`` (state, sums) into
    ``outs`` (which may be ``ins``) with the steps and stop flag of
    ``rec``, in the form ``_form`` takes (``far``, ``open_`` force one).
    Returns the CTAs launched."""
    n, M, k, m, cuts, problem, d = _args(cx, cX, pool, index, (*ins, *outs), dense,
                                         "pdhg_grid_block")
    far, smem, P, cols = _form(n, M, k, m, far, open_)
    work = _work(work_words(n, m, M, P, cuts, False, far), n, cols, cx.device)
    grid = ctypes.c_int(0)
    err = _build.lib().pdhg_grid_block_launch(
        n, M, k, m, iters, cols, int(cuts), smem, rec.data_ptr(), *_pointers(problem, d),
        *(t.data_ptr() for s in ins for t in s.fields()),
        *(t.data_ptr() for s in outs for t in s.fields()), work.data_ptr(),
        work[-1:].data_ptr(), ctypes.byref(grid), torch.cuda.current_stream(cx.device).cuda_stream,
        int(far))
    _raise(err, "pdhg_grid_block_launch", n, M, m)
    pdhg_grid_block.launches += 1
    return grid.value


def pdhg_grid_block(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState, acc: PDHGState,
                    tau: float, sigma: float, iters: int, dense: DenseRows | None = None, *,
                    _far: bool | None = None, _open: bool = False):
    """Run ``iters`` PDHG iterations from ``st`` with host steps tau and
    sigma and add each iterate to ``acc``; returns new (state, acc), the
    inputs left unchanged.  ``index`` is ``build_cut_index(pool, n)``.
    ``_far`` forces the kernels' form on CUDA, ``_open`` the open form at
    1024 < n <= 2048 (measurements only; by shape otherwise)."""
    if cx.device.type == "cpu":
        return pdhg_block_plain(cx, cX, pool, index, st, acc, tau, sigma, iters, dense)
    if cx.device.type == "cuda":
        ins = [st.map(lambda t: t.contiguous()), acc.map(lambda t: t.contiguous())]
        outs = [s.map(torch.empty_like) for s in ins]
        for o, s in zip(outs, ins):         # the certifier's pool: yC is left as it is
            o.yC.copy_(s.yC)
        _launch_block(cx, cX, pool, index, ins, outs,
                      steps_record([tau], [sigma], cx.device)[0], iters, dense, _far, _open)
        return outs[0], outs[1]
    raise ValueError(f"pdhg_grid_block: no kernel for device {cx.device}")


pdhg_grid_block.launches = 0


def pdhg_grid_block_steps(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState,
                          acc: PDHGState, rec, iters: int, dense: DenseRows | None = None, *,
                          _far: bool | None = None, _open: bool = False):
    """``pdhg_grid_block`` in place on (st, acc), with the steps of the
    solve's control record ``rec`` (int32 (REC_WORDS,) on the device), and
    nothing done once its stop flag is set.  Counted in
    ``pdhg_grid_block.launches``."""
    if cx.device.type == "cpu":
        pdhg_block_steps_plain(cx, cX, pool, index, st, acc, rec, iters, dense)
    elif cx.device.type == "cuda":
        check_record(rec[None], 1, cx.device, "pdhg_grid_block")
        if not all(t.is_contiguous() for s in (st, acc) for t in s.fields()):
            raise ValueError("pdhg_grid_block: an in-place launch takes contiguous state and sums")
        _launch_block(cx, cX, pool, index, [st, acc], [st, acc], rec, iters, dense, _far,
                      _open)
    else:
        raise ValueError(f"pdhg_grid_block: no kernel for device {cx.device}")


def _checked_launcher(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState, acc: PDHGState,
                      anchor: PDHGState, rec, check_every: int, restart_period: int,
                      max_iters: int, tol: float, dense: DenseRows | None,
                      far: bool | None = None, open_: bool = False):
    """The launch of the checked block, its arguments checked and its
    pointers taken once: a function of no arguments that enqueues one launch
    (the scratch allocated once, for every step)."""
    n, M, k, m, cuts, problem, d = _args(cx, cX, pool, index, (st, acc, anchor), dense,
                                         "pdhg_grid_block_checked")
    check_record(rec[None], 1, cx.device, "pdhg_grid_block_checked")
    if not all(t.is_contiguous() for s in (st, acc, anchor) for t in s.fields()):
        raise ValueError("pdhg_grid_block_checked kernel takes contiguous state, sums and anchor")
    if check_every < 1:
        raise ValueError(f"pdhg_grid_block_checked: check_every must be >= 1, got {check_every}")
    far, smem, P, cols = _form(n, M, k, m, far, open_)
    work = _work(work_words(n, m, M, P, cuts, True, far), n, cols, cx.device)
    grid = ctypes.c_int(0)
    args = (n, M, k, m, check_every, cols, int(cuts), smem, restart_period, max_iters,
            float(np.float32(tol)), rec.data_ptr(), *_pointers(problem, d),
            *(t.data_ptr() for s in (st, acc, anchor) for t in s.fields()),
            work.data_ptr(), work[-1:].data_ptr(), ctypes.byref(grid),
            torch.cuda.current_stream(cx.device).cuda_stream, int(far))
    fn = _build.lib().pdhg_grid_block_checked_launch

    def launch():
        _raise(fn(*args), "pdhg_grid_block_checked_launch", n, M, m)
        pdhg_grid_block.launches += 1
        pdhg_grid_block_checked.launches += 1

    launch.keep = (problem, d, work, grid)   # alive as long as the step
    return launch


def grid_checked_step(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState, acc: PDHGState,
                      anchor: PDHGState, rec, check_every: int, restart_period: int,
                      max_iters: int, tol: float, dense: DenseRows | None = None,
                      batched: bool = False, *, _far: bool | None = None,
                      _open: bool = False):
    """The solve's step on the grid route over fixed buffers
    (``pdhg_check.checked_step``'s contract): a function of no arguments
    that runs one checked block of ``check_every`` iterations in place on
    (st, acc, anchor) and the record ``rec`` (single: (REC_WORDS,);
    batched: every argument with the instance axis first, ``rec`` (B,
    REC_WORDS), the instances walked in one launch).  CPU tensors take the
    twins, CUDA tensors one launch a step; ``_far`` forces the kernels'
    form, ``_open`` the open form (measurements only; one instance)."""
    if cx.device.type == "cpu":
        block, check = ((pdhg_block_steps_batched_plain, pdhg_check_batched_plain) if batched
                        else (pdhg_block_steps_plain, pdhg_check_plain))

        def step():
            block(cx, cX, pool, index, st, acc, rec, check_every, dense)
            check(cx, cX, pool, index, st, acc, anchor, rec, check_every, restart_period,
                  max_iters, tol, dense)
        return step
    if cx.device.type != "cuda":
        raise ValueError(f"pdhg_grid_block_checked: no kernel for device {cx.device}")
    if batched:
        return _checked_batched_launcher(cx, cX, pool, index, st, acc, anchor, rec, check_every,
                                         restart_period, max_iters, tol, dense, _far)
    return _checked_launcher(cx, cX, pool, index, st, acc, anchor, rec, check_every,
                             restart_period, max_iters, tol, dense, _far, _open)


def pdhg_grid_block_checked(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState,
                            acc: PDHGState, anchor: PDHGState, rec, check_every: int,
                            restart_period: int, max_iters: int, tol: float,
                            dense: DenseRows | None = None, *, _far: bool | None = None,
                            _open: bool = False):
    """One checked block of ``check_every`` iterations and its control, in
    place on (st, acc, anchor) and the solve's record ``rec``
    (``pdhg_check.pdhg_block_checked``'s contract, on the grid route).  A
    launch counts in ``pdhg_grid_block.launches`` and here."""
    grid_checked_step(cx, cX, pool, index, st, acc, anchor, rec, check_every, restart_period,
                      max_iters, tol, dense, _far=_far, _open=_open)()


pdhg_grid_block_checked.launches = 0


def pdhg_grid_norm(pool: CutPool, n: int, iters: int, generator: torch.Generator | None,
                   index: CutIndex, dense: DenseRows | None = None, *,
                   _far: bool | None = None, _open: bool = False):
    """||K|| 1.02 + 1e-12 of a grid-route solve after ``iters`` power
    iterations from ``start_vector(n, generator, ...)`` (None: the seed-0
    draw, kept on the device; the launch only reads it): a 0-d float32
    tensor on the pool's device."""
    dev = pool.lin.device
    if dev.type == "cpu":
        return estimate_norm_plain(pool, n, iters, generator, index, dense)
    if dev.type != "cuda":
        raise ValueError(f"pdhg_grid_norm: no kernel for device {dev}")
    y, Y = (t.contiguous() for t in start_vector(n, generator, dev))
    # the start vector stands where cx and cX stand in the block's checks
    # (the same shapes); the norm reads neither
    n, M, k, m, cuts, problem, d = _args(y, Y, pool, index, (), dense, "pdhg_grid_norm")
    far, smem, P, cols = _form(n, M, k, m, _far, _open)
    work = _work(norm_work_words(n, m, M, P, cuts), n, cols, dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    grid = ctypes.c_int(0)
    ptrs = _pointers(problem, d)
    err = _build.lib().pdhg_grid_norm_launch(
        n, M, k, m, iters, cols, int(cuts), smem, ptrs[2], ptrs[3], ptrs[5], ptrs[6],
        ptrs[7], ptrs[9], *ptrs[10:], y.data_ptr(), Y.data_ptr(), work.data_ptr(),
        work[-1:].data_ptr(), out.data_ptr(), ctypes.byref(grid),
        torch.cuda.current_stream(dev).cuda_stream, int(far))
    _raise(err, "pdhg_grid_norm_launch", n, M, m)
    pdhg_grid_norm.launches += 1
    return out


pdhg_grid_norm.launches = 0


# ---- the instance axis: a batch of one shape, walked in one launch ----------------

def dense_layout(dense: DenseRows | None):
    """A batch's dense rows as the walk reads them: (G, g, h, sG, sg), G and
    g one row of sG and sg floats an instance (m n n and m n rounded up to 4
    floats, so that every instance's rows start 16-byte aligned), h
    contiguous; the batch's own tensors where they already lie so, else a
    copy, made once a solve by the solve's step and norm.  No rows: Nones
    and strides 0."""
    if dense is None:
        return None, None, None, 0, 0
    B, m, n = dense.g.shape
    sG, sg = -(-m * n * n // 4) * 4, -(-m * n // 4) * 4

    def lay(t, stride):
        flat = t.reshape(B, -1)
        if flat.shape[1] == stride and t.is_contiguous() and t.data_ptr() % 16 == 0:
            return t
        out = torch.zeros(B, stride, dtype=t.dtype, device=t.device)
        out[:, :flat.shape[1]] = flat
        return out

    return lay(dense.G, sG), lay(dense.g, sg), dense.h.contiguous(), sG, sg


def _batched_args(cx, cX, pool: CutPool, index: CutIndex, states, dense: DenseRows | None,
                  name: str, layout=None):
    """Check a batched launch's arguments (every argument with the instance
    axis first, a pool of cuts) with K2's checks and the route's refusal;
    returns (B, n, M, k, m, the problem's contiguous tensors, the dense
    rows' (G, g, h) and the walk's strides (ex, eX, sG, sg)).  ``layout``:
    ``dense_layout(dense)`` where the caller keeps it."""
    B, n, M, k, m, ex, eX = _checked_args(cx, cX, pool, index, states, dense, name)
    why = grid_refusal(n, M, k, m)
    if why is not None:
        raise ValueError(f"{name}: {why}")
    G, g, h, sG, sg = dense_layout(dense) if layout is None else layout
    problem = [t.contiguous() for t in (cx, cX, index.idx, pool.lin, pool.quad, pool.rhs,
                                        pool.active, index.xoff, index.xcut, index.xcoef,
                                        index.Xoff, index.Xcut, index.Xcoef)]
    d = [] if dense is None else [G, g, h]
    return B, n, M, k, m, problem, d, (ex, eX, sG, sg)


def _launch_block_batched(cx, cX, pool: CutPool, index: CutIndex, ins, outs, rec, iters: int,
                          ids: np.ndarray, dense: DenseRows | None) -> int:
    """The batched block's launch for the instances ``ids`` from the states
    ``ins`` (state, sums) into ``outs`` (which may be ``ins``), each with the
    steps and stop flag of its row of ``rec``.  Returns the CTAs launched."""
    B, n, M, k, m, problem, d, strides = _batched_args(cx, cX, pool, index, (*ins, *outs), dense,
                                                       "pdhg_grid_block")
    far, smem, P, cols = _form(n, M, k, m)
    work = _work(work_words(n, m, M, P, True, False, far), n, cols, cx.device)
    grid = ctypes.c_int(0)
    count = int(ids.size)
    err = _build.lib().pdhg_grid_block_batched_launch(
        n, M, k, m, iters, cols, 1, smem, count,
        (ctypes.c_int * max(count, 1))(*ids.tolist()), rec.data_ptr(), *strides,
        *_pointers(problem, d), *(t.data_ptr() for s in ins for t in s.fields()),
        *(t.data_ptr() for s in outs for t in s.fields()), work.data_ptr(),
        work[-1:].data_ptr(), ctypes.byref(grid), torch.cuda.current_stream(cx.device).cuda_stream,
        int(far))
    _raise(err, "pdhg_grid_block_batched_launch", n, M, m)
    pdhg_grid_block.launches += 1
    return grid.value


def pdhg_grid_block_batched(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState,
                            acc: PDHGState, tau, sigma, iters: int, ids,
                            dense: DenseRows | None = None):
    """``pdhg_grid_block`` for the instances ``ids`` (increasing) of a batch
    in one launch on CUDA, one instance after another: every argument
    carries the instance axis first, ``index`` is
    ``relax.batched.build_cut_index(pool, n)``, tau and sigma are (B,)
    per-instance steps.  Returns new batched (state, acc); the instances not
    in ``ids`` come back unchanged, bit for bit, and the inputs are left as
    they were.  Twin ``pdhg_block_batched_plain``.  Counted in
    ``pdhg_grid_block.launches``."""
    if cx.device.type == "cpu":
        return pdhg_block_batched_plain(cx, cX, pool, index, st, acc, tau, sigma, iters, ids,
                                        dense)
    if cx.device.type != "cuda":
        raise ValueError(f"pdhg_grid_block: no kernel for device {cx.device}")
    B = cx.shape[0]
    ids = np.asarray(ids, dtype=np.int64).reshape(-1)
    if ids.size and (ids.min() < 0 or ids.max() >= B or (np.diff(ids) <= 0).any()):
        raise ValueError(f"pdhg_grid_block: ids must be increasing instances of 0..{B - 1}")
    ins = [st.map(lambda t: t.contiguous()), acc.map(lambda t: t.contiguous())]
    if ids.size == B:
        outs = [s.map(torch.empty_like) for s in ins]
    else:
        # the instances left out keep their inputs: copy all of them, then
        # update the listed ones in place
        outs = ins = [s.map(torch.clone) for s in ins]
    _launch_block_batched(cx, cX, pool, index, ins, outs,
                          steps_record(tau, sigma, cx.device), iters, ids, dense)
    return outs[0], outs[1]


def pdhg_grid_block_steps_batched(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState,
                                  acc: PDHGState, rec, iters: int,
                                  dense: DenseRows | None = None):
    """``pdhg_grid_block_steps`` of every instance of a batch in one launch:
    records (B, REC_WORDS); an instance whose record has stopped is left as
    it is, bit for bit.  Twin ``pdhg_block_steps_batched_plain``.  Counted in
    ``pdhg_grid_block.launches``."""
    if cx.device.type == "cpu":
        pdhg_block_steps_batched_plain(cx, cX, pool, index, st, acc, rec, iters, dense)
    elif cx.device.type == "cuda":
        B = cx.shape[0]
        check_record(rec, B, cx.device, "pdhg_grid_block")
        if not all(t.is_contiguous() for s in (st, acc) for t in s.fields()):
            raise ValueError("pdhg_grid_block: an in-place launch takes contiguous state and sums")
        _launch_block_batched(cx, cX, pool, index, [st, acc], [st, acc], rec, iters,
                              np.arange(B), dense)
    else:
        raise ValueError(f"pdhg_grid_block: no kernel for device {cx.device}")


def _checked_batched_launcher(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState,
                              acc: PDHGState, anchor: PDHGState, rec, check_every: int,
                              restart_period: int, max_iters: int, tol: float,
                              dense: DenseRows | None, far: bool | None = None):
    """The batched checked block's launch, its arguments checked, its dense
    rows laid out and its pointers taken once a solve: a function of no
    arguments that enqueues one launch for every instance."""
    B, n, M, k, m, problem, d, strides = _batched_args(cx, cX, pool, index, (st, acc, anchor),
                                                       dense, "pdhg_grid_block_checked")
    check_record(rec, B, cx.device, "pdhg_grid_block_checked")
    if not all(t.is_contiguous() for s in (st, acc, anchor) for t in s.fields()):
        raise ValueError("pdhg_grid_block_checked kernel takes contiguous state, sums and anchor")
    if check_every < 1:
        raise ValueError(f"pdhg_grid_block_checked: check_every must be >= 1, got {check_every}")
    far, smem, P, cols = _form(n, M, k, m, far)
    work = _work(work_words(n, m, M, P, True, True, far), n, cols, cx.device)
    grid = ctypes.c_int(0)
    args = (n, M, k, m, check_every, cols, 1, smem, B, restart_period, max_iters,
            float(np.float32(tol)), rec.data_ptr(), *strides, *_pointers(problem, d),
            *(t.data_ptr() for s in (st, acc, anchor) for t in s.fields()),
            work.data_ptr(), work[-1:].data_ptr(), ctypes.byref(grid),
            torch.cuda.current_stream(cx.device).cuda_stream, int(far))
    fn = _build.lib().pdhg_grid_block_checked_batched_launch

    def launch():
        _raise(fn(*args), "pdhg_grid_block_checked_batched_launch", n, M, m)
        pdhg_grid_block.launches += 1
        pdhg_grid_block_checked.launches += 1

    launch.keep = (problem, d, work, grid)   # alive as long as the step
    return launch


def pdhg_grid_block_checked_batched(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState,
                                    acc: PDHGState, anchor: PDHGState, rec, check_every: int,
                                    restart_period: int, max_iters: int, tol: float,
                                    dense: DenseRows | None = None):
    """``pdhg_grid_block_checked`` of every instance of a batch in one
    launch: every argument carries the instance axis first, ``index`` is
    ``relax.batched.build_cut_index(pool, n)``, ``rec`` is (B, REC_WORDS).
    One launch counts once in ``pdhg_grid_block.launches`` and
    ``pdhg_grid_block_checked.launches``, whatever B."""
    grid_checked_step(cx, cX, pool, index, st, acc, anchor, rec, check_every, restart_period,
                      max_iters, tol, dense, batched=True)()


def pdhg_grid_norm_batched(pool: CutPool, n: int, iters: int,
                           generator: torch.Generator | None, index: CutIndex,
                           dense: DenseRows | None = None):
    """``pdhg_grid_norm`` of every instance of a batch (``relax/batched.py``
    shapes) in one launch, one instance after another, each from the same
    start vector (``pdhg_norm.pdhg_norm_batched``'s): (B,) float32 on the
    pool's device.  Twin ``estimate_norm_batched_plain``.  Counted in
    ``pdhg_grid_norm.launches``."""
    dev = pool.lin.device
    if dev.type == "cpu":
        return estimate_norm_batched_plain(pool, n, iters, generator, index, dense)
    if dev.type != "cuda":
        raise ValueError(f"pdhg_grid_norm: no kernel for device {dev}")
    return _launch_norm_batched(pool, n, iters, generator, index, dense)


def _launch_norm_batched(pool: CutPool, n: int, iters: int, generator: torch.Generator | None,
                         index: CutIndex, dense: DenseRows | None):
    """The batched norm's launch: (B,) float32 on the pool's device."""
    dev = pool.lin.device
    B = pool.lin.shape[0]
    y, Y = (t.contiguous() for t in start_vector(n, generator, dev))
    # the start vector, broadcast, stands where cx and cX stand in the
    # block's checks; the norm reads it once, for every instance
    _, n, M, k, m, problem, d, strides = _batched_args(
        y.expand(B, n), Y.expand(B, n, n), pool, index, (), dense, "pdhg_grid_norm")
    far, smem, P, cols = _form(n, M, k, m)
    work = _work(norm_work_words(n, m, M, P, True), n, cols, dev)
    out = torch.empty(B, dtype=torch.float32, device=dev)
    grid = ctypes.c_int(0)
    ptrs = _pointers(problem, d)
    err = _build.lib().pdhg_grid_norm_batched_launch(
        n, M, k, m, B, iters, cols, 1, smem, *strides, ptrs[2], ptrs[3], ptrs[5], ptrs[6],
        ptrs[7], ptrs[9], *ptrs[10:], y.data_ptr(), Y.data_ptr(), work.data_ptr(),
        work[-1:].data_ptr(), out.data_ptr(), ctypes.byref(grid),
        torch.cuda.current_stream(dev).cuda_stream, int(far))
    _raise(err, "pdhg_grid_norm_batched_launch", n, M, m)
    pdhg_grid_norm.launches += 1
    return out
