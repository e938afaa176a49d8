"""Wrappers of the dense-row route's kernels (``csrc/pdhg_dense.cu``, K7):
the LP of the SDP certifier (``loop/sdp_bound.py``), a pool that holds no
cut and any number m of dense rows, on the card.

- ``pdhg_dense_block`` / ``pdhg_dense_block_steps``: ``iters`` iterations of
  ``lp/pdhg.py::_one_iter`` with the ergodic sums, with host steps (the
  twin's and steering's) or in place with the steps and stop flag of the
  solve's control record.  Twins ``pdhg_block_plain`` and
  ``pdhg_block_steps_plain``.
- ``dense_checked_step`` / ``pdhg_dense_block_checked``: the solve's step,
  one launch of the block's checked form, whose epilogue (K7c) is the
  checked block's control (K5's work with the dense residuals) on the
  slices each CTA owns.  Twins ``pdhg_block_steps_plain`` then
  ``pdhg_check_plain``.
- ``pdhg_dense_norm``: ||K|| by the power iteration in one launch (K6's
  work, K7n), on the block's launch plan and layout.  Twin
  ``estimate_norm_plain``.

They take the same arguments as K2's, its checked form's and K6's wrappers,
so the solve's loop (``lp/pdhg.py::_solve_impl``) runs either route.  The
reference runs this LP in XLA (its Pallas kernel refuses dense rows,
``sdpcutsel_tpu/lp/pdhg.py:291-301``): none has a Pallas counterpart.

Shapes: n <= 46,340 (``pdhg_kernel.OPEN_NMAX``), the certifier's pool (one slot of width 1, never filled:
``dense_route_refusal``), any m >= 0.  K7 takes n <= 256 and m up to what
one CTA's shared memory holds of the rows' duals beside the grid plan's
ring (``k7_takes``, ``dense_refusal``, ``max_dense_rows``: ~22,800 at
n = 125).  The "grid" kernels come in K2's two column widths
(``pdhg_kernel.columns``: 128 for n <= 128, 256 up to n = 256), which set
the entries a CTA may own (``_MAX_E``, ``_MAX_E_WIDE``); past n = 256, and
past K7's rows at n <= 256, the wrappers launch the grid route's kernels
in their form without cuts (``lp/pdhg_grid.py``, ``csrc/pdhg_grid.cu``),
counted there: with the rows' duals in shared memory up to ~6,800 rows for
256 < n <= 512 and ~14,900 past n = 512, in the far form past them; past
n = 2048 the grid route's open form without cuts.  The launch
plan goes by shape (``block_plan``), the same for the block, its checked form and the
norm: "cta", one CTA that holds G and g in
its shared memory for the launch (the small sandwiches, n <= ``CTA_MAX_N``),
or "grid", one CTA on every SM, launched cooperatively, each CTA's slice of
G and g resident in its shared memory or streamed from global memory (the
grid the card co-schedules: ``block_grid``).  G, g and h are read where they
lie (the certifier's buffer views), never copied.  yC and its sum are left
as they are: the twin keeps them at 0 on a pool whose rows are all
inactive.

Device rule: CPU tensors take the twin; CUDA tensors launch the kernel; any
other device raises.  ``pdhg_dense_block.launches`` counts the block
launches of every block wrapper, the checked ones too;
``pdhg_dense_block_checked.launches`` the checked ones (K7c ran in them),
``pdhg_dense_norm.launches`` the norm's.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..relax.cutbuffer import CutIndex, CutPool
from ..relax.denserows import DenseRows
from .pdhg import PDHGState, estimate_norm_plain, pdhg_check_plain, start_vector
from . import pdhg_grid
from .pdhg_kernel import (_ERRORS, NARROW, NMAX, SMEM_MAX, check_record, columns,
                          pdhg_block_plain, pdhg_block_steps_plain, steps_record)

_THREADS = 512              # csrc/pdhg_common.cuh kThreads
PLANS = ("cta", "grid")     # the launch plans (csrc/pdhg_dense.cu)
CTA_MAX_N = 32              # csrc/pdhg_dense.cu kCtaMaxN: the "cta" plan's largest n
_STAGE, _STAGES = 8192, 4   # kStage, kStages: the "grid" plan's ring of G stages
_MAX_E = 496                # GridWidth<128>::kMaxE: entries of X and x a CTA of the grid owns
_MAX_E_WIDE = 500           # GridWidth<256>::kMaxE (spans of at most 128 chunks of 4)
_SCRATCH = 2048             # kScratch: the grid plan's strand partials and weights
_SMEM_WORDS = SMEM_MAX // 4  # kSmemWords: the grid plan takes a CTA's whole shared memory
_NV, _ND = 8, 6             # kNV, kND: a check point's partial sums, the distances' partials


def _block_words(plan: str, n: int, m: int) -> int:
    """4-byte words of one CTA's shared memory for the block under ``plan``:
    ``csrc/pdhg_dense.cu``'s ``cta_layout`` (G and g of every row) or
    ``grid_layout`` at n's column width (the slab of G's owned segments,
    resident or a ring of stages, takes what yD and the owned entries'
    buffers leave of a CTA's shared memory, and at least the ring)."""
    V4 = (n * n + n + 3) & ~3                      # a staged row, padded for 16-byte loads
    if plan == "cta":
        return m * V4 + 8 * n * n + 2 * V4 + 3 * n + 4 * m + 4 * _THREADS
    if plan == "grid":
        rest = _SCRATCH + m + max_entries(n)
        return max((_SMEM_WORDS - rest) & ~3, _STAGES * _STAGE) + rest
    raise ValueError(f"unknown block plan {plan!r}; one of {PLANS}")


def max_entries(n: int) -> int:
    """kMaxE of the "grid" kernels at n's column width: the entries of X
    and x one CTA may own (past n = 256 the grid route's)."""
    if n > NMAX:
        return pdhg_grid.max_entries(n)
    return _MAX_E if columns(n) == NARROW else _MAX_E_WIDE


def block_plan(n: int, m: int) -> str:
    """The launch plan of the block (both forms) and the norm at (n, m):
    "cta" where n <= CTA_MAX_N and one CTA's shared memory holds the whole
    problem (G and g staged once per launch, block barriers only), else
    "grid" (every SM, three grid barriers an iteration or power iteration;
    each CTA's slice of G resident in its shared memory where it fits, else
    streamed twice an iteration; past n = 256 the grid route's kernels)."""
    return "cta" if n <= CTA_MAX_N and 4 * _block_words("cta", n, m) <= SMEM_MAX else "grid"


def _shared_words(n: int, m: int) -> int:
    """4-byte words of one CTA's shared memory for the dense route's kernels
    that keep the rows' duals there: K7's (``_block_words`` under
    ``block_plan``) up to n = 256, the grid route's shared form without
    cuts past it (``pdhg_grid.block_words``)."""
    if n > NMAX:
        return pdhg_grid.block_words(n, 1, m, False)
    return _block_words(block_plan(n, m), n, m)


def k7_takes(n: int, m: int) -> bool:
    """Whether K7 (this file's kernels) takes (n, m): n <= 256 and m rows
    within its shared memory; elsewhere the wrappers launch the grid
    route's form without cuts."""
    return n <= NMAX and 4 * _shared_words(n, m) <= SMEM_MAX


def smem_words(n: int, m: int) -> int:
    """4-byte words of one CTA's shared memory for the dense route's kernels
    at (n, m), the block, its checked form and the norm alike: K7's
    (``_block_words`` under ``block_plan``: only the "cta" plan's grows with
    m n, the "grid" plan's is a CTA's whole shared memory up to ~22,800
    rows) where it takes the shape, else the grid route's layout without
    cuts in the form it takes (``pdhg_grid.block_words``,
    ``pdhg_grid.grid_form``)."""
    if k7_takes(n, m):
        return _shared_words(n, m)
    return pdhg_grid.block_words(n, 1, m, False, pdhg_grid.grid_form(n, 1, m, False))


def smem_bytes(n: int, m: int) -> int:
    return 4 * smem_words(n, m)


def max_dense_rows(n: int) -> int:
    """The largest m whose duals the dense route's kernels hold in shared
    memory at n (K7's up to n = 256, the grid route's shared form past it);
    more rows take the grid route's far form."""
    lo, hi = 0, 1 << 20
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if 4 * _shared_words(n, mid) <= SMEM_MAX else (lo, mid - 1)
    return lo


def dense_route_refusal(n: int, M: int, k: int, m: int) -> str | None:
    """Why the dense route does not take n, a pool of capacity M and width
    k, and m dense rows, or None where it does: the certifier's pool (M = 1,
    k = 1: no cut) and n <= 46,340, any m (past ``max_dense_rows`` the grid
    route's far form without cuts; past n = 2048 its open form)."""
    if (M, k) != (1, 1):
        return (f"the dense route takes the certifier's pool without cuts (capacity 1, "
                f"width 1), got capacity {M}, width {k}")
    if not 1 <= n <= pdhg_grid.GRID_NMAX:
        return f"the dense route takes 1 <= n <= {pdhg_grid.GRID_NMAX}, got {n}"
    return None


def dense_refusal(n: int, M: int, k: int, m: int) -> str | None:
    """Why the dense route's kernels that hold the rows' duals in shared
    memory (K7 up to n = 256, the grid route's shared form past it) do not
    take n, a pool of capacity M and width k, and m dense rows, or None
    where they do: ``dense_route_refusal``'s rule and shared memory for m
    rows."""
    why = dense_route_refusal(n, M, k, m)
    if why is None and 4 * _shared_words(n, m) > SMEM_MAX:
        return (f"the dense route: m={m} dense rows exceed {SMEM_MAX} bytes of shared memory "
                f"per CTA at n={n} (at most {max_dense_rows(n)})")
    return why


def _dense_ptrs(dense: DenseRows | None, n: int, device):
    """(m, [G, g, h] pointers) of the dense rows, checked: float32,
    contiguous (the certifier's buffer views are), on ``device``."""
    if dense is None:
        return 0, [None] * 3
    m = dense.G.shape[0]
    for name, t, want in (("G", dense.G, (m, n, n)), ("g", dense.g, (m, n)),
                          ("h", dense.h, (m,))):
        if tuple(t.shape) != want:
            raise ValueError(f"pdhg_dense kernel: dense.{name} has shape {tuple(t.shape)}, "
                             f"want {want}")
        if t.dtype != torch.float32 or t.device != device or not t.is_contiguous():
            raise ValueError(f"pdhg_dense kernel takes contiguous float32 dense rows on {device}")
    return m, [t.data_ptr() for t in (dense.G, dense.g, dense.h)]


def _rows(dense: DenseRows | None) -> int:
    return 0 if dense is None else dense.G.shape[0]


def _fields(st: PDHGState):
    """The five fields the kernels read and write (yC is left as it is)."""
    return [st.x, st.X, st.yA, st.yB, st.yD]


def _checked(cx, cX, pool: CutPool, states, dense: DenseRows | None, name: str):
    """Check a launch's arguments; returns (n, m, the dense pointers)."""
    n = cx.shape[0]
    M, k = pool.idx.shape
    dev = cx.device
    m, dptr = _dense_ptrs(dense, n, dev)
    why = dense_refusal(n, M, k, m)
    if why is None and not k7_takes(n, m):
        why = f"K7 takes n <= {NMAX}, got n={n}"
    if why is not None:
        raise ValueError(f"{name}: {why}")
    shapes = {"cx": (cx, (n,)), "cX": (cX, (n, n)),
              **{f"state.{f}": (t, s) for st in states for f, t, s in zip(
                  ("x", "X", "yA", "yB", "yD"), _fields(st), ((n,), (n, n), (n, n), (n, n), (m,)))}}
    for field, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} kernel: {field} has shape {tuple(t.shape)}, want {want}")
        if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous float32 tensors on one device")
    return n, m, dptr


def _work_words(n: int, m: int, P: int, checked: bool) -> int:
    """Floats of the grid plan's global scratch for a grid of P CTAs:
    ``csrc/pdhg_dense.cu``'s ``work_words`` (S, xb and the rows' partials;
    the checked form adds M at the average, the average's partials and each
    CTA's sums and distances; the barrier's counter last)."""
    return n * n + n + P * m + ((n * n + P * m + P * (2 * _NV + _ND)) if checked else 0) + 1


def _norm_work_words(n: int, m: int, P: int) -> int:
    """Floats of the norm's global scratch under the grid plan for a grid of
    P CTAs: ``csrc/pdhg_dense.cu``'s ``norm_work_words`` (the iterate Y and
    y, gX, the rows' partials, kD, each CTA's sums of the iterate and of the
    last step; the barrier's counter last)."""
    return 2 * n * n + n + P * m + m + 4 * P + 1


def _grid_buffers(device, plan: str, dense: DenseRows | None, n: int, m: int, words):
    """(dense, work) of a launch under ``plan``: the grid plan copies
    16-byte spans of G and g (a misaligned view is cloned) and takes its
    scratch, ``words(P)`` floats for a grid of P CTAs, and its barrier
    counter (the last word) from ``work``; the "cta" plan takes neither
    (work None)."""
    if plan != "grid":
        return dense, None
    if dense is not None and any(t.data_ptr() % 16 for t in (dense.G, dense.g)):
        dense = DenseRows(dense.G.clone(), dense.g.clone(), dense.h)
    return dense, torch.empty(words(block_grid(n, m)), dtype=torch.float32, device=device)


def _work_ptrs(work) -> list:
    """(work, barrier counter) pointers for a launch (None for the "cta" plan)."""
    return [None, None] if work is None else [work.data_ptr(), work[-1:].data_ptr()]


def _plan_of(n: int, m: int, plan: str | None) -> str:
    plan = block_plan(n, m) if plan is None else plan
    if plan == "cta" and (n > CTA_MAX_N or 4 * _block_words("cta", n, m) > SMEM_MAX):
        raise ValueError(f"pdhg_dense_block: the 'cta' plan does not take n={n}, m={m}")
    return plan


def _launch_block(cx, cX, pool: CutPool, ins, outs, rec, iters: int,
                  dense: DenseRows | None, plan: str | None = None) -> int:
    """The block's launch from the states ``ins`` into ``outs`` (which may
    be ``ins``) with the steps and stop flag of ``rec``; ``plan``: "cta" or
    "grid" (``block_plan``'s by default; the other for measurements).
    Returns the CTAs launched."""
    n, m, _ = _checked(cx, cX, pool, (*ins, *outs), dense, "pdhg_dense_block")
    plan = _plan_of(n, m, plan)
    dense, work = _grid_buffers(cx.device, plan, dense, n, m,
                                lambda P: _work_words(n, m, P, False))
    grid = ctypes.c_int(0)
    err = _build.lib().pdhg_dense_block_launch(
        n, m, iters, PLANS.index(plan), 4 * _block_words(plan, n, m), rec.data_ptr(),
        cx.data_ptr(), cX.data_ptr(), *_dense_ptrs(dense, n, cx.device)[1],
        *(t.data_ptr() for st in ins for t in _fields(st)),
        *(t.data_ptr() for st in outs for t in _fields(st)), *_work_ptrs(work),
        ctypes.byref(grid), torch.cuda.current_stream(cx.device).cuda_stream)
    if err in _ERRORS:
        raise RuntimeError(f"pdhg_dense_block_launch: {_ERRORS[err]} (plan {plan}, "
                           f"n={n}, m={m})")
    _build.check(err, "pdhg_dense_block_launch")
    pdhg_dense_block.launches += 1
    return grid.value


def block_grid(n: int, m: int) -> int:
    """The CTAs of the block's "grid" plan at (n, m) on the current card:
    those it co-schedules at the plan's shared memory
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, asked once a
    device and size)."""
    out = ctypes.c_int(0)
    err = _build.lib().pdhg_dense_block_grid(n, m, 4 * _block_words("grid", n, m),
                                              ctypes.byref(out))
    if err in _ERRORS:
        raise RuntimeError(f"pdhg_dense_block_grid: {_ERRORS[err]} (n={n}, m={m})")
    _build.check(err, "pdhg_dense_block_grid")
    return out.value


def pdhg_dense_block(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState, acc: PDHGState,
                     tau: float, sigma: float, iters: int, dense: DenseRows | None = None):
    """Run ``iters`` PDHG iterations from ``st`` with host steps tau and
    sigma and add each iterate to ``acc``; returns new (state, acc), the
    inputs left unchanged.  ``index`` is unused by the kernel (the pool
    holds no cut) and passed on to the twin."""
    if cx.device.type == "cpu":
        return pdhg_block_plain(cx, cX, pool, index, st, acc, tau, sigma, iters, dense)
    if cx.device.type == "cuda" and not k7_takes(cx.shape[0], _rows(dense)):
        return pdhg_grid.pdhg_grid_block(cx, cX, pool, index, st, acc, tau, sigma, iters, dense)
    if cx.device.type == "cuda":
        ins = [st.map(lambda t: t.contiguous()), acc.map(lambda t: t.contiguous())]
        outs = [s.map(torch.empty_like) for s in ins]
        for o, s in zip(outs, ins):
            o.yC = s.yC.clone()
        _launch_block(cx.contiguous(), cX.contiguous(), pool, ins, outs,
                      steps_record([tau], [sigma], cx.device), iters, dense)
        return outs[0], outs[1]
    raise ValueError(f"pdhg_dense_block: no kernel for device {cx.device}")


pdhg_dense_block.launches = 0


def pdhg_dense_block_steps(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState,
                           acc: PDHGState, rec, iters: int, dense: DenseRows | None = None):
    """``pdhg_dense_block`` in place on (st, acc), with the steps of the
    solve's control record ``rec`` (int32 (REC_WORDS,) on the device), and
    nothing done once its stop flag is set: the solve loop's block.  Counted
    in ``pdhg_dense_block.launches``."""
    if cx.device.type == "cpu":
        pdhg_block_steps_plain(cx, cX, pool, index, st, acc, rec, iters, dense)
    elif cx.device.type == "cuda" and not k7_takes(cx.shape[0], _rows(dense)):
        pdhg_grid.pdhg_grid_block_steps(cx, cX, pool, index, st, acc, rec, iters, dense)
    elif cx.device.type == "cuda":
        check_record(rec[None], 1, cx.device, "pdhg_dense_block")
        _launch_block(cx.contiguous(), cX.contiguous(), pool, [st, acc], [st, acc], rec, iters,
                      dense)
    else:
        raise ValueError(f"pdhg_dense_block: no kernel for device {cx.device}")


def _checked_launcher(cx, cX, pool: CutPool, st: PDHGState, acc: PDHGState,
                      anchor: PDHGState, rec, check_every: int, restart_period: int,
                      max_iters: int, tol: float, dense: DenseRows | None):
    """The launch of the checked block, its arguments checked and its
    pointers taken once: a function of no arguments that enqueues one
    launch (the grid plan's scratch allocated once, for every step)."""
    n, m, _ = _checked(cx, cX, pool, (st, acc, anchor), dense, "pdhg_dense_block_checked")
    check_record(rec[None], 1, cx.device, "pdhg_dense_block_checked")
    if check_every < 1:
        raise ValueError(f"pdhg_dense_block_checked: check_every must be >= 1, got {check_every}")
    plan = _plan_of(n, m, None)
    dense, work = _grid_buffers(cx.device, plan, dense, n, m,
                                lambda P: _work_words(n, m, P, True))
    grid = ctypes.c_int(0)
    args = (n, m, check_every, PLANS.index(plan), 4 * _block_words(plan, n, m), restart_period,
            max_iters, float(np.float32(tol)), rec.data_ptr(), cx.data_ptr(), cX.data_ptr(),
            *_dense_ptrs(dense, n, cx.device)[1],
            *(t.data_ptr() for s in (st, acc, anchor) for t in _fields(s)), *_work_ptrs(work),
            ctypes.byref(grid), torch.cuda.current_stream(cx.device).cuda_stream)
    fn = _build.lib().pdhg_dense_block_checked_launch

    def launch():
        err = fn(*args)
        if err in _ERRORS:
            raise RuntimeError(f"pdhg_dense_block_checked_launch: {_ERRORS[err]} (plan {plan}, "
                               f"n={n}, m={m})")
        _build.check(err, "pdhg_dense_block_checked_launch")
        pdhg_dense_block.launches += 1
        pdhg_dense_block_checked.launches += 1

    launch.keep = (dense, work, grid)   # alive as long as the step
    return launch


def dense_checked_step(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState, acc: PDHGState,
                       anchor: PDHGState, rec, check_every: int, restart_period: int,
                       max_iters: int, tol: float, dense: DenseRows | None = None):
    """The solve's step on the dense route over fixed buffers
    (``pdhg_check.checked_step``'s contract): a function of no arguments that
    runs one checked block of ``check_every`` iterations in place on (st,
    acc, anchor) and the record ``rec`` (REC_WORDS,).  CPU tensors take the
    twins (``pdhg_block_steps_plain`` then ``pdhg_check_plain``), CUDA
    tensors one launch a step."""
    if cx.device.type == "cpu":
        def step():
            pdhg_block_steps_plain(cx, cX, pool, index, st, acc, rec, check_every, dense)
            pdhg_check_plain(cx, cX, pool, index, st, acc, anchor, rec, check_every,
                             restart_period, max_iters, tol, dense)
        return step
    if cx.device.type != "cuda":
        raise ValueError(f"pdhg_dense_block_checked: no kernel for device {cx.device}")
    if not k7_takes(cx.shape[0], _rows(dense)):
        return pdhg_grid.grid_checked_step(cx, cX, pool, index, st, acc, anchor, rec,
                                           check_every, restart_period, max_iters, tol, dense)
    return _checked_launcher(cx.contiguous(), cX.contiguous(), pool, st, acc, anchor, rec,
                             check_every, restart_period, max_iters, tol, dense)


def pdhg_dense_block_checked(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState,
                             acc: PDHGState, anchor: PDHGState, rec, check_every: int,
                             restart_period: int, max_iters: int, tol: float,
                             dense: DenseRows | None = None):
    """One checked block of ``check_every`` iterations and its control, in
    place on (st, acc, anchor) and the solve's record ``rec``
    (``pdhg_check.pdhg_block_checked``'s contract, on the dense route).  A
    launch counts in ``pdhg_dense_block.launches`` and here."""
    dense_checked_step(cx, cX, pool, index, st, acc, anchor, rec, check_every, restart_period,
                       max_iters, tol, dense)()


pdhg_dense_block_checked.launches = 0


def pdhg_dense_norm(pool: CutPool, n: int, iters: int, generator: torch.Generator | None,
                    index: CutIndex, dense: DenseRows | None = None):
    """||K|| 1.02 + 1e-12 of a dense-route solve after ``iters`` power
    iterations from ``start_vector(n, generator, ...)`` (None: the seed-0
    draw, kept on the device; the launch only reads it), under the block's
    launch plan: a 0-d float32 tensor on the pool's device."""
    dev = pool.lin.device
    if dev.type == "cpu":
        return estimate_norm_plain(pool, n, iters, generator, index, dense)
    if dev.type != "cuda":
        raise ValueError(f"pdhg_dense_norm: no kernel for device {dev}")
    if not k7_takes(n, _rows(dense)):
        return pdhg_grid.pdhg_grid_norm(pool, n, iters, generator, index, dense)
    return _launch_norm(pool, n, iters, generator, dense)


def _launch_norm(pool: CutPool, n: int, iters: int, generator: torch.Generator | None,
                 dense: DenseRows | None):
    """The norm's launch on the pool's device, its arguments checked."""
    dev = pool.lin.device
    M, k = pool.idx.shape
    m, _ = _dense_ptrs(dense, n, dev)
    why = dense_refusal(n, M, k, m)
    if why is not None:
        raise ValueError(f"pdhg_dense_norm: {why}")
    plan = block_plan(n, m)
    dense, work = _grid_buffers(dev, plan, dense, n, m, lambda P: _norm_work_words(n, m, P))
    y, Y = (t.contiguous() for t in start_vector(n, generator, dev))
    out = torch.empty((), dtype=torch.float32, device=dev)
    grid = ctypes.c_int(0)
    err = _build.lib().pdhg_dense_norm_launch(
        n, m, iters, PLANS.index(plan), 4 * _block_words(plan, n, m),
        *_dense_ptrs(dense, n, dev)[1][:2], y.data_ptr(), Y.data_ptr(), *_work_ptrs(work),
        out.data_ptr(), ctypes.byref(grid), torch.cuda.current_stream(dev).cuda_stream)
    if err in _ERRORS:
        raise RuntimeError(f"pdhg_dense_norm_launch: {_ERRORS[err]} (plan {plan}, n={n}, m={m})")
    _build.check(err, "pdhg_dense_norm_launch")
    pdhg_dense_norm.launches += 1
    return out


pdhg_dense_norm.launches = 0
