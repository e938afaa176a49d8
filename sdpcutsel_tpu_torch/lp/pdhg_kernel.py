"""Wrapper of the PDHG iteration-block kernel (``csrc/pdhg_block.cu``), its
launch plan, and its plain PyTorch twin.

``pdhg_block`` runs ``iters`` iterations of the exact ``_one_iter`` update
(lp/pdhg.py) and adds every iterate to the ergodic sums.  It replaces the
Pallas kernel ``sdpcutsel_tpu/lp/pdhg_kernel.py::_kernel`` (launched from
``pdhg_block``).  Float32, n <= 256, cuts of width k = 2..5.  The dense
rows of a QCQP (``dense``, m > 0) run inside the kernel too; the TPU kernel
had none.

The kernel is one thread-block cluster of ``CLUSTER`` CTAs (sm_90a): CTA r
keeps rows [r R, (r + 1) R) of the state, the dense rows and the cut index
in its shared memory for the whole launch, and the bands exchange what they
need through distributed shared memory (the design is in the source).  The
kernel comes in two column widths (``columns``): 128 for n <= 128, its first
form, and 256 for 128 < n <= 256 (two row groups of 256 columns, one column
a thread); the plan carries its width and the C entry refuses a plan whose
width is not n's.  ``launch_plan`` gives the cluster size, the width, the
band height, the shared bytes per CTA and the largest pool capacity M and
dense row count m the plan takes at a shape; it raises where the shape does
not fit (``plan_refusal`` says why).
``kernel_route`` chooses a solve's route by ``LPConfig.use_kernel`` and that
same rule: K2 for a pool of cuts it takes, the grid route
(``lp/pdhg_grid.py``) for the pools of cuts it does not (n > 256, any pool
or number of dense rows past its shared memory), the dense route
(``lp/pdhg_dense.py``) for the certifier's pool without cuts.  On CUDA a
kernel route runs unless the caller asks for the plain loop ("off"): a
shape that none takes (n past the open form's 32-bit bound ``OPEN_NMAX``,
or cuts of a width outside 2..5) raises with the rules' reasons.  The plain blocks a solve runs on CUDA are counted in
``pdhg_block.plain_launches``.

The cut adjoint (scatter of yC-weighted coefficients into gx, gX) is
deterministic in the kernel: ``build_cut_index`` (relax/cutbuffer.py) sorts,
once per solve, every (cut, a, b) term by its destination entry of x or X (a
stable sort, so terms keep the reference's (t, a, b) order), and each
destination sums its segment in that fixed order.  No atomics, so repeated
runs give identical bits.

Instance axis: ``pdhg_block_batched`` runs one block for the instances
``ids`` of a batch of one shape (every array stacked along a leading axis,
the cut index from ``relax/batched.py::build_cut_index``) in one launch: a
grid of one cluster per listed instance, each with its own tau and sigma.
The instances left out come back unchanged, bit for bit.  ``pdhg_block`` is
the batch of one of the same entry point.  ``max_active_clusters`` asks the
card how many clusters of a plan run at once.

Steps: the kernel reads each instance's tau, sigma and stop flag from a
control record in device memory (``lp/pdhg.py::new_record``).  The solve's
loop calls ``pdhg_block_steps`` / ``pdhg_block_steps_batched``: in place,
every instance, with the steps K5 (``pdhg_check``) wrote after the last
block, so nothing is read to the host between blocks; an instance whose
record has stopped leaves at entry and stays frozen, bit for bit.
``pdhg_block`` and ``pdhg_block_batched`` keep taking host floats (steering,
the twins' checks): their steps go into records of their own.

Device rule: CPU tensors take the twin; CUDA tensors launch the kernel; any
other device raises.  ``pdhg_block.launches`` counts kernel launches, one a
call of either wrapper.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import _build
from ..relax.batched import batch_of_one, instance
from ..relax.cutbuffer import CutIndex, CutPool
from ..relax.denserows import DenseRows
from .pdhg import REC_SIGMA, REC_STOP, REC_TAU, REC_WORDS, PDHGState, _one_iter, record_floats

NARROW = 128                # csrc/pdhg_common.cuh kNarrow: the width for n <= 128
NMAX = 256                  # kWide: one thread column per matrix column up to n = 256
WIDEST = 512                # kWidest: the grid route's width for 256 < n <= 512
HUGE = 1024                 # kHuge: and for 512 < n <= 1024, its owned state in global memory
VAST = 2048                 # kVast: and for 1024 < n <= 2048, its dense rows read in place
OPEN = 65536                # kOpen: the open form's tag, 2048 < n <= OPEN_NMAX
OPEN_NMAX = 46340           # kOpenMax: the largest n with n n + n < 2^31 (X's entry index)
CLUSTER = 16                # CTAs in the cluster (non-portable size; 8 is portable)
SMEM_MAX = 232_448          # dynamic shared memory one CTA may take on the H100
_THREADS = 512              # csrc/pdhg_common.cuh kThreads
_NV, _ND = 8, 6             # csrc/pdhg_check.cuh kNV, pdhg_common.cuh kND
_ERRORS = {-2: "the launch plan disagrees with the kernel's shared-memory layout",
           -3: "no thread-block cluster of this shape fits on the card"}


def columns(n: int) -> int:
    """The kernels' column width at n (``csrc/pdhg_common.cuh`` cols_for):
    128 for n <= 128, 256 up to n = 256, 512 up to n = 512, 1024 up to
    n = 1024, 2048 up to n = 2048 and ``OPEN`` above, the open form's tag
    (the last four the grid route's alone, ``lp/pdhg_grid.py``).  In K2 a
    thread owns one column, so a CTA's 512 threads are 512 / width row
    groups of width / 32 warps a row."""
    if n <= NMAX:
        return NARROW if n <= NARROW else NMAX
    if n <= WIDEST:
        return WIDEST
    if n <= HUGE:
        return HUGE
    return VAST if n <= VAST else OPEN


def _check_words(C: int) -> int:
    """4-byte words of the checked form's sums (K5's control after the
    block; it evaluates its two points in turn on K2's buffers): the sum of
    ``csrc/pdhg_check.cuh::check_layout``.  They sit in the Xb band, dead
    after the loop, where it holds them (R n words)."""
    return (C * 2 * _NV + C * _ND        # every rank's sums and distances
            + (_THREADS // 32) * 2 * _NV  # block sums
            + 2 * _NV + _ND + 8)         # this CTA's sums and the decision


def _smem_words(n: int, M: int, k: int, m: int, C: int, checked: bool = False) -> int:
    """4-byte words of one CTA's shared memory, cut-index terms left out:
    the sum of ``csrc/pdhg_block.cu::make_layout`` at n's column width, with
    the check's region in the checked form."""
    R, Mc = -(-n // C), -(-M // C)
    RN, cols = R * n, columns(n)
    return (10 * RN                      # X yA yB cX aX aA aB S Xb ST bands
            + 2 * R * (cols // 32)       # row partials of yA, yB
            + C * (_THREADS // cols) * R  # column partials of yB, each row group's
            + 3 * R + cols               # x, ax, cx bands; xb replica
            + M                          # w replica
            + Mc * (4 + 2 * k + k * k)   # owned slots: yC ayC rhs act, lin idx, quad
            + m * RN + m * R + 3 * m     # dense G, g bands; h, yD, ayD
            + C * m                      # dense partials
            + RN + 1 + R + 1             # cut-index segment offsets
            + (_check_words(C) if checked and R * n < _check_words(C) else 0))


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    cluster: int        # CTAs in the cluster
    cols: int           # the column width (``columns``): 128 for n <= 128, else 256
    rows: int           # R: rows of X per CTA (the last CTAs may hold fewer or none)
    slots: int          # pool slots per CTA
    term_cap: int       # cut-index terms a CTA keeps in shared memory
    smem_bytes: int     # dynamic shared memory per CTA
    max_capacity: int   # largest pool capacity M the route takes at (n, k, m)
    max_dense: int      # largest dense row count m the route takes at (n, M, k)
    checked: bool       # the checked form: K5's control after the block

    def bands(self, n: int) -> list[tuple[int, int]]:
        """Rows [start, stop) of each CTA, in rank order."""
        return [(min(r * self.rows, n), min((r + 1) * self.rows, n))
                for r in range(self.cluster)]


def _largest(fits, hi: int) -> int:
    """The largest v in [0, hi] with fits(v), fits being monotone."""
    lo = 0
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo


def plan_refusal(n: int, M: int, k: int, m: int, cluster: int = CLUSTER) -> str | None:
    """Why the cluster launch does not take n, pool capacity M, support
    width k and m dense rows, or None where it does: the one rule of
    ``launch_plan`` and of the solve's route (``kernel_route``).  The rule
    is the checked form's (the solve's step), whose shared memory holds the
    unchecked form's and K5's region."""
    if not 1 <= n <= NMAX:
        return f"pdhg_block kernel takes 1 <= n <= {NMAX}, got {n}"
    if not 2 <= k <= 5:
        return f"pdhg_block kernel takes cuts of width k = 2..5, got {k}"
    if not 1 <= cluster <= 16:
        return f"pdhg_block kernel takes clusters of 1..16 CTAs, got {cluster}"
    if 4 * _smem_words(n, M, k, m, cluster, checked=True) > SMEM_MAX:
        return (f"pdhg_block kernel: n={n}, M={M}, k={k}, m={m} exceed {SMEM_MAX} bytes "
                f"of shared memory per CTA at a cluster of {cluster}")
    return None


def route_refusal(n: int, M: int, k: int, m: int) -> tuple[str, str | None]:
    """The kernel route whose rule decides a shape, and why it does not
    take it (None where it does): the dense route (``lp/pdhg_dense.py``) for
    the certifier's pool without cuts, any m; for every other pool K2 with
    K5 and K6 wherever its cluster takes the shape (``plan_refusal``), else
    the grid route (``lp/pdhg_grid.py``, ``grid_refusal``: any pool and any
    m), and where neither takes it both reasons.  The one limit left is
    1 <= n <= OPEN_NMAX = 46,340, where an index of X's entries stays within
    32 bits (with cuts of width k = 2..5); memory is torch's to refuse, at
    allocation.  A pool of width 1 is a
    pool without cuts: a cut has k = 2..5 entries, so no cut fits it, and
    the certifier's sentinel ``empty_pool(1, 1)`` is the one such pool.  The
    dense kernels leave its yC as it is, where the twins apply the pool's
    inactive row."""
    if (M, k) == (1, 1):
        from .pdhg_dense import dense_route_refusal

        return "dense", dense_route_refusal(n, M, k, m)
    why = plan_refusal(n, M, k, m)
    if why is None:
        return "k2", None
    from .pdhg_grid import grid_refusal

    why_grid = grid_refusal(n, M, k, m)
    return "grid", None if why_grid is None else f"{why}; {why_grid}"


def kernel_route(use_kernel: str, device, n: int, M: int, k: int, m: int) -> str:
    """The route of a solve's blocks, check and norm, by
    ``LPConfig.use_kernel``: "k2" (K2, K5, K6), "grid" (the grid route's
    kernels of ``csrc/pdhg_grid.cu``, for the pools of cuts K2's cluster
    does not hold), "dense" (the dense-row kernels of ``csrc/pdhg_dense.cu``,
    and of ``csrc/pdhg_grid.cu`` past n = 256) or "plain" (the plain
    ``_one_iter`` loop and the twins on the tensors' device).  "off" plain;
    "on" the kernel route of the shape (``route_refusal``), raising where it
    does not take the shape; "auto" the same on CUDA, and plain on any other
    device.  A kernel route on the CPU runs its wrappers' twins.  The
    reference's "auto" runs its plain loop on the accelerator outside its
    kernel's shapes (n > 128, ``sdpcutsel_tpu/lp/pdhg.py::solve_lp``); here
    the kernels take n <= 46,340 (``OPEN_NMAX``), and the plain loop runs
    on the card only when the caller asks for it with "off"."""
    if use_kernel == "off":
        return "plain"
    route, why = route_refusal(n, M, k, m)
    if use_kernel == "on":
        if why is not None:
            raise ValueError(f"LPConfig.use_kernel='on': {why}")
        return route
    if use_kernel == "auto":
        if torch.device(device).type != "cuda":
            return "plain"
        if why is not None:
            raise ValueError(f"LPConfig.use_kernel='auto' on CUDA: {why}; "
                             f"use_kernel='off' runs the plain loop on the card")
        return route
    raise ValueError(f"LPConfig.use_kernel must be 'auto', 'on' or 'off', got {use_kernel!r}")


def launch_plan(n: int, M: int, k: int, m: int, cluster: int = CLUSTER,
                checked: bool = False) -> LaunchPlan:
    """The cluster launch of the kernel at n, pool capacity M, support width
    k and m dense rows, unchecked (steering's block and the twins') or
    checked (the solve's step, ``pdhg_check.pdhg_block_checked``).  Raises
    ValueError where the route does not take the shape."""
    why = plan_refusal(n, M, k, m, cluster)
    if why is not None:
        raise ValueError(why)

    def fits(M_, m_):
        return plan_refusal(n, M_, k, m_, cluster) is None

    words = _smem_words(n, M, k, m, cluster, checked)
    term_cap = min((SMEM_MAX - 4 * words) // 8, M * k * (k + 1))
    return LaunchPlan(cluster=cluster, cols=columns(n), rows=-(-n // cluster),
                      slots=-(-M // cluster),
                      term_cap=term_cap, smem_bytes=4 * words + 8 * term_cap,
                      max_capacity=_largest(lambda v: fits(v, m), 1 << 16),
                      max_dense=_largest(lambda v: fits(M, v), 1 << 12), checked=checked)


def pdhg_block_plain(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState,
                     acc: PDHGState, tau: float, sigma: float, iters: int,
                     dense: DenseRows | None = None):
    """Twin: ``_one_iter`` x iters, summing every iterate into ``acc``."""
    n = cx.shape[0]
    for _ in range(iters):
        st = _one_iter(cx, cX, pool, index, n, st, tau, sigma, dense)
        acc = acc.add(st)
    return st, acc


def pdhg_block_batched_plain(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState,
                             acc: PDHGState, tau, sigma, iters: int, ids,
                             dense: DenseRows | None = None):
    """Twin of the batched launch: ``pdhg_block_plain`` on instance b of
    every batched argument (``relax/batched.py::instance``), with steps
    tau[b], sigma[b], for each b in ``ids``; the other instances come back
    as they were."""
    outs = [list(s.unbind(0)) for s in (*st.fields(), *acc.fields())]
    for b in (int(v) for v in ids):
        sb, ab = pdhg_block_plain(cx[b], cX[b], instance(pool, b), instance(index, b),
                                  instance(st, b), instance(acc, b), float(tau[b]),
                                  float(sigma[b]), iters,
                                  None if dense is None else instance(dense, b))
        for out, t in zip(outs, (*sb.fields(), *ab.fields())):
            out[b] = t
    outs = [torch.stack(o) for o in outs]
    return PDHGState(*outs[:6]), PDHGState(*outs[6:])


def _checked_args(cx, cX, pool: CutPool, index: CutIndex, states, dense: DenseRows | None,
                  name: str):
    """Check a batched launch's arguments (every argument with the instance
    axis first; ``states``: the PDHGStates it reads or writes).  Returns
    (B, n, M, k, m, ex, eX)."""
    B, n = cx.shape
    M, k = pool.idx.shape[1:]
    m = 0 if dense is None else dense.G.shape[1]
    shapes = {"cX": (cX, (B, n, n)), "pool.lin": (pool.lin, (B, M, k)),
              "pool.quad": (pool.quad, (B, M, k, k)), "pool.rhs": (pool.rhs, (B, M)),
              "pool.active": (pool.active, (B, M)), "index.idx": (index.idx, (B, M, k)),
              "index.xoff": (index.xoff, (B, n + 1)), "index.Xoff": (index.Xoff, (B, n * n + 1)),
              **{f"state.{f}": (t, s) for st_ in states for f, t, s in zip(
                  ("x", "X", "yA", "yB", "yC", "yD"), st_.fields(),
                  ((B, n), (B, n, n), (B, n, n), (B, n, n), (B, M), (B, m)))}}
    if dense is not None:
        shapes.update({"dense.G": (dense.G, (B, m, n, n)), "dense.g": (dense.g, (B, m, n)),
                       "dense.h": (dense.h, (B, m))})
    for field, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} kernel: {field} has shape {tuple(t.shape)}, want {want}")
    ex, eX = index.xcut.shape[-1], index.Xcut.shape[-1]
    if index.xcut.shape != (B, ex) or index.Xcut.shape != (B, eX):
        raise ValueError(f"{name} kernel: the cut index's terms must be (B, E) arrays")
    floats = [cx, cX, pool.lin, pool.quad, pool.rhs, pool.active,
              index.xcoef, index.Xcoef, *(t for st_ in states for t in st_.fields())]
    if dense is not None:
        floats += [dense.G, dense.g, dense.h]
    for t in floats:
        if t.dtype != torch.float32 or t.device != cx.device:
            raise ValueError(f"{name} kernel takes float32 tensors on one device")
    for t in (index.idx, index.xoff, index.xcut, index.Xoff, index.Xcut):
        if t.dtype != torch.int32 or t.device != cx.device:
            raise ValueError(f"{name} kernel takes an int32 cut index on one device")
    return B, n, M, k, m, ex, eX


def check_record(rec, B: int, device, name: str):
    """A batch's control records: int32 (B, REC_WORDS), contiguous, on ``device``."""
    if (rec.dtype != torch.int32 or tuple(rec.shape) != (B, REC_WORDS)
            or rec.device != device or not rec.is_contiguous()):
        raise ValueError(f"{name} kernel takes int32 records of shape ({B}, {REC_WORDS}) on "
                         f"{device}, got {rec.dtype} {tuple(rec.shape)} on {rec.device}")


def _launch_core(cx, cX, pool: CutPool, index: CutIndex, ins: list, outs: list, rec,
                 iters: int, ids: np.ndarray, dense: DenseRows | None, cluster: int):
    """The C launch of K2 for the instances ``ids`` with the steps and stop
    flags of ``rec``; ``ins``/``outs``: the 12 state and sum tensors."""
    B, n = cx.shape
    M, k = pool.idx.shape[1:]
    m = 0 if dense is None else dense.G.shape[1]
    plan = launch_plan(n, M, k, m, cluster)
    ex, eX = index.xcut.shape[-1], index.Xcut.shape[-1]
    c = [t.contiguous() for t in (cx, cX, index.idx, pool.lin, pool.quad, pool.rhs,
                                  pool.active, index.xoff, index.xcut, index.xcoef,
                                  index.Xoff, index.Xcut, index.Xcoef)]
    d = [] if dense is None else [t.contiguous() for t in (dense.G, dense.g, dense.h)]
    dptr = [t.data_ptr() for t in d] or [None] * 3
    count = int(ids.size)
    err = _build.lib().pdhg_block_launch(
        n, M, k, m, iters, plan.cluster, plan.cols, plan.term_cap, plan.smem_bytes, count,
        (ctypes.c_int * count)(*ids.tolist()), rec.data_ptr(), ex, eX,
        *(t.data_ptr() for t in c), *dptr,
        *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
        torch.cuda.current_stream(cx.device).cuda_stream,
    )
    if err in _ERRORS:
        raise RuntimeError(f"pdhg_block_launch: {_ERRORS[err]} (cluster {plan.cluster}, "
                           f"width {plan.cols}, {plan.smem_bytes} bytes per CTA)")
    _build.check(err, "pdhg_block_launch")
    pdhg_block.launches += 1


def steps_record(tau, sigma, device):
    """Control records that hold only host steps tau[b], sigma[b] (B,), for
    a launch with steps from the host: int32 (B, REC_WORDS) on ``device``,
    one upload (steering and the twins; the solve's blocks use its record)."""
    tau = np.asarray(tau, dtype=np.float32).reshape(-1)
    sigma = np.asarray(sigma, dtype=np.float32).reshape(-1)
    r = np.zeros((tau.size, REC_WORDS), np.int32)
    f = r.view(np.float32)
    f[:, REC_TAU], f[:, REC_SIGMA] = tau, sigma
    return torch.from_numpy(r).to(device)


def _launch_batched(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState,
                    acc: PDHGState, tau, sigma, iters: int, ids,
                    dense: DenseRows | None, cluster: int = CLUSTER):
    """One launch for the instances ``ids`` of a batch: every argument
    carries the instance axis first (``relax/batched.py``), ``index`` is
    ``relax.batched.build_cut_index(pool, n)``, tau and sigma are (B,) host
    steps, uploaded as control records."""
    B = _checked_args(cx, cX, pool, index, (st, acc), dense, "pdhg_block")[0]
    ids = np.asarray(ids, dtype=np.int64).reshape(-1)
    if ids.size and (ids.min() < 0 or ids.max() >= B or (np.diff(ids) <= 0).any()):
        raise ValueError(f"pdhg_block kernel: ids must be increasing instances of 0..{B - 1}")
    ins = [t.contiguous() for t in (*st.fields(), *acc.fields())]
    if ids.size == B:
        outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in ins]
    else:
        # the instances left out keep their inputs: copy all of them in one
        # launch, then update the listed ones in place
        flat = torch.cat([t.reshape(-1) for t in ins])
        outs = [v.view(t.shape) for v, t in zip(flat.split([t.numel() for t in ins]), ins)]
        ins = outs
    _launch_core(cx, cX, pool, index, ins, outs, steps_record(tau, sigma, cx.device), iters,
                 ids, dense, cluster)
    return PDHGState(*outs[:6]), PDHGState(*outs[6:])


def _launch_steps(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState, acc: PDHGState,
                  rec, iters: int, dense: DenseRows | None, cluster: int = CLUSTER):
    """One in-place launch for every instance of a batch, each with the
    steps of its control record; an instance whose record has stopped is
    left as it is."""
    B = _checked_args(cx, cX, pool, index, (st, acc), dense, "pdhg_block")[0]
    check_record(rec, B, cx.device, "pdhg_block")
    bufs = [*st.fields(), *acc.fields()]
    if not all(t.is_contiguous() for t in bufs):
        raise ValueError("pdhg_block kernel: an in-place launch takes contiguous state and sums")
    _launch_core(cx, cX, pool, index, bufs, bufs, rec, iters, np.arange(B), dense, cluster)


def _launch(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState,
            acc: PDHGState, tau: float, sigma: float, iters: int,
            dense: DenseRows | None, cluster: int = CLUSTER):
    """One instance: the batched launch of a batch of one."""
    st1, acc1 = _launch_batched(cx[None], cX[None], batch_of_one(pool), batch_of_one(index),
                                batch_of_one(st), batch_of_one(acc), [tau], [sigma], iters,
                                [0], None if dense is None else batch_of_one(dense), cluster)
    return instance(st1, 0), instance(acc1, 0)


def max_active_clusters(n: int, M: int, k: int, m: int, instances: int,
                        cluster: int = CLUSTER) -> int:
    """How many clusters of the launch plan at (n, M, k, m) the card runs at
    once, for a grid of ``instances`` clusters (cudaOccupancyMaxActiveClusters)."""
    plan = launch_plan(n, M, k, m, cluster)
    out = ctypes.c_int(0)
    err = _build.lib().pdhg_block_max_active_clusters(
        n, M, k, m, plan.cluster, plan.cols, plan.term_cap, plan.smem_bytes, instances,
        ctypes.byref(out))
    if err in _ERRORS:
        raise RuntimeError(f"pdhg_block_max_active_clusters: {_ERRORS[err]}")
    _build.check(err, "pdhg_block_max_active_clusters")
    return out.value


def pdhg_block(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState,
               acc: PDHGState, tau: float, sigma: float, iters: int,
               dense: DenseRows | None = None):
    """Run ``iters`` PDHG iterations from ``st`` and add each iterate to
    ``acc``.  Returns new (state, acc); the inputs are left unchanged.
    ``index`` comes from ``build_cut_index(pool, n)``; ``dense`` holds the
    QCQP's constraint rows, whose duals are ``st.yD``."""
    if cx.device.type == "cpu":
        return pdhg_block_plain(cx, cX, pool, index, st, acc, tau, sigma, iters,
                                dense)
    if cx.device.type == "cuda":
        return _launch(cx, cX, pool, index, st, acc, tau, sigma, iters, dense)
    raise ValueError(f"pdhg_block: no kernel for device {cx.device}")


pdhg_block.launches = 0
pdhg_block.plain_launches = 0      # plain blocks a solve ran on CUDA (kernel_route)


def pdhg_block_batched(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState,
                       acc: PDHGState, tau, sigma, iters: int, ids,
                       dense: DenseRows | None = None):
    """``pdhg_block`` for the instances ``ids`` (increasing) of a batch, in
    one launch on CUDA: every argument carries the instance axis first,
    ``index`` is ``relax.batched.build_cut_index(pool, n)``, tau and sigma
    are (B,) per-instance steps.  Returns new batched (state, acc); the
    instances not in ``ids`` are returned unchanged, bit for bit, and the
    inputs are left as they were.  Counted in ``pdhg_block.launches``."""
    if cx.device.type == "cpu":
        return pdhg_block_batched_plain(cx, cX, pool, index, st, acc, tau, sigma, iters,
                                        ids, dense)
    if cx.device.type == "cuda":
        return _launch_batched(cx, cX, pool, index, st, acc, tau, sigma, iters, ids, dense)
    raise ValueError(f"pdhg_block: no kernel for device {cx.device}")


def pdhg_block_steps_plain(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState,
                           acc: PDHGState, rec, iters: int, dense: DenseRows | None = None) -> bool:
    """Twin of ``pdhg_block_steps``: the record read to the host, then
    ``pdhg_block_plain`` with its steps, in place, unless it has stopped.
    Returns whether a block ran."""
    r = rec.cpu().numpy()
    if r[REC_STOP]:
        return False
    f = record_floats(r)
    new = pdhg_block_plain(cx, cX, pool, index, st, acc, float(f[REC_TAU]), float(f[REC_SIGMA]),
                           iters, dense)
    for a, b in zip((*st.fields(), *acc.fields()), (*new[0].fields(), *new[1].fields())):
        a.copy_(b)
    return True


def pdhg_block_steps_batched_plain(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState,
                                   acc: PDHGState, rec, iters: int,
                                   dense: DenseRows | None = None) -> bool:
    """Twin of ``pdhg_block_steps_batched``: ``pdhg_block_batched_plain``
    for the instances whose records have not stopped, in place.  Returns
    whether any block ran."""
    r = rec.cpu().numpy()
    ids = np.flatnonzero(r[:, REC_STOP] == 0)
    if not ids.size:
        return False
    f = record_floats(r)
    new = pdhg_block_batched_plain(cx, cX, pool, index, st, acc, f[:, REC_TAU], f[:, REC_SIGMA],
                                   iters, ids, dense)
    for a, b in zip((*st.fields(), *acc.fields()), (*new[0].fields(), *new[1].fields())):
        a.copy_(b)
    return True


def pdhg_block_steps(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState, acc: PDHGState,
                     rec, iters: int, dense: DenseRows | None = None):
    """``pdhg_block`` in place on (st, acc), with the steps tau and sigma of
    the solve's control record ``rec`` (REC_WORDS,) on the device, and
    nothing done when its stop flag is set: the solve loop's block
    (lp/pdhg.py), which reads nothing to the host.  Counted in
    ``pdhg_block.launches``."""
    if cx.device.type == "cpu":
        pdhg_block_steps_plain(cx, cX, pool, index, st, acc, rec, iters, dense)
    elif cx.device.type == "cuda":
        _launch_steps(cx[None], cX[None], batch_of_one(pool), batch_of_one(index),
                      batch_of_one(st), batch_of_one(acc), rec[None], iters,
                      None if dense is None else batch_of_one(dense))
    else:
        raise ValueError(f"pdhg_block: no kernel for device {cx.device}")


def pdhg_block_steps_batched(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState,
                             acc: PDHGState, rec, iters: int, dense: DenseRows | None = None):
    """``pdhg_block_steps`` of every instance of a batch in one launch:
    records (B, REC_WORDS); an instance whose record has stopped is left as
    it is, bit for bit.  Counted in ``pdhg_block.launches``."""
    if cx.device.type == "cpu":
        pdhg_block_steps_batched_plain(cx, cX, pool, index, st, acc, rec, iters, dense)
    elif cx.device.type == "cuda":
        _launch_steps(cx, cX, pool, index, st, acc, rec, iters, dense)
    else:
        raise ValueError(f"pdhg_block: no kernel for device {cx.device}")
