"""Wrapper of the PDHG iteration-block kernel (``csrc/pdhg_block.cu``), its
launch plan, and its plain PyTorch twin.

``pdhg_block`` runs ``iters`` iterations of the exact ``_one_iter`` update
(lp/pdhg.py) and adds every iterate to the ergodic sums.  It replaces the
Pallas kernel ``sdpcutsel_tpu/lp/pdhg_kernel.py::_kernel`` (launched from
``pdhg_block``).  Float32, n <= 128, cuts of width k = 2..5.  The dense
rows of a QCQP (``dense``, m > 0) run inside the kernel too; the TPU kernel
had none.

The kernel is one thread-block cluster of ``CLUSTER`` CTAs (sm_90a): CTA r
keeps rows [r R, (r + 1) R) of the state, the dense rows and the cut index
in its shared memory for the whole launch, and the bands exchange what they
need through distributed shared memory (the design is in the source).
``launch_plan`` gives the cluster size, the band height, the shared bytes per
CTA and the largest pool capacity M and dense row count m the plan takes at
a shape; it raises where the shape does not fit (``plan_refusal`` says why).
``kernel_route`` chooses a solve's blocks by ``LPConfig.use_kernel`` and that
same rule.  On CUDA, K2 is the only route unless the caller asks for the
plain loop ("off"): a shape outside the plan (n > 128, a pool too large for
shared memory) raises with the plan's reason.  The plain blocks a solve runs
on CUDA are counted in ``pdhg_block.plain_launches``.

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
The instances left out come back unchanged, bit for bit: that is how a
batched solve freezes a converged instance.  ``pdhg_block`` is the batch of
one of the same entry point.  ``max_active_clusters`` asks the card how many
clusters of a plan run at once.

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
from .pdhg import PDHGState, _one_iter

NMAX = 128                  # one thread column per matrix column
CLUSTER = 16                # CTAs in the cluster (non-portable size; 8 is portable)
SMEM_MAX = 232_448          # dynamic shared memory one CTA may take on the H100
_GROUPS = 4                 # row groups of a CTA's 512 threads (csrc kGroups)
_WARPS_PER_ROW = NMAX // 32
_ERRORS = {-2: "the launch plan disagrees with the kernel's shared-memory layout",
           -3: "no thread-block cluster of this shape fits on the card"}


def _smem_words(n: int, M: int, k: int, m: int, C: int) -> int:
    """4-byte words of one CTA's shared memory, cut-index terms left out:
    the sum of ``csrc/pdhg_block.cu::make_layout``."""
    R, Mc = -(-n // C), -(-M // C)
    RN = R * n
    return (10 * RN                      # X yA yB cX aX aA aB S Xb ST bands
            + 2 * R * _WARPS_PER_ROW     # row partials of yA, yB
            + C * _GROUPS * R            # column partials of yB
            + 3 * R + NMAX               # x, ax, cx bands; xb replica
            + M                          # w replica
            + Mc * (4 + 2 * k + k * k)   # owned slots: yC ayC rhs act, lin idx, quad
            + m * RN + m * R + 3 * m     # dense G, g bands; h, yD, ayD
            + C * m                      # dense partials
            + RN + 1 + R + 1)            # cut-index segment offsets


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    cluster: int        # CTAs in the cluster
    rows: int           # R: rows of X per CTA (the last CTAs may hold fewer or none)
    slots: int          # pool slots per CTA
    term_cap: int       # cut-index terms a CTA keeps in shared memory
    smem_bytes: int     # dynamic shared memory per CTA
    max_capacity: int   # largest pool capacity M this plan takes at (n, k, m)
    max_dense: int      # largest dense row count m this plan takes at (n, M, k)

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
    ``launch_plan`` and of the solve's route (``kernel_route``)."""
    if not 1 <= n <= NMAX:
        return f"pdhg_block kernel takes 1 <= n <= {NMAX}, got {n}"
    if not 2 <= k <= 5:
        return f"pdhg_block kernel takes cuts of width k = 2..5, got {k}"
    if not 1 <= cluster <= 16:
        return f"pdhg_block kernel takes clusters of 1..16 CTAs, got {cluster}"
    if 4 * _smem_words(n, M, k, m, cluster) > SMEM_MAX:
        return (f"pdhg_block kernel: n={n}, M={M}, k={k}, m={m} exceed {SMEM_MAX} bytes "
                f"of shared memory per CTA at a cluster of {cluster}")
    return None


def kernel_route(use_kernel: str, device, n: int, M: int, k: int, m: int) -> bool:
    """Whether a solve runs its blocks through ``pdhg_block`` (K2 on CUDA,
    the twin on the CPU) rather than the plain ``_one_iter`` loop on the
    tensors' own device, by ``LPConfig.use_kernel``: "off" plain; "on" the
    kernel, raising where the launch plan does not take the shape; "auto"
    the kernel on CUDA, raising there too where the plan does not take the
    shape, and plain on any other device.  The reference's "auto" runs its
    plain loop on the accelerator outside its kernel's shapes
    (``sdpcutsel_tpu/lp/pdhg.py::solve_lp``); here the plain loop runs on
    the card only when the caller asks for it with "off"."""
    if use_kernel == "off":
        return False
    why = plan_refusal(n, M, k, m)
    if use_kernel == "on":
        if why is not None:
            raise ValueError(f"LPConfig.use_kernel='on': {why}")
        return True
    if use_kernel == "auto":
        if torch.device(device).type != "cuda":
            return False
        if why is not None:
            raise ValueError(f"LPConfig.use_kernel='auto' on CUDA: {why}; "
                             f"use_kernel='off' runs the plain loop on the card")
        return True
    raise ValueError(f"LPConfig.use_kernel must be 'auto', 'on' or 'off', got {use_kernel!r}")


def launch_plan(n: int, M: int, k: int, m: int, cluster: int = CLUSTER) -> LaunchPlan:
    """The cluster launch of the kernel at n, pool capacity M, support width
    k and m dense rows.  Raises ValueError where it does not fit."""
    why = plan_refusal(n, M, k, m, cluster)
    if why is not None:
        raise ValueError(why)

    def fits(M_, m_):
        return plan_refusal(n, M_, k, m_, cluster) is None

    words = _smem_words(n, M, k, m, cluster)
    term_cap = min((SMEM_MAX - 4 * words) // 8, M * k * (k + 1))
    return LaunchPlan(cluster=cluster, rows=-(-n // cluster), slots=-(-M // cluster),
                      term_cap=term_cap, smem_bytes=4 * words + 8 * term_cap,
                      max_capacity=_largest(lambda v: fits(v, m), 1 << 16),
                      max_dense=_largest(lambda v: fits(M, v), 1 << 12))


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


def _launch_batched(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState,
                    acc: PDHGState, tau, sigma, iters: int, ids,
                    dense: DenseRows | None, cluster: int = CLUSTER):
    """One launch for the instances ``ids`` of a batch: every argument
    carries the instance axis first (``relax/batched.py``), ``index`` is
    ``relax.batched.build_cut_index(pool, n)``, tau and sigma are (B,)."""
    B, n = cx.shape
    M, k = pool.idx.shape[1:]
    m = 0 if dense is None else dense.G.shape[1]
    plan = launch_plan(n, M, k, m, cluster)
    ids = np.asarray(ids, dtype=np.int64).reshape(-1)
    if ids.size and (ids.min() < 0 or ids.max() >= B or (np.diff(ids) <= 0).any()):
        raise ValueError(f"pdhg_block kernel: ids must be increasing instances of 0..{B - 1}")
    shapes = {"cX": (cX, (B, n, n)), "pool.lin": (pool.lin, (B, M, k)),
              "pool.quad": (pool.quad, (B, M, k, k)), "pool.rhs": (pool.rhs, (B, M)),
              "pool.active": (pool.active, (B, M)), "index.idx": (index.idx, (B, M, k)),
              "index.xoff": (index.xoff, (B, n + 1)), "index.Xoff": (index.Xoff, (B, n * n + 1)),
              **{f"state.{f}": (t, s) for st_ in (st, acc) for f, t, s in zip(
                  ("x", "X", "yA", "yB", "yC", "yD"), st_.fields(),
                  ((B, n), (B, n, n), (B, n, n), (B, n, n), (B, M), (B, m)))}}
    if dense is not None:
        shapes.update({"dense.G": (dense.G, (B, m, n, n)), "dense.g": (dense.g, (B, m, n)),
                       "dense.h": (dense.h, (B, m))})
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"pdhg_block kernel: {name} has shape {tuple(t.shape)}, "
                             f"want {want}")
    ex, eX = index.xcut.shape[-1], index.Xcut.shape[-1]
    if index.xcut.shape != (B, ex) or index.Xcut.shape != (B, eX):
        raise ValueError("pdhg_block kernel: the cut index's terms must be (B, E) arrays")
    floats = [cx, cX, pool.lin, pool.quad, pool.rhs, pool.active,
              index.xcoef, index.Xcoef, *st.fields(), *acc.fields()]
    if dense is not None:
        floats += [dense.G, dense.g, dense.h]
    for t in floats:
        if t.dtype != torch.float32 or t.device != cx.device:
            raise ValueError("pdhg_block kernel takes float32 tensors on one device")
    ints = [index.idx, index.xoff, index.xcut, index.Xoff, index.Xcut]
    for t in ints:
        if t.dtype != torch.int32 or t.device != cx.device:
            raise ValueError("pdhg_block kernel takes an int32 cut index on one device")
    lib = _build.lib()
    ins = [t.contiguous() for t in (*st.fields(), *acc.fields())]
    if ids.size == B:
        outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in ins]
    else:
        # the instances left out keep their inputs: copy all of them in one
        # launch, then update the listed ones in place
        flat = torch.cat([t.reshape(-1) for t in ins])
        outs = [v.view(t.shape) for v, t in zip(flat.split([t.numel() for t in ins]), ins)]
        ins = outs
    c = [t.contiguous() for t in (cx, cX, index.idx, pool.lin, pool.quad, pool.rhs,
                                  pool.active, index.xoff, index.xcut, index.xcoef,
                                  index.Xoff, index.Xcut, index.Xcoef)]
    d = [] if dense is None else [t.contiguous() for t in (dense.G, dense.g, dense.h)]
    dptr = [t.data_ptr() for t in d] or [None] * 3
    count = int(ids.size)
    tau = np.asarray(tau, dtype=np.float32)[ids]
    sigma = np.asarray(sigma, dtype=np.float32)[ids]
    err = lib.pdhg_block_launch(
        n, M, k, m, iters, plan.cluster, plan.term_cap, plan.smem_bytes, count,
        (ctypes.c_int * count)(*ids.tolist()), (ctypes.c_float * count)(*tau.tolist()),
        (ctypes.c_float * count)(*sigma.tolist()), ex, eX,
        *(t.data_ptr() for t in c), *dptr,
        *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
        torch.cuda.current_stream(cx.device).cuda_stream,
    )
    if err in _ERRORS:
        raise RuntimeError(f"pdhg_block_launch: {_ERRORS[err]} (cluster {plan.cluster}, "
                           f"{plan.smem_bytes} bytes per CTA)")
    _build.check(err, "pdhg_block_launch")
    pdhg_block.launches += 1
    return PDHGState(*outs[:6]), PDHGState(*outs[6:])


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
        n, M, k, m, plan.cluster, plan.term_cap, plan.smem_bytes, instances,
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
