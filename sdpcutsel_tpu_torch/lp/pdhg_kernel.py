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

Device rule: CPU tensors take the twin; CUDA tensors launch the kernel; any
other device raises.  ``pdhg_block.launches`` counts kernel launches.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import _build
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


def _launch(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState,
            acc: PDHGState, tau: float, sigma: float, iters: int,
            dense: DenseRows | None, cluster: int = CLUSTER):
    n = cx.shape[0]
    M, k = pool.idx.shape
    m = 0 if dense is None else dense.m
    plan = launch_plan(n, M, k, m, cluster)
    if st.yD.shape != (m,) or acc.yD.shape != (m,):
        raise ValueError(f"pdhg_block kernel: yD has shape {tuple(st.yD.shape)}, "
                         f"the dense block {m} rows")
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
    outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in ins]
    c = [t.contiguous() for t in (cx, cX, index.idx, pool.lin, pool.quad, pool.rhs,
                                  pool.active, index.xoff, index.xcut, index.xcoef,
                                  index.Xoff, index.Xcut, index.Xcoef)]
    d = [] if dense is None else [t.contiguous() for t in (dense.G, dense.g, dense.h)]
    dptr = [t.data_ptr() for t in d] or [None] * 3
    err = lib.pdhg_block_launch(
        n, M, k, m, iters, tau, sigma, plan.cluster, plan.term_cap, plan.smem_bytes,
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
