"""Wrapper of the checked-block kernel K5 (``csrc/pdhg_check.cu``).

After each K2 block of a solve, ``pdhg_check`` does what the reference's
``lax.while_loop`` body does after its block (``sdpcutsel_tpu/lp/pdhg.py``
``checked_block``): the ergodic average, the KKT errors of the iterate and
of the average, the choice between them, restart-to-average with the
primal-weight update, the stop test and the next block's steps, in place on
the state, sums, anchor and the solve's control record (``lp/pdhg.py``
``new_record``), with no host read.  An instance whose record has stopped is
left as it is.  The reference computes this in XLA inside its loop: K5 has
no Pallas counterpart.  Its twins are ``lp/pdhg.py``'s
``pdhg_check_plain`` and ``pdhg_check_batched_plain``.

Shapes: those K2 takes (n <= 128, k = 2..5); one cluster of ``CLUSTER``
CTAs per instance, a grid of every instance of the batch.

Device rule: CPU tensors take the twin; CUDA tensors launch the kernel; any
other device raises.  ``pdhg_check.launches`` counts kernel launches, one a
call of either wrapper; ``pdhg_check.plain_launches`` the twin checks a solve
ran on CUDA (``LPConfig.use_kernel="off"``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..relax.batched import batch_of_one
from ..relax.cutbuffer import CutIndex, CutPool
from ..relax.denserows import DenseRows
from .pdhg import PDHGState, pdhg_check_batched_plain, pdhg_check_plain
from .pdhg_kernel import CLUSTER, _ERRORS, _checked_args, check_record

def _launch(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState, acc: PDHGState,
            anchor: PDHGState, rec, check_every: int, restart_period: int, max_iters: int,
            tol: float, dense: DenseRows | None, cluster: int = CLUSTER):
    """One launch for every instance of a batch (the instance axis first)."""
    B, n, M, k, m, ex, eX = _checked_args(cx, cX, pool, index, (st, acc, anchor), dense,
                                          "pdhg_check")
    check_record(rec, B, cx.device, "pdhg_check")
    bufs = [*st.fields(), *acc.fields(), *anchor.fields()]
    if not all(t.is_contiguous() for t in bufs):
        raise ValueError("pdhg_check kernel takes contiguous state, sums and anchor")
    lib = _build.lib()
    c = [t.contiguous() for t in (cx, cX, index.idx, pool.lin, pool.quad, pool.rhs,
                                  pool.active, index.xoff, index.xcut, index.xcoef,
                                  index.Xoff, index.Xcut, index.Xcoef)]
    d = [] if dense is None else [t.contiguous() for t in (dense.G, dense.g, dense.h)]
    dptr = [t.data_ptr() for t in d] or [None] * 3
    err = lib.pdhg_check_launch(
        n, M, k, m, B, cluster, ex, eX, check_every, restart_period, max_iters,
        float(np.float32(tol)), *(t.data_ptr() for t in c), *dptr,
        *(t.data_ptr() for t in bufs), rec.data_ptr(),
        torch.cuda.current_stream(cx.device).cuda_stream)
    if err in _ERRORS:
        raise RuntimeError(f"pdhg_check_launch: {_ERRORS[err]} (cluster {cluster})")
    _build.check(err, "pdhg_check_launch")
    pdhg_check.launches += 1


def pdhg_check(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState, acc: PDHGState,
               anchor: PDHGState, rec, check_every: int, restart_period: int, max_iters: int,
               tol: float, dense: DenseRows | None = None):
    """The checked block's control after a block of ``check_every``
    iterations, in place on (st, acc, anchor) and the solve's record ``rec``
    (int32 (REC_WORDS,)); ``index`` is ``build_cut_index(pool, n)``."""
    if cx.device.type == "cpu":
        pdhg_check_plain(cx, cX, pool, index, st, acc, anchor, rec, check_every,
                         restart_period, max_iters, tol, dense)
        return
    if cx.device.type == "cuda":
        _launch(cx[None], cX[None], batch_of_one(pool), batch_of_one(index), batch_of_one(st),
                batch_of_one(acc), batch_of_one(anchor), rec[None], check_every,
                restart_period, max_iters, tol, None if dense is None else batch_of_one(dense))
        return
    raise ValueError(f"pdhg_check: no kernel for device {cx.device}")


pdhg_check.launches = 0
pdhg_check.plain_launches = 0     # twin checks a solve ran on CUDA (kernel_route)


def pdhg_check_batched(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState,
                       acc: PDHGState, anchor: PDHGState, rec, check_every: int,
                       restart_period: int, max_iters: int, tol: float,
                       dense: DenseRows | None = None):
    """``pdhg_check`` of every instance of a batch in one launch: every
    argument carries the instance axis first, ``index`` is
    ``relax.batched.build_cut_index(pool, n)``, ``rec`` is (B, REC_WORDS).
    Counted in ``pdhg_check.launches``."""
    if cx.device.type == "cpu":
        pdhg_check_batched_plain(cx, cX, pool, index, st, acc, anchor, rec, check_every,
                                 restart_period, max_iters, tol, dense)
        return
    if cx.device.type == "cuda":
        _launch(cx, cX, pool, index, st, acc, anchor, rec, check_every, restart_period,
                max_iters, tol, dense)
        return
    raise ValueError(f"pdhg_check: no kernel for device {cx.device}")

