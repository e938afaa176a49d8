"""The checked block on K2's route: one launch of K2 (``csrc/pdhg_block.cu``)
in its checked form, whose epilogue is K5 (``csrc/pdhg_check.cuh``).

A solve's step does what the reference's ``lax.while_loop`` body does
(``sdpcutsel_tpu/lp/pdhg.py`` ``checked_block``): ``check_every`` PDHG
iterations, then the ergodic average, the KKT errors of the iterate and of
the average, the choice between them, restart-to-average with the
primal-weight update, the stop test and the next block's steps, in place on
the state, sums, anchor and the solve's control record (``lp/pdhg.py``
``new_record``), with no host read.  On the card the control runs in the
same cluster as the block, on the bands still in shared memory, before the
block's one store of the state.  An instance whose record has stopped is
left as it is.  The reference computes the control in XLA inside its loop:
K5 has no Pallas counterpart.  Twins: ``pdhg_block_steps_plain`` then
``lp/pdhg.py``'s ``pdhg_check_plain`` (batched: their ``_batched`` forms).

``checked_step`` checks the arguments and marshals the launch once per
solve and returns the step; ``pdhg_block_checked`` and
``pdhg_block_checked_batched`` are one step each.  Shapes: those K2 takes
(``pdhg_kernel.plan_refusal``, whose rule is this checked form's); one
cluster of ``CLUSTER`` CTAs per instance, a grid of every instance of the
batch.

Device rule: CPU tensors take the twins; CUDA tensors launch the kernel;
any other device raises.  A launch counts once in ``pdhg_block.launches``
(K2 ran) and once in ``pdhg_block_checked.launches`` (K5 ran in it);
``pdhg_block_checked.plain_launches`` counts the twin checks a solve ran on
CUDA (``LPConfig.use_kernel="off"``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..relax.batched import batch_of_one
from ..relax.cutbuffer import CutIndex, CutPool
from ..relax.denserows import DenseRows
from .pdhg import PDHGState, pdhg_check_batched_plain, pdhg_check_plain
from .pdhg_kernel import (CLUSTER, _ERRORS, _checked_args, check_record, launch_plan,
                          pdhg_block, pdhg_block_steps_batched_plain, pdhg_block_steps_plain)


def _enqueue(fn, args: tuple, plan) -> None:
    """One checked launch: the C entry ``fn`` on its marshalled ``args``
    (looked up by name at each step, so that a profiler can wrap it)."""
    err = fn(*args)
    if err in _ERRORS:
        raise RuntimeError(f"pdhg_block_checked_launch: {_ERRORS[err]} (cluster "
                           f"{plan.cluster}, width {plan.cols}, {plan.smem_bytes} bytes per CTA)")
    _build.check(err, "pdhg_block_checked_launch")
    pdhg_block.launches += 1
    pdhg_block_checked.launches += 1


def _launcher(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState, acc: PDHGState,
              anchor: PDHGState, rec, check_every: int, restart_period: int, max_iters: int,
              tol: float, dense: DenseRows | None, cluster: int = CLUSTER):
    """The launch of the checked block for every instance of a batch (the
    instance axis first), its arguments checked and its pointers taken once:
    a function of no arguments that enqueues one launch."""
    B, n, M, k, m, ex, eX = _checked_args(cx, cX, pool, index, (st, acc, anchor), dense,
                                          "pdhg_block_checked")
    check_record(rec, B, cx.device, "pdhg_block_checked")
    bufs = [*st.fields(), *acc.fields(), *anchor.fields()]
    if not all(t.is_contiguous() for t in bufs):
        raise ValueError("pdhg_block_checked kernel takes contiguous state, sums and anchor")
    if check_every < 1:
        raise ValueError(f"pdhg_block_checked: check_every must be >= 1, got {check_every}")
    plan = launch_plan(n, M, k, m, cluster, checked=True)
    c = [t.contiguous() for t in (cx, cX, index.idx, pool.lin, pool.quad, pool.rhs,
                                  pool.active, index.xoff, index.xcut, index.xcoef,
                                  index.Xoff, index.Xcut, index.Xcoef)]
    d = [] if dense is None else [t.contiguous() for t in (dense.G, dense.g, dense.h)]
    args = (n, M, k, m, check_every, plan.cluster, plan.cols, plan.term_cap, plan.smem_bytes, B,
            rec.data_ptr(), ex, eX, check_every, restart_period, max_iters,
            float(np.float32(tol)), *(t.data_ptr() for t in c),
            *([t.data_ptr() for t in d] or [None] * 3), *(t.data_ptr() for t in bufs),
            torch.cuda.current_stream(cx.device).cuda_stream)
    fn = _build.lib().pdhg_block_checked_launch

    def launch():
        _enqueue(fn, args, plan)

    launch.keep = (c, d)    # the contiguous copies live as long as the step
    return launch


def checked_step(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState, acc: PDHGState,
                 anchor: PDHGState, rec, check_every: int, restart_period: int,
                 max_iters: int, tol: float, dense: DenseRows | None = None,
                 batched: bool = False):
    """The solve's step on K2's route over fixed buffers: a function of no
    arguments that runs one checked block of ``check_every`` iterations in
    place on (st, acc, anchor) and ``rec`` (single: (REC_WORDS,); batched:
    every argument with the instance axis first, ``rec`` (B, REC_WORDS)).
    CPU tensors take the twins, CUDA tensors one launch a step."""
    dev = cx.device
    if dev.type == "cpu":
        block, check = ((pdhg_block_steps_batched_plain, pdhg_check_batched_plain) if batched
                        else (pdhg_block_steps_plain, pdhg_check_plain))

        def step():
            block(cx, cX, pool, index, st, acc, rec, check_every, dense)
            check(cx, cX, pool, index, st, acc, anchor, rec, check_every, restart_period,
                  max_iters, tol, dense)
        return step
    if dev.type != "cuda":
        raise ValueError(f"pdhg_block_checked: no kernel for device {dev}")
    if batched:
        return _launcher(cx, cX, pool, index, st, acc, anchor, rec, check_every,
                         restart_period, max_iters, tol, dense)
    return _launcher(cx[None], cX[None], batch_of_one(pool), batch_of_one(index),
                     batch_of_one(st), batch_of_one(acc), batch_of_one(anchor), rec[None],
                     check_every, restart_period, max_iters, tol,
                     None if dense is None else batch_of_one(dense))


def pdhg_block_checked(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState,
                       acc: PDHGState, anchor: PDHGState, rec, check_every: int,
                       restart_period: int, max_iters: int, tol: float,
                       dense: DenseRows | None = None):
    """One checked block of ``check_every`` iterations and its control, in
    place on (st, acc, anchor) and the solve's record ``rec`` (int32
    (REC_WORDS,)); ``index`` is ``build_cut_index(pool, n)``."""
    checked_step(cx, cX, pool, index, st, acc, anchor, rec, check_every, restart_period,
                 max_iters, tol, dense)()


pdhg_block_checked.launches = 0
pdhg_block_checked.plain_launches = 0    # twin checks a solve ran on CUDA (kernel_route)


def pdhg_block_checked_batched(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState,
                               acc: PDHGState, anchor: PDHGState, rec, check_every: int,
                               restart_period: int, max_iters: int, tol: float,
                               dense: DenseRows | None = None):
    """``pdhg_block_checked`` of every instance of a batch in one launch:
    every argument carries the instance axis first, ``index`` is
    ``relax.batched.build_cut_index(pool, n)``, ``rec`` is (B, REC_WORDS).
    Counted in ``pdhg_block_checked.launches``."""
    checked_step(cx, cX, pool, index, st, acc, anchor, rec, check_every, restart_period,
                 max_iters, tol, dense, batched=True)()
