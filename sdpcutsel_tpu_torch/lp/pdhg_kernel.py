"""Wrapper of the PDHG iteration-block kernel (``csrc/pdhg_block.cu``) and
its plain PyTorch twin.

``pdhg_block`` runs ``iters`` iterations of the exact ``_one_iter`` update
(lp/pdhg.py) and adds every iterate to the ergodic sums.  It replaces the
Pallas kernel ``sdpcutsel_tpu/lp/pdhg_kernel.py::_kernel`` (launched from
``pdhg_block``).  Float32, n <= 128, any pool capacity M and dense row count
m whose (M + m,) dual vectors fit in shared memory.  The dense rows of a
QCQP (``dense``, m > 0) run inside the kernel too; the TPU kernel had none.

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

import torch

from .. import _build
from ..relax.cutbuffer import CutIndex, CutPool
from ..relax.denserows import DenseRows
from .pdhg import PDHGState, _one_iter

_NMAX = 128                  # one thread column per matrix column
_SMEM_BYTES = 200 * 1024     # dynamic shared memory for the (M + m,) duals


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
            dense: DenseRows | None):
    n = cx.shape[0]
    M, k = pool.idx.shape
    m = 0 if dense is None else dense.m
    tensors = [cx, cX, pool.lin, pool.quad, pool.rhs, pool.active,
               index.xcoef, index.Xcoef, *st.fields(), *acc.fields()]
    if dense is not None:
        tensors += [dense.G, dense.g, dense.h]
    if n > _NMAX:
        raise ValueError(f"pdhg_block kernel takes n <= {_NMAX}, got {n}")
    if 4 * (M + m) > _SMEM_BYTES:
        raise ValueError(f"pdhg_block kernel: {M} cut and {m} dense duals "
                         "exceed shared memory")
    if st.yD.shape != (m,):
        raise ValueError(f"pdhg_block kernel: yD has shape {tuple(st.yD.shape)}, "
                         f"the dense block {m} rows")
    for t in tensors:
        if t.dtype != torch.float32 or t.device != cx.device:
            raise ValueError("pdhg_block kernel takes float32 tensors on one device")
    lib = _build.lib()
    out_st = st.map(lambda t: t.contiguous().clone())
    out_acc = acc.map(lambda t: t.contiguous().clone())
    S = torch.empty((n, n), dtype=torch.float32, device=cx.device)
    Xb = torch.empty_like(S)
    c = [t.contiguous() for t in (cx, cX, pool.lin, pool.quad, pool.rhs,
                                  pool.active)]
    ptr = [t.data_ptr() for t in c]
    d = [] if dense is None else [t.contiguous() for t in (dense.G, dense.g, dense.h)]
    dptr = [t.data_ptr() for t in d] or [None] * 3
    err = lib.pdhg_block_launch(
        n, M, k, m, iters, tau, sigma,
        ptr[0], ptr[1],
        index.idx.data_ptr(), ptr[2], ptr[3], ptr[4], ptr[5],
        index.xoff.data_ptr(), index.xcut.data_ptr(), index.xcoef.data_ptr(),
        index.Xoff.data_ptr(), index.Xcut.data_ptr(), index.Xcoef.data_ptr(),
        *dptr,
        *(t.data_ptr() for t in out_st.fields()),
        *(t.data_ptr() for t in out_acc.fields()),
        S.data_ptr(), Xb.data_ptr(),
        torch.cuda.current_stream(cx.device).cuda_stream,
    )
    _build.check(err, "pdhg_block_launch")
    pdhg_block.launches += 1
    return out_st, out_acc


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
