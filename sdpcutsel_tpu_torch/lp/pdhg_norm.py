"""Wrapper of the power-iteration kernel K6 (``csrc/pdhg_norm.cu``).

``pdhg_norm`` estimates ||K|| for a solve's step sizes as
``lp/pdhg.py::estimate_norm_plain`` does (its twin): ``iters`` power
iterations on the symmetric-X primal subspace from the start vector
(``lp/pdhg.py::start_vector``: with ``generator`` None, as every solve's
set-up passes, the seed-0 draw, made once for each n and kept on the
device; else a draw from ``generator``), then ||K z|| 1.02 + 1e-12, all in
one launch, and returns it as a tensor on the device: a solve reads it on
the host only where it needs a host float (steering).
``pdhg_norm_batched`` does it for every instance of a batch in one launch
(twin ``estimate_norm_batched_plain``), every instance from the same start
vector.  The reference runs a jitted ``fori_loop`` in XLA
(``sdpcutsel_tpu/lp/pdhg.py::estimate_norm``): K6 has no Pallas
counterpart.

Shapes: those K2 takes (n <= 256, k = 2..5, and every m of its launch
plan), at K2's column width (``pdhg_kernel.columns``: 128 for n <= 128, 256
above); one cluster of ``CLUSTER`` CTAs per instance, its iterate in shared
memory for the launch, and, where ``smem_words`` finds room, the band's
slice of the dense rows (``resident``) and the cut data it reads each
iteration (``staged``: its slots' supports and coefficients, a buffer for
the iterate at their supports, the band's cut-index segments), each read
from global memory once a launch.

Device rule: CPU tensors take the twin; CUDA tensors launch the kernel; any
other device raises.  ``pdhg_norm.launches`` counts kernel launches, one a
call of either wrapper; ``pdhg_norm.plain_launches`` the twins a solve's
set-up ran on CUDA (``LPConfig.use_kernel="off"``).
"""

from __future__ import annotations

import torch

from .. import _build
from ..relax.batched import batch_of_one
from ..relax.cutbuffer import CutIndex, CutPool
from ..relax.denserows import DenseRows
from .pdhg import estimate_norm_batched_plain, estimate_norm_plain, start_vector
from .pdhg_kernel import CLUSTER, SMEM_MAX, _ERRORS, columns

_THREADS = 512              # csrc/pdhg_common.cuh kThreads


def smem_words(n: int, M: int, k: int, m: int, C: int = CLUSTER) -> tuple[int, bool, bool]:
    """(4-byte words of one CTA's shared memory, whether the band's slice of
    the dense rows is resident, whether the cut data of the CTA's slots and
    the band's cut-index offsets are staged) of K6 at n, pool capacity M,
    width k, m dense rows and a cluster of C: ``csrc/pdhg_norm.cu``'s
    ``make_layout`` at n's column width.  Where staged, the band's cut-index
    terms take the rest of a CTA's shared memory.  Without the slice and the
    staging it is the layout of the version that kept the iterate in global
    memory, word for word."""
    R, Mc = -(-n // C), -(-M // C)
    RN, cols = R * n, columns(n)
    base = (4 * RN + 2 * R * (cols // 32) + C * (_THREADS // cols) * R + cols + R + M + C * m
            + m + C * 4 + (_THREADS // 32) * 2 + 4)
    words = SMEM_MAX // 4
    resident = m > 0 and base + m * (RN + R) <= words
    o = base + (m * (RN + R) if resident else 0)
    staged = o + Mc * (1 + 2 * k + 2 * k * k) + (RN + 1) + (R + 1) <= words
    if staged:
        o += Mc * (1 + 2 * k + 2 * k * k) + (RN + 1) + (R + 1)
        o += 2 * ((words - o) // 2)
    return o, resident, staged


def _launch(pool: CutPool, n: int, iters: int, generator: torch.Generator | None,
            index: CutIndex, dense: DenseRows | None, cluster: int = CLUSTER):
    """One launch for a batch (every argument with the instance axis first);
    returns (B,) float32 on the device."""
    dev = pool.lin.device
    B, M, k = pool.idx.shape
    m = 0 if dense is None else dense.G.shape[1]
    ex, eX = index.xcut.shape[-1], index.Xcut.shape[-1]
    shapes = {"index.idx": (index.idx, (B, M, k)), "index.xoff": (index.xoff, (B, n + 1)),
              "index.Xoff": (index.Xoff, (B, n * n + 1)), "index.xcut": (index.xcut, (B, ex)),
              "index.Xcut": (index.Xcut, (B, eX)), "pool.lin": (pool.lin, (B, M, k)),
              "pool.quad": (pool.quad, (B, M, k, k)), "pool.active": (pool.active, (B, M))}
    if dense is not None:
        shapes.update({"dense.G": (dense.G, (B, m, n, n)), "dense.g": (dense.g, (B, m, n))})
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want or t.device != dev:
            raise ValueError(f"pdhg_norm kernel: {name} has shape {tuple(t.shape)} on "
                             f"{t.device}, want {want} on {dev}")
    x, X = (t.contiguous() for t in start_vector(n, generator, dev))
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    c = [t.contiguous() for t in (index.idx, pool.lin, pool.quad, pool.active, index.xoff,
                                  index.xcut, index.xcoef, index.Xoff, index.Xcut, index.Xcoef)]
    d = [] if dense is None else [t.contiguous() for t in (dense.G, dense.g)]
    dptr = [t.data_ptr() for t in d] or [None] * 2
    err = _build.lib().pdhg_norm_launch(
        n, M, k, m, B, cluster, ex, eX, iters, *(t.data_ptr() for t in c), *dptr,
        x.data_ptr(), X.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err in _ERRORS:
        raise RuntimeError(f"pdhg_norm_launch: {_ERRORS[err]} (cluster {cluster})")
    _build.check(err, "pdhg_norm_launch")
    pdhg_norm.launches += 1
    return out


def pdhg_norm(pool: CutPool, n: int, iters: int, generator: torch.Generator | None,
              index: CutIndex, dense: DenseRows | None = None):
    """||K|| 1.02 + 1e-12 of a solve over ``pool`` (``index`` =
    ``build_cut_index(pool, n)``) after ``iters`` power iterations from
    ``start_vector(n, generator, ...)`` (None: the seed-0 draw, kept on the
    device): a 0-d float32 tensor on the pool's device."""
    dev = pool.lin.device
    if dev.type == "cpu":
        return estimate_norm_plain(pool, n, iters, generator, index, dense)
    if dev.type == "cuda":
        return _launch(batch_of_one(pool), n, iters, generator, batch_of_one(index),
                       None if dense is None else batch_of_one(dense))[0]
    raise ValueError(f"pdhg_norm: no kernel for device {dev}")


pdhg_norm.launches = 0
pdhg_norm.plain_launches = 0      # twins a solve's set-up ran on CUDA (kernel_route)


def pdhg_norm_batched(pool: CutPool, n: int, iters: int, generator: torch.Generator | None,
                      index: CutIndex, dense: DenseRows | None = None):
    """``pdhg_norm`` of every instance of a batch in one launch (every
    argument with the instance axis first, ``index`` from
    ``relax.batched.build_cut_index``), each from the same start vector:
    (B,) float32 on the device.  Counted in ``pdhg_norm.launches``."""
    dev = pool.lin.device
    if dev.type == "cpu":
        return estimate_norm_batched_plain(pool, n, iters, generator, index, dense)
    if dev.type == "cuda":
        return _launch(pool, n, iters, generator, index, dense)
    raise ValueError(f"pdhg_norm: no kernel for device {dev}")
