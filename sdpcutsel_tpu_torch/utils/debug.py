"""Debug mode (port of ``sdpcutsel_tpu/utils/debug.py``).

``RunConfig(debug=True)`` makes ``CutSolver`` and ``CutSolverQCQP`` call
``check_round_state`` at the end of every per-round ``do_round``, where the
reference calls it: the round's x and X, the pool after the new cuts, and the
certified bound.  The checks are plain torch on the tensors' own device, and
they read it once a round (the finiteness flags), only under ``debug``.

The reference also turns on ``jax_debug_nans``, which stops every jitted
computation at the first NaN or Inf it produces.  PyTorch has no counterpart
for eager forward code (anomaly mode watches backward passes only), so the
port adds no process-wide switch: the round check is the whole of its debug
mode.
"""

from __future__ import annotations

import math

import torch


def check_round_state(x, X, pool, bound: float) -> None:
    """One round's state: x of rank 1 and X of shape (n, n); the pool's lin
    (M, kmax) and quad (M, kmax, kmax); x, X, lin, quad, rhs and active all
    finite; the certified bound finite.  Raises AssertionError."""
    if x.dim() != 1:
        raise AssertionError(f"x has rank {x.dim()}, not 1")
    n = x.shape[0]
    if tuple(X.shape) != (n, n):
        raise AssertionError(f"X has shape {tuple(X.shape)}, not {(n, n)}")
    M, kmax = pool.idx.shape
    if tuple(pool.lin.shape) != (M, kmax):
        raise AssertionError(f"pool.lin has shape {tuple(pool.lin.shape)}, not {(M, kmax)}")
    if tuple(pool.quad.shape) != (M, kmax, kmax):
        raise AssertionError(f"pool.quad has shape {tuple(pool.quad.shape)}, "
                             f"not {(M, kmax, kmax)}")
    arrays = {"x": x, "X": X, "pool.lin": pool.lin, "pool.quad": pool.quad,
              "pool.rhs": pool.rhs, "pool.active": pool.active}
    finite = torch.stack([torch.isfinite(t).all() for t in arrays.values()]).tolist()
    bad = [name for name, ok in zip(arrays, finite) if not ok]
    if bad:
        raise AssertionError(f"non-finite values in {', '.join(bad)}")
    if not math.isfinite(bound):
        raise AssertionError(f"non-finite certified bound: {bound}")
