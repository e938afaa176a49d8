"""McCormick relaxation as structured dense operators (BoxQP only; port of
``sdpcutsel_tpu/relax/mccormick.py``).

Primal point (x: (n,), X: (n, n)) with X symmetric.  For all ordered pairs
(i, j), diagonal included, the scaled residuals are

    rA[i,j] = SA (x_i - X_ij)             >= 0
    rB[i,j] = SB (X_ij - x_i - x_j + 1)   >= 0

plus the unit-norm cut rows of the pool.  Min-form objective throughout.
"""

from __future__ import annotations

import math

from .cutbuffer import CutIndex, CutPool, cut_adjoint, cut_residuals

SA = 1.0 / math.sqrt(2.0)  # row scaling for rA
SB = 1.0 / math.sqrt(3.0)  # row scaling for rB


def apply_K(x, X, pool: CutPool):
    """Linear part of the constraint map K z >= h, with hA = 0, hB = -SB and
    hC = pool.rhs.  Returns (kA, kB, kC)."""
    kA = SA * (x[:, None] - X)
    kB = SB * (X - x[:, None] - x[None, :])
    kC = cut_residuals(x, X, pool, include_rhs=False)
    return kA, kB, kC


def apply_KT(yA, yB, yC, pool: CutPool, n: int, index: CutIndex):
    """Adjoint K^T y -> (gx: (n,), gX: (n, n)); ``index`` as in cut_adjoint."""
    gx = SA * yA.sum(1) - SB * (yB.sum(1) + yB.sum(0))
    gX = -SA * yA + SB * yB
    cx, cX = cut_adjoint(yC, pool, n, index)
    return gx + cx, gX + cX


def project_primal(x, X):
    """Exact projection onto [0,1]^n x {X symmetric, entries in [0,1]}:
    symmetrize, then clip."""
    return x.clamp(0.0, 1.0), (0.5 * (X + X.T)).clamp(0.0, 1.0)
