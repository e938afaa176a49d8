"""McCormick relaxation as structured dense operators (port of
``sdpcutsel_tpu/relax/mccormick.py``).

Primal point (x: (n,), X: (n, n)) with X symmetric.  For all ordered pairs
(i, j), diagonal included, the scaled residuals are

    rA[i,j] = SA (x_i - X_ij)             >= 0
    rB[i,j] = SB (X_ij - x_i - x_j + 1)   >= 0

plus the unit-norm cut rows of the pool and, for a QCQP, the dense
constraint rows (relax/denserows.py).  Min-form objective throughout.
"""

from __future__ import annotations

import math

from .cutbuffer import CutIndex, CutPool, cut_adjoint, cut_residuals
from .denserows import DenseRows, dense_adjoint, dense_residuals

SA = 1.0 / math.sqrt(2.0)  # row scaling for rA
SB = 1.0 / math.sqrt(3.0)  # row scaling for rB


def apply_K(x, X, pool: CutPool, dense: DenseRows | None = None):
    """Linear part of the constraint map K z >= h, with hA = 0, hB = -SB,
    hC = pool.rhs and hD = dense.h.  Returns (kA, kB, kC), and kD after them
    when ``dense`` is given."""
    kA = SA * (x[:, None] - X)
    kB = SB * (X - x[:, None] - x[None, :])
    kC = cut_residuals(x, X, pool, include_rhs=False)
    if dense is None:
        return kA, kB, kC
    return kA, kB, kC, dense_residuals(x, X, dense, include_rhs=False)


def apply_KT(yA, yB, yC, pool: CutPool, n: int, index: CutIndex, yD=None,
             dense: DenseRows | None = None):
    """Adjoint K^T y -> (gx: (n,), gX: (n, n)); ``index`` as in cut_adjoint.
    The dense block's term is added when ``dense`` is given."""
    gx = SA * yA.sum(1) - SB * (yB.sum(1) + yB.sum(0))
    gX = -SA * yA + SB * yB
    cx, cX = cut_adjoint(yC, pool, n, index)
    gx, gX = gx + cx, gX + cX
    if dense is not None:
        dx, dX = dense_adjoint(yD, dense)
        gx, gX = gx + dx, gX + dX
    return gx, gX


def project_primal(x, X):
    """Exact projection onto [0,1]^n x {X symmetric, entries in [0,1]}:
    symmetrize, then clip."""
    return x.clamp(0.0, 1.0), (0.5 * (X + X.T)).clamp(0.0, 1.0)
