"""Triangle (RLT-3) inequalities, the comparison baseline of strategy
``triangle`` (port of ``sdpcutsel_tpu/cuts/triangle.py``).

For a triple rho = (i, j, l), x in [0,1]^n and X the lifted x x^T, the four
triangle inequalities of the boolean-quadric polytope are valid for
conv{(x, x x^T) : x in [0,1]^n}:

    T0:  x_i + x_j + x_l - X_ij - X_il - X_jl <= 1
    T1:  X_ij + X_il - X_jl <= x_i
    T2:  X_ij + X_jl - X_il <= x_j
    T3:  X_il + X_jl - X_ij <= x_l

Their coefficients are constant per (triple, type), so generation needs no
eigendecomposition: a gather and a top-k over the 4 T flat (triple, type)
candidates, scored by violation at the LP point.  Rows take the pool's form
``lin . x_rho + <quad, X_rho_rho> >= rhs`` (relax/cutbuffer.py), unit-l2
normalised like every other cut row.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.topk import masked_topk

# Coefficients per type in ">=" form (the "<=" inequalities above negated).
# quad is symmetric with each off-diagonal weight split over both entries.
_LIN = np.array(
    [
        [-1.0, -1.0, -1.0],   # T0: -x_i - x_j - x_l + Xij + Xil + Xjl >= -1
        [1.0, 0.0, 0.0],      # T1:  x_i - Xij - Xil + Xjl >= 0
        [0.0, 1.0, 0.0],      # T2:  x_j - Xij - Xjl + Xil >= 0
        [0.0, 0.0, 1.0],      # T3:  x_l - Xil - Xjl + Xij >= 0
    ],
    dtype=np.float32,
)


def _sym(ij, il, jl):
    h = 0.5
    return np.array([[0.0, h * ij, h * il], [h * ij, 0.0, h * jl], [h * il, h * jl, 0.0]],
                    dtype=np.float32)


_QUAD = np.stack([_sym(1.0, 1.0, 1.0), _sym(-1.0, -1.0, 1.0),
                  _sym(-1.0, 1.0, -1.0), _sym(1.0, -1.0, -1.0)])
_RHS = np.array([-1.0, 0.0, 0.0, 0.0], dtype=np.float32)

# unit-l2 row normalisation, as cuts/generate.py's rows
_NRM = np.sqrt((_LIN ** 2).sum(1) + (_QUAD ** 2).sum((1, 2)))
_LIN_N = _LIN / _NRM[:, None]
_QUAD_N = _QUAD / _NRM[:, None, None]
_RHS_N = _RHS / _NRM


def triangle_violations(x, X, table):
    """Violation of each of the 4 inequalities at (x, X) for every triple of
    ``table`` (T, 3).  Returns (T, 4); positive = violated."""
    table = table.long()
    i, j, l = table[:, 0], table[:, 1], table[:, 2]
    xi, xj, xl = x[i], x[j], x[l]
    Xij, Xil, Xjl = X[i, j], X[i, l], X[j, l]
    v0 = xi + xj + xl - Xij - Xil - Xjl - 1.0
    v1 = Xij + Xil - Xjl - xi
    v2 = Xij + Xjl - Xil - xj
    v3 = Xil + Xjl - Xij - xl
    return torch.stack([v0, v1, v2, v3], dim=1)


def triangle_scores(x, X, table):
    """One score a triple: its largest violation over the 4 types."""
    return triangle_violations(x, X, table).amax(dim=1)


def triangle_select_and_generate(x, X, table, sel_size: int, viol_tol: float,
                                 table_mask=None):
    """The ``sel_size`` most violated inequalities over all 4 T flat
    (triple, type) candidates -> cut rows.  Ties go to the lowest flat index
    (``masked_topk``'s stable sort), as in the reference.

    Returns (idx: (S, 3), lin, quad, rhs, valid) for ``append_cuts``.
    ``table_mask``: optional (T,) bool; masked triples never win."""
    viol = triangle_violations(x, X, table)                  # (T, 4)
    if table_mask is not None:
        viol = torch.where(table_mask[:, None], viol, torch.full_like(viol, -torch.inf))
    vals, sel, finite = masked_topk(viol.reshape(-1), sel_size)
    tri, typ = sel // 4, sel % 4
    coef = {"dtype": x.dtype, "device": x.device}
    idx = table[tri].long()
    lin = torch.as_tensor(_LIN_N, **coef)[typ]
    quad = torch.as_tensor(_QUAD_N, **coef)[typ]
    rhs = torch.as_tensor(_RHS_N, **coef)[typ]
    return idx, lin, quad, rhs, finite & (vals > viol_tol)
