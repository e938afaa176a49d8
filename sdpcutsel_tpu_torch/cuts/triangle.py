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

``triangle_select_and_generate`` takes the whole table.  Past what a card
holds (``loop/solver.py``), ``triangle_selection`` is fed one piece of the
table at a time (``triangle_add_piece``: its rows and the global index of
the first) and ``triangle_cut_rows`` gives the same picks and rows, bit for
bit, from (triple, type) of each pick; flat indices run past 2^31 from
n = 1,480 and are int64 throughout.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.topk import StreamedTopk, masked_topk

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
    return _cut_rows(x, table[sel // 4].long(), sel % 4, finite & (vals > viol_tol))


def _cut_rows(x, idx, typ, valid):
    """The rows for ``append_cuts`` of the picks' triples ``idx`` (S, 3) and
    types ``typ`` (S,)."""
    coef = {"dtype": x.dtype, "device": x.device}
    lin = torch.as_tensor(_LIN_N, **coef)[typ]
    quad = torch.as_tensor(_QUAD_N, **coef)[typ]
    rhs = torch.as_tensor(_RHS_N, **coef)[typ]
    return idx, lin, quad, rhs, valid


def triangle_selection(sel_size: int, device) -> StreamedTopk:
    """The streamed form of ``triangle_select_and_generate``'s top
    ``sel_size`` over the 4 T flat candidates (``masked_topk``: alpha 0),
    four a triple."""
    return StreamedTopk(sel_size, 0.0, 3, device, group=4)


def triangle_add_piece(sel: StreamedTopk, x, X, rows, offset: int):
    """One piece of the table: its (R, 3) rows, ``offset`` the global index
    of its first row (the pieces in order)."""
    sel.add(triangle_violations(x, X, rows).reshape(-1), rows, 4 * offset)


def triangle_cut_rows(x, sel: StreamedTopk, viol_tol: float):
    """``triangle_select_and_generate``'s result from the streamed
    selection once every piece is in."""
    vals, flat, finite, rows = sel.result()
    return _cut_rows(x, rows.long(), flat % 4, finite & (vals > viol_tol))
