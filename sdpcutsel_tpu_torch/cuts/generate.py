"""Eigenvector -> unit-norm cut rows (port of ``sdpcutsel_tpu/cuts/generate.py``).

For a selected subset rho with Z(rho) eigenpair (lambda < 0, v = (v0, u)),
the cut v' Z(rho) v >= 0 reads

    2 v0 (u . x_rho) + <u u', X_rho_rho>  >=  -v0^2

One row per eigenpair; valid where lambda < -viol_tol.
"""

from __future__ import annotations

import torch


def cuts_from_selected(idx_sel, w, V, viol_tol: float, sel_valid=None):
    """idx_sel: (S, k) supports; w: (S, k+1) eigenvalues; V: (S, k+1, k+1)
    eigenvectors (columns); sel_valid: optional (S,) mask.

    Returns (idx: (S*(k+1), k), lin, quad, rhs, valid) for append_cuts."""
    S, k1 = w.shape
    k = k1 - 1
    v0 = V[:, 0, :]                               # (S, k+1)
    u = V[:, 1:, :]                               # (S, k, k+1)
    lin = 2.0 * v0[:, None, :] * u                # (S, k, k+1)
    quad = u[:, :, None, :] * u[:, None, :, :]    # (S, k, k, k+1)
    rhs = -(v0 ** 2)                              # (S, k+1)

    nrm = torch.sqrt((lin ** 2).sum(1) + (quad ** 2).sum((1, 2))) + 1e-30
    lin = lin / nrm[:, None, :]
    quad = quad / nrm[:, None, None, :]
    rhs = rhs / nrm

    valid = w < -viol_tol
    if sel_valid is not None:
        valid = valid & sel_valid[:, None]

    idx_rows = torch.repeat_interleave(idx_sel, k1, dim=0)
    lin_rows = lin.movedim(2, 1).reshape(S * k1, k)
    quad_rows = quad.movedim(3, 1).reshape(S * k1, k, k)
    return idx_rows, lin_rows, quad_rows, rhs.reshape(S * k1), valid.reshape(S * k1)
