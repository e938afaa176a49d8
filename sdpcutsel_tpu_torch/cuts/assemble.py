"""Batched moment submatrices Z(rho) = [[1, x_rho'], [x_rho, X_rho_rho]]
(port of ``sdpcutsel_tpu/cuts/assemble.py``)."""

from __future__ import annotations

import torch


def assemble_Z(x, X, idx):
    """x: (n,), X: (n, n), idx: (T, k) -> Z: (T, k+1, k+1)."""
    idx = idx.long()
    T, k = idx.shape
    xr = x[idx]                                   # (T, k)
    Xr = X[idx[:, :, None], idx[:, None, :]]      # (T, k, k)
    Z = torch.empty((T, k + 1, k + 1), dtype=x.dtype, device=x.device)
    Z[:, 0, 0] = 1.0
    Z[:, 0, 1:] = xr
    Z[:, 1:, 0] = xr
    Z[:, 1:, 1:] = Xr
    return Z
