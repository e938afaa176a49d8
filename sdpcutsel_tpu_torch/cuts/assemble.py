"""Batched moment submatrices Z(rho) = [[1, x_rho'], [x_rho, X_rho_rho]]
(port of ``sdpcutsel_tpu/cuts/assemble.py``)."""

from __future__ import annotations

import torch


def assemble_Z(x, X, idx):
    """x: (..., n), X: (..., n, n), idx: (..., T, k) -> Z: (..., T, k+1, k+1);
    leading axes are a batch of instances."""
    idx = idx.long()
    n, k = x.shape[-1], idx.shape[-1]
    xr = torch.gather(x, -1, idx.flatten(-2)).view(idx.shape)                  # (..., T, k)
    flat = (idx[..., :, None] * n + idx[..., None, :]).flatten(-3)
    Xr = torch.gather(X.flatten(-2), -1, flat).view(*idx.shape, k)               # (..., T, k, k)
    Z = torch.empty((*idx.shape[:-1], k + 1, k + 1), dtype=x.dtype, device=x.device)
    Z[..., 0, 0] = 1.0
    Z[..., 0, 1:] = xr
    Z[..., 1:, 0] = xr
    Z[..., 1:, 1:] = Xr
    return Z
