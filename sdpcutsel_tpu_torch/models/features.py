"""Feature layout of the NN cut scorer (port of
``sdpcutsel_tpu/models/features.py``).

Per candidate rho of size k:

    scale = max |(Q_rho)_ij|       (0-safe; all-zero blocks score 0)
    feats = [ tri(Q_rho / scale) | x_rho | tri(X_rho) ]

k = 3 gives 15 features.  The score is scale * relu(MLP(feats)).
"""

from __future__ import annotations

import torch


def tri_indices(k: int, device):
    iu = torch.triu_indices(k, k, device=device)
    return iu[0], iu[1]


def candidate_q_features(Q, table):
    """Per-candidate objective features: (triQ: (..., T, k(k+1)/2), scale:
    (..., T,)); Q (..., n, n), leading axes a batch of instances."""
    table = table.long()
    i0, i1 = tri_indices(table.shape[1], Q.device)
    Qr = Q[..., table[:, :, None], table[:, None, :]]   # (..., T, k, k)
    scale = Qr.abs().amax(dim=(-2, -1))
    safe = scale.clamp(min=1e-12)
    triQ = (Qr / safe[..., None, None])[..., i0, i1]
    return triQ, scale


def candidate_features(triQ, x, X, table):
    """Full feature batch for the current point: (T, d)."""
    table = table.long()
    i0, i1 = tri_indices(table.shape[1], x.device)
    xr = x[table]
    Xr = X[table[:, :, None], table[:, None, :]]
    return torch.cat([triQ, xr, Xr[:, i0, i1]], dim=1)
