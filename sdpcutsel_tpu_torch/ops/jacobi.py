"""Batched tiny symmetric eigenvalues: cyclic Jacobi in struct-of-arrays form
(port of ``sdpcutsel_tpu/ops/jacobi.py``, eigenvalues only).

The m(m+1)/2 unique entries of each Z(rho) live in separate (T,) tensors and
a fixed schedule of rotations updates them elementwise.  This is the plain
twin of the feasibility half of the scoring kernel (csrc/pair_score.cu),
with the same rotation formulas and the sign(0) = +1 rule.
"""

from __future__ import annotations

import torch


def _rotation_schedule(m: int):
    return [(p, q) for p in range(m) for q in range(p + 1, m)]


def _one_sweep(a: dict, m: int) -> dict:
    """One cyclic sweep (C(m, 2) rotations) over a = {(i, j): (T,), i <= j}."""

    def key(i, j):
        return (i, j) if i <= j else (j, i)

    for (p, q) in _rotation_schedule(m):
        apq, app, aqq = a[(p, q)], a[(p, p)], a[(q, q)]
        small = apq.abs() < 1e-30
        apq_safe = torch.where(small, torch.ones_like(apq), apq)
        tau = (aqq - app) / (2.0 * apq_safe)
        # sign(0) must be +1: every Z(rho) starts with a unit diagonal, and a
        # zero sign would freeze the rotation
        sgn = torch.where(tau >= 0.0, 1.0, -1.0).to(tau.dtype)
        t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
        t = torch.where(small, torch.zeros_like(t), t)
        c = 1.0 / torch.sqrt(1.0 + t * t)
        s = t * c
        a[(p, p)] = app - t * apq
        a[(q, q)] = aqq + t * apq
        a[(p, q)] = torch.zeros_like(apq)
        for r in range(m):
            if r in (p, q):
                continue
            arp, arq = a[key(r, p)], a[key(r, q)]
            a[key(r, p)] = c * arp - s * arq
            a[key(r, q)] = s * arp + c * arq
    return a


def min_eig_from_parts(x_r, X_r, sweeps: int = 6):
    """lambda_min of Z = [[1, x_r'], [x_r, X_r]] from gathered parts
    (x_r: (T, k), X_r: (T, k, k)) without materializing (T, k+1, k+1)."""
    k = x_r.shape[-1]
    a = {(0, 0): torch.ones_like(x_r[..., 0])}
    for j in range(k):
        a[(0, j + 1)] = x_r[..., j]
    for i in range(k):
        for j in range(i, k):
            a[(i + 1, j + 1)] = X_r[..., i, j]
    for _ in range(sweeps):
        a = _one_sweep(a, k + 1)
    out = a[(0, 0)]
    for i in range(1, k + 1):
        out = torch.minimum(out, a[(i, i)])
    return out
