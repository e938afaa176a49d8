"""Exact optimality scores: the small-SDP subproblem oracle of strategy
``optimality`` (port of ``sdpcutsel_tpu/models/labels.py``).

    improvement(rho) = 1/2 <Q_rho, X*_rho>  -  s(Q_rho; x*_rho)
    s(Q; x) = max { 1/2 <Q, X> :  L(x) <= X <= U(x),  X - x x^T >= 0 }

where [L(x), U(x)] are the McCormick interval bounds at fixed x
(max(0, x_i + x_j - 1) <= X_ij <= min(x_i, x_j)), and X - x x^T >= 0 is the
Schur complement of Z(rho) >= 0 at fixed x.  improvement >= 0 is how much
this block's objective contribution must drop to become PSD-consistent at
the current point.

The k x k subproblems (k <= 5) are solved together by batched ADMM, each
iteration one clip and one batched ``torch.linalg.eigh`` (in float64, the
rest in float32).  Plain torch on both devices, as the reference is plain
jnp: no kernel runs here.  The label generation of NN training will reuse
these functions.
"""

from __future__ import annotations

import torch

# blocks a torch.linalg.eigh call takes: on the H100 (torch 2.11, CUDA 12.8)
# cuSOLVER's batched syev refused all 317,750 3 x 3 blocks of spar125-100-1
# in one call (CUSOLVER_STATUS_INVALID_VALUE from its buffer-size query)
EIGH_CHUNK = 8192


def _mccormick_box(x):
    """Interval bounds on X at fixed x: (L, U), each (..., k, k)."""
    lo = (x[..., :, None] + x[..., None, :] - 1.0).clamp(min=0.0)
    hi = torch.minimum(x[..., :, None], x[..., None, :])
    return lo, torch.maximum(hi, lo)  # guard a degenerate interval


def _eigh(S):
    """``torch.linalg.eigh`` in float64 on at most EIGH_CHUNK blocks a call,
    cast back to S's type.  In float32, cuSOLVER's eigh on the card does not
    converge on some small degenerate blocks (padded clique blocks of
    qcqpband100-5-25-1 at k = 4, even scaled to a largest entry of 1),
    which it decomposes in float64.  Each block is decomposed on its own, so the
    chunks give the bits of one call."""
    parts = [torch.linalg.eigh(chunk) for chunk in S.double().split(EIGH_CHUNK)]
    return (torch.cat([w for w, _ in parts]).to(S.dtype),
            torch.cat([V for _, V in parts]).to(S.dtype))


def _proj_psd(S):
    """Projection onto the PSD cone (batched small eigh).  V diag(w+) V' is
    summed elementwise, not as a matrix product: no cuBLAS call, so the
    process's TF32 setting cannot reach it."""
    w, V = _eigh(S)
    Vw = V * w.clamp(min=0.0)[..., None, :]
    return (Vw[..., :, None, :] * V[..., None, :, :]).sum(-1)


def solve_subproblem_admm(Q, x, iters: int = 300, rho: float = 1.0):
    """Batched s(Q; x) = max 1/2 <Q, X> over the box intersected with
    x x^T + PSD.  Q: (B, k, k) symmetric, x: (B, k).  Returns (value: (B,),
    X: (B, k, k)).

    ADMM on  min -1/2 <Q, X> + I_box(X) + I_cone(Y),  X = Y:
        X <- clip(Y - U + Q / (2 rho), L, U_box)
        Y <- x x^T + proj_psd(X + U - x x^T)
        U <- U + X - Y
    The value is 1/2 <Q, Y clipped to the box>."""
    lo, hi = _mccormick_box(x)
    xxT = x[..., :, None] * x[..., None, :]
    Y = torch.clamp(xxT, lo, hi)
    U = torch.zeros_like(Y)
    Qh = Q / (2.0 * rho)
    for _ in range(iters):
        Xb = torch.clamp(Y - U + Qh, lo, hi)
        Y = xxT + _proj_psd(Xb + U - xxT)
        U = U + Xb - Y
    Xfin = torch.clamp(Y, lo, hi)
    return 0.5 * (Q * Xfin).sum((-2, -1)), Xfin


def exact_improvement(Q_sub, x_sub, X_sub, iters: int = 300):
    """improvement(rho) for a batch of candidate blocks (module doc)."""
    current = 0.5 * (Q_sub * X_sub).sum((-2, -1))
    s, _ = solve_subproblem_admm(Q_sub, x_sub, iters=iters)
    return (current - s).clamp(min=0.0)


def exact_score_fn(Q, table, iters: int = 300):
    """Strategy ``optimality``: the exact improvement of every row of
    ``table`` (T, k).  Returns score(x, X, generator) -> (T,); the generator
    is not drawn from."""
    table = table.long()
    Qr = Q[table[:, :, None], table[:, None, :]]     # (T, k, k), once

    def score(x, X, generator=None):
        Xr = X[table[:, :, None], table[:, None, :]]
        return exact_improvement(Qr, x[table], Xr, iters=iters)

    return score
