"""Dense linear rows over (x, X): the linearized quadratic constraints of a
QCQP (port of ``sdpcutsel_tpu/relax/denserows.py``).

Each constraint 1/2 x'Qi x + ci'x <= bi linearizes through the lift as
1/2 <Qi, X> + ci'x <= bi, which in the min-form convention K z >= h reads

    row_i:  <Gi, X> + gi'x >= hi,   Gi = -Qi / 2,  gi = -ci,  hi = -bi,

each row divided by its l2 norm.  Stored dense, (m, n, n) + (m, n) + (m,).
The products are elementwise multiplies and sums, so no cuBLAS call (and no
TF32) touches them and they repeat bit for bit on CUDA.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class DenseRows:
    G: torch.Tensor   # (m, n, n) symmetric coefficient on X (normalized)
    g: torch.Tensor   # (m, n) coefficient on x
    h: torch.Tensor   # (m,) right-hand side in K z >= h form

    @property
    def m(self) -> int:
        return self.h.shape[0]


def empty_dense(n: int, device) -> DenseRows:
    return DenseRows(G=torch.zeros((0, n, n), device=device),
                     g=torch.zeros((0, n), device=device),
                     h=torch.zeros((0,), device=device))


def dense_from_qcqp(Qs, cs, bs, device) -> DenseRows:
    """Build the normalized dense block from QCQP constraint data (the
    norms are taken in float64, the rows stored in float32)."""
    if len(bs) == 0:
        raise ValueError("use empty_dense for zero constraints")
    G = np.stack([-0.5 * np.asarray(Q, np.float64) for Q in Qs])
    g = np.stack([-np.asarray(c, np.float64) for c in cs])
    h = -np.asarray(bs, np.float64)
    nrm = np.sqrt((G ** 2).sum((1, 2)) + (g ** 2).sum(1)) + 1e-30
    return DenseRows(*(torch.as_tensor(a.astype(np.float32), device=device)
                       for a in (G / nrm[:, None, None], g / nrm[:, None], h / nrm)))


def batched_dense_from_qcqp(instances, device) -> DenseRows:
    """Every instance's normalised block (``dense_from_qcqp``) stacked into
    (B, m_max, n, n), (B, m_max, n), (B, m_max) for the batched round.  An
    instance with fewer constraints gets all-zero rows (h = 0, coefficients
    0): the residual max(h - K z, 0) is identically 0, so a padded row never
    binds."""
    B, n = len(instances), instances[0].n
    m_max = max(inst.m for inst in instances)
    out = DenseRows(G=torch.zeros((B, m_max, n, n), device=device),
                    g=torch.zeros((B, m_max, n), device=device),
                    h=torch.zeros((B, m_max), device=device))
    for i, inst in enumerate(instances):
        if inst.m:
            d = dense_from_qcqp(inst.Qs, inst.cs, inst.bs, device)
            out.G[i, :inst.m], out.g[i, :inst.m], out.h[i, :inst.m] = d.G, d.g, d.h
    return out


def dense_residuals(x, X, dense: DenseRows, include_rhs: bool = True):
    """K z (linear part) for the dense block; (m,)."""
    r = (dense.G * X).sum((1, 2)) + (dense.g * x).sum(1)
    if include_rhs:
        r = r - dense.h
    return r


def dense_adjoint(yD, dense: DenseRows):
    """(gx, gX) = K^T yD for the dense block."""
    gx = (yD[:, None] * dense.g).sum(0)
    gX = (yD[:, None, None] * dense.G).sum(0)
    return gx, gX
