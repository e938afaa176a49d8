"""Fixed-capacity masked cut pool (port of ``sdpcutsel_tpu/relax/cutbuffer.py``).

Cut t (support rho of size <= kmax, eigenvector v = (v0, u)):

    lin . x[idx_t]  +  <quad, X[idx_t, idx_t]>  >=  rhs_t

with every row divided by its l2 norm.  Padded support slots carry idx=0 and
zero coefficients, so gathers read x[0] harmlessly and adjoint scatters add
zero.  The cut operator uses direct gathers; the one-hot support embedding
of the JAX package is a TPU workaround and has no counterpart here.

The adjoint is a scatter-add.  ``index_add_`` adds in no fixed order on
CUDA, so a solve builds a ``CutIndex`` once (the pool is constant during a
solve) and ``cut_adjoint`` sums every destination's terms over it in one
fixed order: repeated solves give identical bits.  The PDHG block kernel
reads the same index.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class CutPool:
    idx: torch.Tensor     # (M, kmax) int64 — support indices into x
    lin: torch.Tensor     # (M, kmax)
    quad: torch.Tensor    # (M, kmax, kmax), symmetric per cut
    rhs: torch.Tensor     # (M,)
    active: torch.Tensor  # (M,) float mask {0., 1.}
    count: torch.Tensor   # () int64

    @property
    def capacity(self) -> int:
        return self.idx.shape[0]


def empty_pool(capacity: int, kmax: int, device) -> CutPool:
    return CutPool(
        idx=torch.zeros((capacity, kmax), dtype=torch.int64, device=device),
        lin=torch.zeros((capacity, kmax), device=device),
        quad=torch.zeros((capacity, kmax, kmax), device=device),
        rhs=torch.zeros((capacity,), device=device),
        active=torch.zeros((capacity,), device=device),
        count=torch.zeros((), dtype=torch.int64, device=device),
    )


def cut_residuals(x, X, pool: CutPool, include_rhs: bool = True):
    """r_t = lin.x_rho + <quad, X_rho_rho> (- rhs), zero on inactive rows."""
    idx = pool.idx
    xg = x[idx]                                        # (M, kmax)
    Xg = X[idx[:, :, None], idx[:, None, :]]           # (M, kmax, kmax)
    r = (pool.lin * xg).sum(1) + (pool.quad * Xg).sum((1, 2))
    r = r * pool.active
    if include_rhs:
        r = r - pool.rhs * pool.active
    return r


@dataclasses.dataclass
class CutIndex:
    """Inverse index of the active cuts' terms, grouped by destination.

    Terms of destination d of x (resp. X, flattened i*n + j) are entries
    ``off[d]:off[d+1]`` of (cut, coef), in the pool's (t, a, b) order; cut is
    the pool row of the term.  The ``pad`` pairs hold the same terms as
    (destinations, widest segment) tables, padded with cut 0 and coefficient
    0, for fixed-order row sums in torch."""
    idx: torch.Tensor        # (M, k) int32 support indices
    xoff: torch.Tensor       # (n + 1,) int32
    xcut: torch.Tensor       # (Ex,) int32
    xcoef: torch.Tensor      # (Ex,) lin coefficients
    Xoff: torch.Tensor       # (n * n + 1,) int32
    Xcut: torch.Tensor       # (EX,) int32
    Xcoef: torch.Tensor      # (EX,) quad coefficients
    xpad_cut: torch.Tensor   # (n, Lx) int64
    xpad_coef: torch.Tensor  # (n, Lx)
    Xpad_cut: torch.Tensor   # (n * n, LX) int64
    Xpad_coef: torch.Tensor  # (n * n, LX)


def _group(dest, cut, coef, size: int):
    order = torch.sort(dest, stable=True).indices
    dest, cut, coef = dest[order], cut[order], coef[order]
    grid = torch.arange(size + 1, device=dest.device, dtype=dest.dtype)
    off = torch.searchsorted(dest, grid)
    count = off[1:] - off[:-1]
    width = int(count.max())                 # one host read per solve
    slot = torch.arange(width, device=dest.device)
    pos = torch.where(slot < count[:, None], off[:-1, None] + slot, dest.shape[0])
    pad_cut = torch.cat([cut, cut.new_zeros(1)])[pos]
    pad_coef = torch.cat([coef, coef.new_zeros(1)])[pos]
    return (off.to(torch.int32), cut.to(torch.int32).contiguous(),
            coef.contiguous(), pad_cut, pad_coef)


def build_cut_index(pool: CutPool, n: int) -> CutIndex:
    """Sort the active cuts' terms by destination (once per solve)."""
    M, k = pool.idx.shape
    idx = pool.idx
    live = pool.active > 0
    rows = torch.arange(M, device=idx.device)
    xcut = rows[:, None].expand(M, k)[live]
    xoff, xcut, xcoef, *xpad = _group(idx[live].reshape(-1), xcut.reshape(-1),
                                      pool.lin[live].reshape(-1), n)
    dest = (idx[:, :, None] * n + idx[:, None, :])[live]
    Xcut = rows[:, None, None].expand(M, k, k)[live]
    Xoff, Xcut, Xcoef, *Xpad = _group(dest.reshape(-1), Xcut.reshape(-1),
                                      pool.quad[live].reshape(-1), n * n)
    return CutIndex(idx.to(torch.int32).contiguous(), xoff, xcut, xcoef,
                    Xoff, Xcut, Xcoef, *xpad, *Xpad)


def cut_adjoint(yC, pool: CutPool, n: int, index: CutIndex):
    """Adjoint of the cut block: yC-weighted coefficients scatter-added into
    (gx: (n,), gX: (n, n)), summed in the fixed order of the pool's
    ``index`` (``build_cut_index(pool, n)``)."""
    w = yC * pool.active
    gx = (w[index.xpad_cut] * index.xpad_coef).sum(1)
    gX = (w[index.Xpad_cut] * index.Xpad_coef).sum(1)
    return gx, gX.reshape(n, n)


def append_cuts(pool: CutPool, idx, lin, quad, rhs, valid) -> CutPool:
    """Append the rows where ``valid`` is set after the pool's ``count``
    rows; rows that would land at or past capacity are dropped."""
    valid = valid.to(pool.active.dtype)
    vi = (valid > 0).to(torch.int64)
    dest = pool.count + torch.cumsum(vi, 0) - 1
    keep = (vi > 0) & (dest < pool.capacity)
    d = dest[keep]
    new = CutPool(
        idx=pool.idx.clone(), lin=pool.lin.clone(), quad=pool.quad.clone(),
        rhs=pool.rhs.clone(), active=pool.active.clone(),
        count=torch.clamp(pool.count + vi.sum(), max=pool.capacity),
    )
    new.idx[d] = idx[keep].to(torch.int64)
    new.lin[d] = lin[keep].to(pool.lin.dtype)
    new.quad[d] = quad[keep].to(pool.quad.dtype)
    new.rhs[d] = rhs[keep].to(pool.rhs.dtype)
    new.active[d] = valid[keep]
    return new


def purge_pool(pool: CutPool, yC, slack, slack_tol: float,
               dual_tol: float = 1e-8):
    """Keep active cuts that are binding (slack < slack_tol) or carry dual
    weight, compacted stably to the front.  Returns (pool, permuted yC)."""
    keep = (pool.active > 0) & ((slack < slack_tol) | (yC > dual_tol))
    order = torch.argsort((~keep).to(torch.int32), stable=True)
    kept = keep[order].to(pool.active.dtype)
    return (
        CutPool(
            idx=pool.idx[order] * kept[:, None].to(torch.int64),
            lin=pool.lin[order] * kept[:, None],
            quad=pool.quad[order] * kept[:, None, None],
            rhs=pool.rhs[order] * kept,
            active=kept,
            count=kept.sum().to(torch.int64),
        ),
        yC[order] * kept,
    )
