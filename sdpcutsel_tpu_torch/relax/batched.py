"""The relaxation's operators over a batch of instances of one shape (the
instance axis of ``sdpcutsel_tpu/parallel/round.py``, which ran the
single-instance operators under ``jax.vmap``).

Every tensor carries a leading instance axis B: x (B, n), X (B, n, n), a
``CutPool`` whose fields are (B, M, ...) with count (B,), a ``DenseRows``
block (B, m, n, n).  Each function computes, for every instance, what its
single-instance namesake in ``cutbuffer.py``, ``mccormick.py`` and
``denserows.py`` computes, as one set of tensor operations for the whole
batch, with no host read except where a single solve has one too
(``build_cut_index``).  Sums run over the same axes as the single
operators', in torch's order for the batched shape, so an instance's bits
may differ from its single solve's; the cut adjoint still sums over the
fixed-order index, so a batched solve repeats bit for bit.

``instance``, ``stack`` and ``batch_of_one`` move between the two forms.
"""

from __future__ import annotations

import dataclasses

import torch

from .cutbuffer import CutIndex, CutPool
from .denserows import DenseRows
from .mccormick import SA, SB


def instance(obj, b: int):
    """Instance b of a batched dataclass (CutPool, CutIndex, PDHGState,
    DenseRows): every field indexed by b (views)."""
    return type(obj)(*(getattr(obj, f.name)[b] for f in dataclasses.fields(obj)))


def stack(objs: list):
    """A batched dataclass from single ones (every field stacked)."""
    return type(objs[0])(*(torch.stack([getattr(o, f.name) for o in objs])
                           for f in dataclasses.fields(objs[0])))


def batch_of_one(obj):
    """A single-instance dataclass as a batch of one (views)."""
    return type(obj)(*(getattr(obj, f.name)[None] for f in dataclasses.fields(obj)))


def where(mask, a, b):
    """Per instance, a's fields where mask (B,) is set, else b's."""
    return type(a)(*(torch.where(mask.view(-1, *[1] * (u.dim() - 1)), u, v)
                     for u, v in zip(values(a), values(b))))


def values(obj) -> list:
    """The fields of a dataclass, in order (no copies)."""
    return [getattr(obj, f.name) for f in dataclasses.fields(obj)]


def empty_pool(B: int, capacity: int, kmax: int, device) -> CutPool:
    return CutPool(
        idx=torch.zeros((B, capacity, kmax), dtype=torch.int64, device=device),
        lin=torch.zeros((B, capacity, kmax), device=device),
        quad=torch.zeros((B, capacity, kmax, kmax), device=device),
        rhs=torch.zeros((B, capacity), device=device),
        active=torch.zeros((B, capacity), device=device),
        count=torch.zeros((B,), dtype=torch.int64, device=device),
    )


def _gather(a, index):
    """a (B, N) gathered at index (B, ...) of flat positions: (B, ...)."""
    B = a.shape[0]
    return torch.gather(a, 1, index.reshape(B, -1)).view(index.shape)


def cut_residuals(x, X, pool: CutPool, include_rhs: bool = True):
    """(B, M): lin . x_rho + <quad, X_rho_rho> (- rhs), zero on inactive rows."""
    B, n = x.shape
    idx = pool.idx
    xg = _gather(x, idx)                                            # (B, M, k)
    Xg = _gather(X.reshape(B, n * n), idx[..., :, None] * n + idx[..., None, :])
    r = (pool.lin * xg).sum(-1) + (pool.quad * Xg).sum((-2, -1))
    r = r * pool.active
    if include_rhs:
        r = r - pool.rhs * pool.active
    return r


def _group(dest, cut, coef, B: int, size: int):
    """The single ``_group`` for every instance at once: terms keyed by
    (instance, destination), sorted stably, so each instance's terms keep
    their (t, a, b) order.  Returns per-instance offsets (B, size + 1),
    term arrays padded to the batch's longest (B, E), and the (B, size, L)
    pad tables."""
    dev = dest.device
    order = torch.sort(dest, stable=True).indices
    dest, cut, coef = dest[order], cut[order], coef[order]
    off = torch.searchsorted(dest, torch.arange(B * size + 1, device=dev, dtype=dest.dtype))
    count = off[1:] - off[:-1]
    first = off[:-1:size]                                           # (B,) each instance's start
    terms = off[size::size] - first
    E, L = torch.stack([terms.max(), count.max()]).tolist()     # one host read
    pos = torch.arange(B, device=dev)[:, None] * size + torch.arange(size + 1, device=dev)
    inst_off = off[pos] - first[:, None]
    owner = torch.div(dest, size, rounding_mode="floor")
    at = torch.arange(dest.shape[0], device=dev) - first[owner]
    term_cut = torch.zeros((B, E), dtype=torch.int32, device=dev)
    term_coef = torch.zeros((B, E), dtype=coef.dtype, device=dev)
    term_cut[owner, at] = cut.to(torch.int32)
    term_coef[owner, at] = coef
    slot = torch.arange(L, device=dev)
    pad = torch.where(slot < count[:, None], off[:-1, None] + slot, dest.shape[0])
    pad_cut = torch.cat([cut, cut.new_zeros(1)])[pad].view(B, size, L)
    pad_coef = torch.cat([coef, coef.new_zeros(1)])[pad].view(B, size, L)
    return inst_off.to(torch.int32), term_cut, term_coef, pad_cut, pad_coef


def build_cut_index(pool: CutPool, n: int) -> CutIndex:
    """``cutbuffer.build_cut_index`` of every instance: a ``CutIndex`` whose
    fields carry the instance axis first; the term arrays (xcut, xcoef,
    Xcut, Xcoef) are padded to the batch's longest, and each instance's
    offsets (xoff, Xoff) index its own row.  Two host reads."""
    B, M, k = pool.idx.shape
    dev = pool.idx.device
    idx = pool.idx
    live = pool.active > 0
    inst = torch.arange(B, device=dev)[:, None, None]
    rows = torch.arange(M, device=dev)[None, :, None]
    sel = live[:, :, None].expand(B, M, k)
    x = _group((inst * n + idx)[sel], rows.expand(B, M, k)[sel], pool.lin[sel], B, n)
    dest = inst[..., None] * (n * n) + idx[..., :, None] * n + idx[..., None, :]
    sel = live[:, :, None, None].expand(B, M, k, k)
    X = _group(dest[sel], rows[..., None].expand(B, M, k, k)[sel], pool.quad[sel], B, n * n)
    return CutIndex(idx.to(torch.int32).contiguous(), x[0], x[1], x[2], X[0], X[1], X[2],
                    x[3], x[4], X[3], X[4])


def cut_adjoint(yC, pool: CutPool, n: int, index: CutIndex):
    """(gx: (B, n), gX: (B, n, n)) summed over the batched ``index``."""
    w = yC * pool.active
    gx = (_gather(w, index.xpad_cut) * index.xpad_coef).sum(-1)
    gX = (_gather(w, index.Xpad_cut) * index.Xpad_coef).sum(-1)
    return gx, gX.view(-1, n, n)


def dense_residuals(x, X, dense: DenseRows, include_rhs: bool = True):
    """(B, m): <G_i, X> + g_i . x (- h_i)."""
    r = (dense.G * X[:, None]).sum((-2, -1)) + (dense.g * x[:, None]).sum(-1)
    if include_rhs:
        r = r - dense.h
    return r


def dense_adjoint(yD, dense: DenseRows):
    return (yD[..., None] * dense.g).sum(1), (yD[..., None, None] * dense.G).sum(1)


def apply_K(x, X, pool: CutPool, dense: DenseRows | None = None):
    """``mccormick.apply_K`` of every instance."""
    kA = SA * (x[..., :, None] - X)
    kB = SB * (X - x[..., :, None] - x[..., None, :])
    kC = cut_residuals(x, X, pool, include_rhs=False)
    if dense is None:
        return kA, kB, kC
    return kA, kB, kC, dense_residuals(x, X, dense, include_rhs=False)


def apply_KT(yA, yB, yC, pool: CutPool, n: int, index: CutIndex, yD=None,
             dense: DenseRows | None = None):
    """``mccormick.apply_KT`` of every instance."""
    gx = SA * yA.sum(-1) - SB * (yB.sum(-1) + yB.sum(-2))
    gX = -SA * yA + SB * yB
    cx, cX = cut_adjoint(yC, pool, n, index)
    gx, gX = gx + cx, gX + cX
    if dense is not None:
        dx, dX = dense_adjoint(yD, dense)
        gx, gX = gx + dx, gX + dX
    return gx, gX


def sym(X):
    return 0.5 * (X + X.transpose(-1, -2))


def append_cuts(pool: CutPool, idx, lin, quad, rhs, valid) -> CutPool:
    """``cutbuffer.append_cuts`` of every instance (rows (B, R, ...)).  No
    host read: rows that do not land are written to a spare slot past the
    end, which is dropped."""
    B, M = pool.active.shape
    valid = valid.to(pool.active.dtype)
    vi = (valid > 0).to(torch.int64)
    dest = pool.count[:, None] + torch.cumsum(vi, -1) - 1
    keep = (vi > 0) & (dest < M)
    at = torch.where(keep, dest, M)

    def put(field, rows):
        ext = torch.cat([field, field.new_zeros((B, 1) + field.shape[2:])], 1)
        where_ = at.view(B, -1, *[1] * (rows.dim() - 2)).expand(rows.shape)
        return ext.scatter(1, where_, rows.to(field.dtype))[:, :M]

    return CutPool(idx=put(pool.idx, idx), lin=put(pool.lin, lin), quad=put(pool.quad, quad),
                   rhs=put(pool.rhs, rhs), active=put(pool.active, valid),
                   count=torch.clamp(pool.count + vi.sum(-1), max=M))


def purge_pool(pool: CutPool, yC, slack, slack_tol: float, dual_tol: float = 1e-8):
    """``cutbuffer.purge_pool`` of every instance."""
    keep = (pool.active > 0) & ((slack < slack_tol) | (yC > dual_tol))
    order = torch.argsort((~keep).to(torch.int32), dim=-1, stable=True)
    kept = torch.gather(keep, 1, order).to(pool.active.dtype)

    def take(t):
        o = order.view(*order.shape, *[1] * (t.dim() - 2)).expand(t.shape)
        return torch.gather(t, 1, o)

    k1, k2 = kept[..., None], kept[..., None, None]
    return (CutPool(idx=take(pool.idx) * k1.to(torch.int64), lin=take(pool.lin) * k1,
                    quad=take(pool.quad) * k2, rhs=take(pool.rhs) * kept, active=kept,
                    count=kept.sum(-1).to(torch.int64)),
            take(yC) * kept)
