"""Top-k selection with deterministic tie-breaking (port of
``sdpcutsel_tpu/ops/topk.py``).

Ties break toward the lowest candidate index, as ``jax.lax.top_k`` and
``jnp.argmax`` do.  ``torch.topk`` promises no order among ties, so
``masked_topk`` sorts stably instead; ``torch.argmax`` returns the first
maximum.
"""

from __future__ import annotations

import torch


def masked_topk(scores, k: int, mask=None):
    """Top-k scores with invalid entries masked to -inf, along the last axis
    (leading axes are a batch).

    Returns (values: (..., k), indices: (..., k), valid: (..., k) finite entries)."""
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, -torch.inf))
    order = torch.sort(-scores, stable=True).indices[..., :k]
    vals = torch.gather(scores, -1, order)
    return vals, order, torch.isfinite(vals)


def diverse_topk(scores, table, k: int, alpha: float, mask=None):
    """Greedy support-diverse top-k over candidate index subsets:

        pick argmax(score - alpha * sum_{i in rho} count[i]),  k times,

    where count[i] is how often index i was used by earlier picks.  The
    penalty is kept incrementally: picking row r adds, to every candidate,
    its number of index matches with table[r].  scores (..., T), table
    (..., T, kk): leading axes are a batch, each picked on its own.
    Returns (values = original scores of the picks, indices, valid), each
    (..., k), like masked_topk."""
    neg = torch.full_like(scores, -torch.inf)
    sc = scores if mask is None else torch.where(mask, scores, neg)
    sc = sc.clone()
    pen = torch.zeros_like(sc)
    vals, sel = [], []
    for _ in range(k):
        i = torch.argmax(sc - alpha * pen, dim=-1, keepdim=True)      # (..., 1)
        val = torch.gather(sc, -1, i)
        row = torch.gather(table, -2, i[..., None].expand(*i.shape, table.shape[-1]))
        add = (table[..., :, :, None] == row[..., :, None, :]).sum((-2, -1)).to(sc.dtype)
        pen = torch.where(torch.isfinite(val), pen + add, pen)
        sc.scatter_(-1, i, -torch.inf)
        vals.append(val[..., 0])
        sel.append(i[..., 0])
    vals = torch.stack(vals, -1)
    return vals, torch.stack(sel, -1), torch.isfinite(vals)
