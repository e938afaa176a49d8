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


PENALTY_ROWS = 1 << 26      # table rows a step of the penalty's update reads at once


def diverse_topk(scores, table, k: int, alpha: float, mask=None):
    """Greedy support-diverse top-k over candidate index subsets:

        pick argmax(score - alpha * sum_{i in rho} count[i]),  k times,

    where count[i] is how often index i was used by earlier picks (once for
    each time it appears in a pick).  The penalty is kept incrementally:
    picking row r adds, to every candidate, r's count at each of the
    candidate's indices, which is its number of index matches with table[r]
    (the reference's (T, k, k) compare, counted the same way on rows that
    repeat an index).  Each pick gathers r's counts (an (n,) vector) at one
    table column at a time, PENALTY_ROWS rows a step, so that no temporary
    is larger than one (..., T) float tensor; every penalty is a small
    integer, exact in float32, so the picks are the compare's bits.  The
    reference dropped this gather only because it serialises on the TPU
    (``sdpcutsel_tpu/ops/topk.py``).  scores (..., T), table (..., T, kk):
    leading axes are a batch, each picked on its own.  Returns (values =
    original scores of the picks, indices, valid), each (..., k), like
    masked_topk."""
    sc = scores.clone() if mask is None else torch.where(mask, scores, -torch.inf)
    pen = torch.zeros_like(sc)
    eff = torch.empty_like(sc)
    lead, T, kk = sc.shape[:-1], sc.shape[-1], table.shape[-1]
    n = int(table.max()) + 1 if table.numel() else 1
    vals, sel = [], []
    for _ in range(k):
        torch.mul(pen, alpha, out=eff)
        torch.sub(sc, eff, out=eff)                                    # sc - alpha * pen
        i = torch.argmax(eff, dim=-1, keepdim=True)                    # (..., 1)
        val = torch.gather(sc, -1, i)
        row = torch.gather(table, -2, i[..., None].expand(*i.shape, kk))[..., 0, :].long()
        # the picked row's count of each index, none where the pick is -inf
        count = torch.zeros((*lead, n), dtype=sc.dtype, device=sc.device)
        count.scatter_add_(-1, row, torch.isfinite(val).to(sc.dtype).expand(*lead, kk))
        for s in range(0, T, PENALTY_ROWS):
            part = pen[..., s:s + PENALTY_ROWS]
            for a in range(kk):
                part += torch.gather(count, -1, table[..., s:s + PENALTY_ROWS, a].long())
        sc.scatter_(-1, i, -torch.inf)
        vals.append(val[..., 0])
        sel.append(i[..., 0])
    vals = torch.stack(vals, -1)
    return vals, torch.stack(sel, -1), torch.isfinite(vals)
