"""Top-k selection with deterministic tie-breaking (port of
``sdpcutsel_tpu/ops/topk.py``).

Ties break toward the lowest candidate index, as ``jax.lax.top_k`` and
``jnp.argmax`` do.  ``torch.topk`` promises no order among ties, so
``masked_topk`` sorts stably instead; ``torch.argmax`` returns the first
maximum.

``RunningTopk`` gives ``masked_topk``'s top k, with the rows, over scores
seen a piece at a time, for a batch of instances at once (the batched
round's local top-k by pieces, ``parallel/round.py``).  ``StreamedTopk``
gives ``diverse_topk``'s (or, at alpha 0, ``masked_topk``'s)
picks over a table seen a piece at a time, bit for bit, holding only the
rows that can still be picked (the k = 3 round past the table's memory,
``loop/solver.py``; at k = 4 and 5 too); with ``group`` > 1 a row carries
that many flat candidates (triangle's four inequalities a triple,
``cuts/triangle.py``).
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
SURVIVOR_CAP = 1 << 28      # StreamedTopk's survivors (4 + 8 + 4 kk bytes each) at most


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


class StreamedTopk:
    """``diverse_topk(scores, table, S, alpha)`` (alpha > 0; at alpha <= 0
    ``masked_topk(scores, S)``, as ``select_and_generate`` chooses) over a
    table that comes a piece at a time in increasing row order (``add``),
    never holding the whole score vector; ``result`` gives the same picks,
    bit for bit, with global indices, and the picked rows.

    Why a threshold is exact (alpha > 0): each pick adds at most kk index
    matches to a candidate's penalty (a row's indices are distinct), so
    before pick j <= S a candidate's penalty is at most P = kk (S - 1).  Of
    the S largest raw scores (the S-th is s_S) one is still unpicked at pick
    j, and its effective score fl(raw - fl(alpha pen)) is at least tau =
    fl(s_S - fl(alpha P)), rounding being monotone; so every pick p has
    raw(p) >= eff(p) >= tau, computed in float32 as the greedy computes
    eff.  The running top S raw values only rise, and tau with them: each
    piece's rows with raw >= tau survive (finite ones only: where fewer than
    S scores are finite tau is -inf), the earlier survivors are pruned to
    the new tau, and ``result`` runs ``diverse_topk`` itself over the
    survivors in increasing global index, so argmax's first-index tie-break
    picks what it picks on the whole table; a -inf pick is global row 0 (and
    the table's row 0, 0..kk-1), as torch.argmax gives it there.  At alpha
    <= 0 the survivors are the running top S by (score, lower index), which
    ``masked_topk``'s stable sort picks alike.  Scores are float32 without
    NaN (a NaN raises).  ``most`` is the largest number of survivors held.
    ``group``: the flat candidates a row carries (scores g r .. g r + g - 1
    are row r's, global indices g times the row's); the picks' global
    indices are flat ones, as ``masked_topk(scores.reshape(-1), S)`` gives
    them on the whole (T, g) table (int64 past 2^31).  Past SURVIVOR_CAP
    survivors ``add`` raises (where fewer than S scores lie above alpha P,
    every row from tau up survives, zero rows included, and the survivors
    grow with the table) rather than change a pick."""

    def __init__(self, S: int, alpha: float, kk: int, device, group: int = 1):
        self.S, self.alpha, self.kk, self.group = S, alpha, kk, group
        self.device = torch.device(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.top = torch.empty(0, **f32)                 # the running top S raw values
        self.vals = torch.empty(0, **f32)                # the survivors, in global order
        self.idx = torch.empty(0, dtype=torch.int64, device=self.device)
        self.rows = torch.empty((0, kk), dtype=torch.int32, device=self.device)
        self.pmax = torch.full((1,), kk * (S - 1), **f32)  # P, the largest penalty
        self.most = 0

    def _tau(self) -> torch.Tensor:
        """(1,): the threshold from the running top S (-inf before S rows)."""
        if self.top.numel() < self.S:
            return torch.full((1,), -torch.inf, dtype=torch.float32, device=self.device)
        s_S = self.top[self.S - 1:self.S]
        if self.alpha <= 0.0:
            return s_S
        return s_S - torch.mul(self.pmax, self.alpha)     # fl(s_S - fl(P alpha))

    def add(self, scores: torch.Tensor, rows: torch.Tensor, offset: int):
        """The next piece: its (T,) float32 scores, its (T / group, kk)
        int32 rows, and the global (flat) index of its first score (the
        pieces in order)."""
        g = self.group
        if (scores.dtype != torch.float32 or scores.shape[0] % g
                or rows.shape != (scores.shape[0] // g, self.kk)):
            raise ValueError("StreamedTopk.add takes (T,) float32 scores and (T / group, kk) rows")
        if bool(torch.isnan(scores).any()):
            raise ValueError("StreamedTopk: a score is NaN")
        both = torch.cat([self.top, scores])
        self.top = torch.topk(both, min(self.S, both.numel())).values
        tau = self._tau()
        keep = scores >= tau
        if self.alpha > 0.0:
            keep &= scores > -torch.inf
            old = self.vals >= tau
            self.vals, self.idx, self.rows = self.vals[old], self.idx[old], self.rows[old]
        at = torch.nonzero(keep)[:, 0]
        vals = torch.cat([self.vals, scores[at]])
        idx = torch.cat([self.idx, at + offset])
        rows_ = torch.cat([self.rows, rows[at // g]])
        self.most = max(self.most, vals.numel())
        if vals.numel() > SURVIVOR_CAP:
            raise RuntimeError(f"StreamedTopk: {vals.numel()} survivors pass the cap of "
                               f"{SURVIVOR_CAP} (the threshold {float(tau)!r}: fewer than "
                               f"{self.S} scores lie above alpha P)")
        if self.alpha <= 0.0:          # the running top S by (score, lower index)
            best = torch.sort(torch.sort(-vals, stable=True).indices[:self.S]).values
            vals, idx, rows_ = vals[best], idx[best], rows_[best]
        self.vals, self.idx, self.rows = vals, idx, rows_

    def result(self):
        """(values, global indices, valid, picked rows), each (S,) ((S, kk)
        for the rows), as the whole table's selection gives them."""
        S, dev = self.S, self.device
        row0 = torch.arange(self.kk, dtype=torch.int32, device=dev)
        if self.alpha <= 0.0:
            vals, local, valid = masked_topk(self.vals, S)
            return vals, self.idx[local], valid, self.rows[local]
        if self.vals.numel() == 0:
            vals = torch.full((S,), -torch.inf, dtype=torch.float32, device=dev)
            return (vals, torch.zeros(S, dtype=torch.int64, device=dev),
                    torch.zeros(S, dtype=torch.bool, device=dev), row0.expand(S, -1).clone())
        vals, local, valid = diverse_topk(self.vals, self.rows, S, self.alpha)
        dead = vals == -torch.inf
        idx = torch.where(dead, 0, self.idx[local])
        rows = torch.where(dead[:, None], row0, self.rows[local])
        return vals, idx, valid, rows


class RunningTopk:
    """``masked_topk(scores, S, valid)`` along the last axis, with the
    picked rows, over scores that come a piece at a time in increasing
    position (``add``), never holding more than a piece: the batched
    round's local top-k of a shard (``parallel/sharding.py::local_topk``),
    leading axes a batch of instances.  It keeps the running top S values,
    their global positions and their rows; each piece's own top S joins
    them in a stable sort with the running winners first.  The order is a
    total one (-score, NaN last, then position), and every earlier winner
    lies at a lower position than the piece's rows, so the merge keeps the
    whole sort's top S bit for bit, the -inf entries of a shard with fewer
    than S finite scores included (the lowest such positions).  It keeps
    exactly S rows a batch entry, so ``SURVIVOR_CAP`` (``StreamedTopk``'s
    limit under the diversity penalty, which runs only after the shards'
    winners are gathered) has nothing to bound here."""

    def __init__(self, S: int):
        self.S = S
        self.vals = self.pos = self.rows = None

    def add(self, scores: torch.Tensor, valid: torch.Tensor, rows: torch.Tensor, offset: int):
        """The next piece: its (..., P) scores, its (P,) valid mask (invalid
        rows score -inf), its (P, k) rows, and the global position of its
        first row."""
        vals, at, _ = masked_topk(scores, self.S, valid)
        pos, won = at + offset, rows[at]                           # (..., s), (..., s, k)
        if self.vals is not None:
            vals = torch.cat([self.vals, vals], -1)
            pos = torch.cat([self.pos, pos], -1)
            won = torch.cat([self.rows, won], -2)
            vals, at, _ = masked_topk(vals, self.S)
            pos = torch.gather(pos, -1, at)
            won = torch.gather(won, -2, at[..., None].expand(*at.shape, won.shape[-1]))
        self.vals, self.pos, self.rows = vals, pos, won

    def result(self):
        """(values (..., S), rows (..., S, k)), as ``local_topk`` gives them."""
        return self.vals, self.rows
