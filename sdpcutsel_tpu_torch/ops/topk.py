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
rows that can still be picked: those at or above its threshold, less
those that its exact dominance rules drop (given the table's n; the round
past the table's memory at k = 3, 4 and 5, ``loop/solver.py``); with
``group`` > 1 a row carries that many flat candidates (triangle's four
inequalities a triple, ``cuts/triangle.py``).
"""

from __future__ import annotations

import itertools
import math

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
# StreamedTopk's dominance rules (its docstring)
FLOOR_ROWS = 1 << 24        # scores a step of the floor's running minimum reads
CORE_ROWS = 1 << 22         # rows a step of the packings' thresholds reads
CORE_SURVIVORS = 1 << 25    # the best survivors a rebuild of the packings reads
CORE_ENTRIES = 1 << 26      # (core, part) entries a group of cores of a rebuild holds
CORE_FLAGS = 1 << 27        # used-index flags (cores x n bytes) a group holds
CORE_STEP = 1 << 21         # entries a step of the packings' greedy reads
ACCEPTS = 4                 # members a step of the greedy may take for a core
CORE_COUNT = 1 << 22        # cores at most (a threshold and a reach each)
REBUILD_MIN = SURVIVOR_CAP >> 10       # rows kept before packings of <= n cores are built
REBUILD_MIN_WIDE = SURVIVOR_CAP >> 4   # and before packings of more cores are
MARGIN = 2.0 ** -22         # a witness this far above r (relative) needs no lower index
TINY = 2.0 ** -126          # and this far (absolute)


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


def choose_cores(n: int, kk: int, S: int) -> tuple:
    """The core sizes c of ``StreamedTopk``'s packings over C(n, kk) rows
    at S picks (empty where none applies).  A packing needs m + 1 =
    kk (S - 1) + 1 members whose parts outside the core, kk - c indices
    each, are disjoint: n - c >= (kk - c)(m + 1); its cores, C(n, c), stay
    within CORE_COUNT.  Of those sizes: the one whose greedy packing, over
    parts in random order (uniform scores), is expected to read the
    smallest share of its core's rows before its (m + 1)-th member (the
    share of them above its threshold), and c = 0 and 1, which have at most
    n cores.  c = 0 needs n >= kk (m + 1): 174 at kk = 3, 308 at 4, 480 at
    5 (S = 20); at kk = 5 and 290 <= n < 385 c = 2 (at n = 330 3,495 of
    C(328, 3) rows, 6e-4) and 3 apply, and C(n, 3) passes CORE_COUNT from
    n = 296."""
    m, shares = kk * (S - 1), {}
    for c in range(kk):
        w, V = kk - c, n - c
        if V < w * (m + 1) or math.comb(n, c) > CORE_COUNT:
            continue
        scan = 0.0                  # the expected entries read, member by member
        for i in range(m + 1):
            p = 1.0                 # a random part misses the i w used indices
            for j in range(w):
                p *= (V - w * i - j) / (V - j)
            scan += 1.0 / p
        shares[c] = scan / math.comb(V, w)
    if not shares:
        return ()
    return tuple(sorted({min(shares, key=shares.get)} | {c for c in shares if c <= 1}))


class _Packings:
    """StreamedTopk's packings of one core size c over C(n, kk) rows: a
    threshold, a top and a reach a core (ranked colexicographically), from
    the greedy packings of the survivors (``rebuild``); ``amax`` is
    fl(alpha P), the largest penalty's part of an effective score."""

    def __init__(self, c: int, n: int, kk: int, m: int, amax: float, device):
        self.c, self.n, self.m, self.amax = c, n, m, amax
        self.subsets = [list(P) for P in itertools.combinations(range(kk), c)]
        self.parts = torch.tensor([[a for a in range(kk) if a not in P] for P in self.subsets],
                                  dtype=torch.int64, device=device)
        self.binom = torch.tensor([[math.comb(x, j) for j in range(c + 1)] for x in range(n + 1)],
                                  dtype=torch.int64, device=device)
        self.ncores = math.comb(n, c)
        self.thr = torch.full((self.ncores,), -torch.inf, dtype=torch.float32, device=device)
        self.top = torch.full((self.ncores,), -torch.inf, dtype=torch.float32, device=device)
        self.reach = torch.full((self.ncores,), -1, dtype=torch.int64, device=device)
        self.built = False              # a core has a threshold

    def rank(self, sub: torch.Tensor) -> torch.Tensor:
        """(R,) int64: the ranks of (R, c) sorted int64 index rows."""
        rank = torch.zeros(sub.shape[0], dtype=torch.int64, device=sub.device)
        for j in range(sub.shape[1]):
            rank += self.binom[sub[:, j], j + 1]
        return rank

    def dominated(self, vals, idx, rows) -> torch.Tensor:
        """(R,) bool for R <= CORE_ROWS rows (vals, global idx, (R, kk)
        int64 rows): for a core of the row's, raw at most its threshold and
        the index past its reach, or raw below the threshold by MARGIN."""
        out = torch.zeros(vals.shape, dtype=torch.bool, device=vals.device)
        v = vals.double()
        for P in self.subsets:
            core = self.rank(rows[:, P])
            thr = self.thr[core]
            margin = MARGIN * (self.top[core].double().abs() + v.abs() + 2 * self.amax) + TINY
            out |= (vals <= thr) & ((idx > self.reach[core]) | (v + margin <= thr.double()))
        return out

    def rebuild(self, rows, raw, idx):
        """The packings anew from K survivors in the best-first order
        ((K, kk) int64 rows, raw, idx): each survivor's core of each subset
        ranked once ((K, subsets) int32), then the (core, survivor, subset)
        entries in groups of cores of at most CORE_ENTRIES entries and
        CORE_FLAGS flags, each sorted by core (stable: best first); each
        core keeps the better threshold."""
        K, nsub = raw.numel(), len(self.subsets)
        cores = torch.empty((K, nsub), dtype=torch.int32, device=raw.device)
        for s in range(0, K, CORE_ROWS):
            for p, P in enumerate(self.subsets):
                cores[s:s + CORE_ROWS, p] = self.rank(rows[s:s + CORE_ROWS][:, P])
        flat = cores.view(-1)                          # entry e: survivor e // nsub
        cum = torch.cumsum(torch.bincount(flat, minlength=self.ncores), 0).cpu()
        full = torch.tensor(range(CORE_ENTRIES, int(cum[-1]) + 1, CORE_ENTRIES), dtype=torch.int64)
        cuts = sorted(set(range(0, self.ncores, max(1, CORE_FLAGS // self.n))) | {self.ncores}
                      | set(torch.searchsorted(cum, full, right=True).tolist()))
        for g0, g1 in zip(cuts[:-1], cuts[1:]):
            if g1 > self.ncores or int(cum[g1 - 1]) == (int(cum[g0 - 1]) if g0 else 0):
                continue                # no entry in the group
            e = (torch.nonzero((flat >= g0) & (flat < g1))[:, 0] if (g0, g1) != (0, self.ncores)
                 else torch.arange(flat.numel(), device=raw.device))
            core, order = torch.sort(flat[e] - g0, stable=True)
            e = e[order]
            del order
            thr, top, reach = self._pack(core.long(), e // nsub, e % nsub, g1 - g0,
                                         rows, raw, idx)
            better = thr > self.thr[g0:g1]
            self.thr[g0:g1] = torch.where(better, thr, self.thr[g0:g1])
            self.top[g0:g1] = torch.where(better, top, self.top[g0:g1])
            self.reach[g0:g1] = torch.where(better, reach, self.reach[g0:g1])
        self.built = bool((self.thr > -torch.inf).any())

    def _pack(self, core, who, sub, G: int, rows, raw, idx):
        """The greedy packings of G cores: entries (core, survivor ``who``
        in the best-first order, the core's subset ``sub``) sorted by core
        then survivor; a step reads, for each core still short of m + 1
        members, a window of its next B entries (B = CORE_STEP over the
        cores still packing, at most the most entries a core has) and takes
        up to ACCEPTS members in turn, each the first entry past the last
        one taken whose part outside the core misses its used indices (the
        one-at-a-time greedy's members, as a later entry is checked against
        the indices of those taken before it); where none is left the
        window is passed.  One read by the host a step (the cores still
        packing).  Returns (G,) thresholds (-inf short of m + 1), tops (the
        first members' raw scores) and reaches."""
        dev, target = core.device, self.m + 1
        ar = torch.arange(G, device=dev)
        ptr = torch.searchsorted(core, ar)
        end = torch.searchsorted(core, ar, right=True)
        most = int((end - ptr).max())
        cnt = torch.zeros(G, dtype=torch.int64, device=dev)
        last = torch.full((G,), -torch.inf, dtype=torch.float32, device=dev)
        top = torch.full((G,), -torch.inf, dtype=torch.float32, device=dev)
        reach = torch.full((G,), -1, dtype=torch.int64, device=dev)
        used = torch.zeros((G, self.n), dtype=torch.bool, device=dev)
        active = torch.nonzero(end > ptr)[:, 0]
        while active.numel():
            A = active.numel()
            B = max(1, min(CORE_STEP // A, most))
            at, start = torch.arange(A, device=dev), ptr[active]
            cols = torch.arange(B, device=dev)
            pos = start[:, None] + cols
            inb = pos < end[active, None]
            pos = torch.where(inb, pos, start[:, None])
            got = who[pos]                                                     # (A, B)
            part = torch.gather(rows[got], -1, self.parts[sub[pos]])           # (A, B, w)
            c, lo, hi, re = cnt[active], last[active], top[active], reach[active]
            left, nxt = inb, start + B          # the window's entries not yet passed
            for _ in range(ACCEPTS):
                free = left & ~used[active[:, None, None], part].any(-1)
                has = free.any(1) & (c < target)
                first = free.to(torch.uint8).argmax(1)
                took = (active[:, None], part[at, first])      # a core's own cells, once each
                used[took] = used[took] | has[:, None]
                g = got[at, first]
                hi = torch.where(has & (c == 0), raw[g], hi)
                lo = torch.where(has, raw[g], lo)
                re = torch.where(has, torch.maximum(re, idx[g]), re)
                c = c + has
                nxt = torch.where(has, start + first + 1, start + B)
                left = left & (cols > first[:, None]) & has[:, None]
            cnt[active], last[active], top[active], reach[active], ptr[active] = c, lo, hi, re, nxt
            active = active[(cnt[active] < target) & (ptr[active] < end[active])]
        full = cnt == target
        return (torch.where(full, last, -torch.inf), torch.where(full, top, -torch.inf),
                torch.where(full, reach, -1))


class StreamedTopk:
    """``diverse_topk(scores, table, S, alpha)`` (alpha > 0; at alpha <= 0
    ``masked_topk(scores, S)``, as ``select_and_generate`` chooses) over a
    table that comes a piece at a time in increasing row order (``add``),
    never holding the whole score vector; ``result`` gives the same picks,
    bit for bit, with global indices, and the picked rows.  A row that
    cannot be picked is dropped by three rules, each exact.

    The threshold (alpha > 0): each pick adds at most kk index matches to a
    candidate's penalty (a row's indices are distinct), so before pick
    j <= S a candidate's penalty is at most P = kk (S - 1).  Of the S
    largest raw scores (the S-th is s_S) one is still unpicked at pick j,
    and its effective score fl(raw - fl(alpha pen)) is at least tau =
    fl(s_S - fl(alpha P)), rounding being monotone; so every pick p has
    raw(p) >= eff(p) >= tau, computed in float32 as the greedy computes
    eff.  The running top S raw values only rise, and tau with them: each
    piece's rows with raw >= tau are kept (finite ones only: where fewer
    than S scores are finite tau is -inf), and the earlier survivors are
    pruned to the new tau.

    Dominance (the lemma; at alpha > 0 and group 1, where ``n``, the
    table's, is required).
    Let m = kk (S - 1).  Before pick j <= S the earlier (finite) picks have
    touched at most m distinct indices.  Take a row r and m + 1 rows q with
    raw(q) >= raw(r) whose parts outside r (q \\ r) are pairwise disjoint,
    each either of lower global index or above r by the margin below.  At
    most m of those parts hold a touched index, so some q has q \\ r
    untouched: its penalty, the counts summed over q, is the counts over
    q & r, at most r's, and q is unpicked (a pick touches its own indices,
    and q \\ r is not empty as q != r).  Rounding being monotone,
    eff(q) >= fl(raw(q) - A) >= fl(raw(r) - A) = eff(r), A = fl(alpha
    pen(r)) <= fl(alpha P); where q's index is lower, argmax takes the
    first of equal values; where raw(q) - raw(r) > MARGIN (|raw(q)| +
    |raw(r)| + 2 fl(alpha P)) + TINY (2^-22 and 2^-126, against the 2^-24
    relative and 2^-150 absolute errors that one rounding of each side
    can make), eff(q) > eff(r).  Either way r is not pick j.  Dropping
    every such r leaves each pick of the whole table among the survivors,
    with the same effective scores (the penalties follow the same picks),
    and the greedy over the survivors in increasing global index picks
    what the whole table's does, pick by pick.  Two instances of the lemma
    are used:

    - the floor (pieces of ``combinations_table(n, kk)``'s rows from its
      first, in its order: the global index is the lexicographic rank
      shifted by the first piece's offset; the rule is off for good if the
      first row is not 0, 1, .., kk - 1 or a piece does not start where the
      last ended).  Replacing an index of r
      by a smaller one not in r gives a row of lower rank, so r's faces
      r - max(r) + x, x < max(r), x not in r, are max(r) - (kk - 1) rows of
      lower index whose parts outside r, {x}, are distinct.  If raw(r) is
      at most the least score of every row of lower index (the running
      minimum, -inf rows included) and max(r) >= m + kk, r is dropped.  A
      class tied at the least score (all scores 0; neural's scale relu(MLP)
      and optimality's improvement where fewer than S rows improve) keeps
      only the rows with every index below m + kk: C(m + kk, kk) at most,
      34,220 at kk = 3, 1,581,580 at 4 and 75,287,520 at 5 (S = 20),
      whatever n.
    - the packings (``choose_cores``): for a core C of c indices (c = 0,
      the empty core, or more), m + 1 survivors that contain C and whose
      parts outside C are pairwise disjoint (so are their parts outside any
      r that holds C), taken greedily in decreasing raw score (ties by
      increasing index).  A packing's threshold is its least raw score, its
      top its greatest and its reach its greatest index: r is dropped
      where, for a core of r's, raw(r) <= the threshold and r's index is
      past the reach, or raw(r) lies below the threshold by the margin
      (whatever the indices: so a packing drops earlier survivors too).
      The packings are built from the survivors (at most CORE_SURVIVORS
      of the best) only once REBUILD_MIN rows (2^18, a 1,024th of the cap;
      REBUILD_MIN_WIDE, 2^24, where a packing has more than n cores, whose
      rebuild reads many more entries) have been kept, so a round whose
      band stays below that (neural's, a tie the floor bounds) never builds
      one, and then rebuilt each time as many rows again have been kept as
      were held at the last rebuild (an eighth of them where every packing
      has at most n cores), never fewer than that first count; a core
      keeps its best threshold, and the survivors are pruned by them.  In
      the table's
      order m + 1 rows are disjoint only once m + 1 first indices have
      passed, and a core is packed from the rows of its own first index
      onward; the margin lets a packing made later drop the rows that came
      before it.  Uniform scores (random's) keep about the rows ranked
      above the greedy's (m + 1)-th member in one of their cores: at kk = 3
      (c = 0 and 1) about the best m + 1 = 58 rows of all, at kk = 5,
      n = 330 (c = 2) the rows above the 3,495-th of the C(328, 3) of a
      pair (6e-4), against tau's band of alpha P = 9.5e-3.  A tie that is
      neither the floor nor packed (at most m + 1 disjoint rows below it) is
      bounded by nothing but the cap.

    Every temporary stays within a piece's size: the floor's running
    minimum reads FLOOR_ROWS scores a step, the packings' thresholds
    CORE_ROWS rows a step, a rebuild its survivors' cores (at most
    CORE_SURVIVORS times C(kk, c) int32), a group at most CORE_ENTRIES
    (core, part) entries (one core's more) and CORE_FLAGS used-index
    flags, and a step of its greedy CORE_STEP entries.

    ``result`` runs ``diverse_topk`` itself over the survivors in
    increasing global index; a -inf pick is global row 0 (and the table's
    row 0, 0..kk-1), as torch.argmax gives it there.  At alpha <= 0 the
    survivors are the running top S by (score, lower index), which
    ``masked_topk``'s stable sort picks alike.  Scores are float32 without
    NaN (a NaN raises).  ``most`` is the largest number of survivors held,
    ``rebuilds`` the packings' rebuilds.
    ``group``: the flat candidates a row carries (scores g r .. g r + g - 1
    are row r's, global indices g times the row's); the picks' global
    indices are flat ones, as ``masked_topk(scores.reshape(-1), S)`` gives
    them on the whole (T, g) table (int64 past 2^31).  Past SURVIVOR_CAP
    survivors ``add`` raises rather than change a pick."""

    def __init__(self, S: int, alpha: float, kk: int, device, group: int = 1,
                 n: int | None = None):
        self.prune = alpha > 0.0 and group == 1
        if self.prune and n is None:
            raise ValueError("StreamedTopk at alpha > 0 takes the table's n")
        self.S, self.alpha, self.kk, self.group = S, alpha, kk, group
        self.device = torch.device(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.top = torch.empty(0, **f32)                 # the running top S raw values
        self.vals = torch.empty(0, **f32)                # the survivors, in global order
        self.idx = torch.empty(0, dtype=torch.int64, device=self.device)
        self.rows = torch.empty((0, kk), dtype=torch.int32, device=self.device)
        self.pmax = torch.full((1,), kk * (S - 1), **f32)  # P, the largest penalty
        self.most = 0
        self.m = kk * (S - 1)
        self.floor = self.prune          # the floor rule holds while the pieces run on
        self.next = None                 # the global index the next piece starts at
        self.low = torch.full((1,), torch.inf, **f32)    # the least score seen
        amax = float(torch.mul(self.pmax, alpha)) if self.prune else 0.0
        self.packs = [_Packings(c, n, kk, self.m, amax, self.device)
                      for c in (choose_cores(n, kk, S) if self.prune else ())]
        # rebuilt each time as many rows have been kept as were held at the
        # last rebuild, an eighth as many where every packing has at most n cores
        self.shift = 3 if all(p.ncores <= n for p in self.packs) else 0
        self.first = REBUILD_MIN if self.shift else REBUILD_MIN_WIDE
        self.since = self.held = 0       # rows kept since the last rebuild; held at it
        self.rebuilds = 0

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
        if self.prune:
            floor = self._floor(scores, rows, offset, tau)
            if floor is not None:
                keep &= ~floor
            self._keep_dominance(scores, rows, torch.nonzero(keep)[:, 0], offset, tau)
            return
        at = torch.nonzero(keep)[:, 0]
        vals, idx, rows_ = self._append(scores[at], at + offset, rows[at // g], tau)
        if self.alpha <= 0.0:          # the running top S by (score, lower index)
            best = torch.sort(torch.sort(-vals, stable=True).indices[:self.S]).values
            vals, idx, rows_ = vals[best], idx[best], rows_[best]
        self.vals, self.idx, self.rows = vals, idx, rows_

    def _append(self, vals, idx, rows, tau):
        """The survivors with (vals, idx, rows) after them, counted against
        the cap."""
        vals = torch.cat([self.vals, vals])
        idx = torch.cat([self.idx, idx])
        rows = torch.cat([self.rows, rows])
        self.most = max(self.most, vals.numel())
        if vals.numel() > SURVIVOR_CAP:
            raise RuntimeError(f"StreamedTopk: {vals.numel()} survivors pass the cap of "
                               f"{SURVIVOR_CAP} (the threshold {float(tau)!r}: fewer than "
                               f"{self.S} scores lie above alpha P, and no dominance rule "
                               f"drops the rest)")
        return vals, idx, rows

    def _floor(self, scores, rows, offset: int, tau):
        """(T,) bool: the piece's rows that the floor rule drops (None where
        it cannot drop one of those at or above tau)."""
        if self.next is None:           # the first rows must be the table's first
            if not scores.numel():
                return None
            self.floor = bool((rows[0] == torch.arange(self.kk, device=rows.device)).all())
        elif offset != self.next:
            self.floor = False
        self.next = offset + scores.shape[0]
        low = self.low
        if scores.numel():
            self.low = torch.minimum(low, scores.min().reshape(1))
        if not self.floor or not scores.numel() or not bool(low >= tau):
            return None                 # every row at or above tau scores above the least
        big = rows[:, -1] >= self.m + self.kk
        if bool(self.low >= low):       # no score below the least before: it is every row's
            return (scores <= low) & big
        drop = torch.empty(scores.shape, dtype=torch.bool, device=scores.device)
        carry = low
        for s in range(0, scores.shape[0], FLOOR_ROWS):
            part = scores[s:s + FLOOR_ROWS]
            before = torch.minimum(torch.cat([carry, torch.cummin(part, 0).values[:-1]]), carry)
            drop[s:s + FLOOR_ROWS] = (part <= before) & big[s:s + FLOOR_ROWS]
            carry = torch.minimum(carry, before[-1:]).minimum(part[-1:])
        return drop

    def _keep_dominance(self, scores, rows, at, offset: int, tau):
        """Keep the piece's rows ``at`` (local, increasing) that no packing
        drops, in runs of as many rows as the next rebuild is due after
        (so the survivors pass the due count by less than one run)."""
        step = 0
        while step < at.numel():
            due = max(self.first, self.held >> self.shift)
            take = due if self.packs else at.numel()
            run = at[step:step + take]
            step += take
            vals, idx, rws = scores[run], run + offset, rows[run]
            kept = ~self._dominated(vals, idx, rws)
            self.vals, self.idx, self.rows = self._append(vals[kept], idx[kept], rws[kept], tau)
            self.since += int(kept.sum())
            if self.packs and self.since >= due:
                self._rebuild()

    def _dominated(self, vals, idx, rows) -> torch.Tensor:
        """(R,) bool: the rows (vals, global idx, (R, kk) rows) that a
        packing drops."""
        out = torch.zeros(vals.shape, dtype=torch.bool, device=vals.device)
        built = [p for p in self.packs if p.built]
        for s in range(0, vals.shape[0] if built else 0, CORE_ROWS):
            r = rows[s:s + CORE_ROWS].long()
            for p in built:
                out[s:s + CORE_ROWS] |= p.dominated(vals[s:s + CORE_ROWS], idx[s:s + CORE_ROWS], r)
        return out

    def _rebuild(self):
        """Every packing anew from the best CORE_SURVIVORS survivors (by
        decreasing raw score, ties by increasing index), then the survivors
        pruned by them."""
        self.since = 0
        self.rebuilds += 1
        order = torch.sort(-self.vals, stable=True).indices[:CORE_SURVIVORS]
        rows, raw, idx = self.rows[order].long(), self.vals[order], self.idx[order]
        for p in self.packs:
            p.rebuild(rows, raw, idx)
        del rows, raw, idx, order
        kept = ~self._dominated(self.vals, self.idx, self.rows)
        self.vals, self.idx, self.rows = self.vals[kept], self.idx[kept], self.rows[kept]
        self.held = self.vals.numel()

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
