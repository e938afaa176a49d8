"""Chordal decomposition of the QCQP sparsity graph and the clique candidate
table (port of the Python path of ``sdpcutsel_tpu/qcqp/chordal.py``).

  1. Maximum Cardinality Search gives an elimination order (perfect if the
     graph is already chordal).
  2. Fill-in along that order yields a chordal extension.
  3. The maximal cliques of the chordal graph are read off the elimination
     (v and its higher neighbours, keeping only maximal sets).
  4. The candidate supports are all size 2..kmax subsets of the cliques,
     deduplicated and padded to width kmax.

One-time host preprocessing in plain Python; the reference's native path
gives the same cliques.
"""

from __future__ import annotations

import itertools

import numpy as np


def _mcs_order(n: int, adj: list[set]) -> list[int]:
    """Maximum cardinality search; returns the elimination order (reversed MCS)."""
    weight = [0] * n
    visited = [False] * n
    order = []
    for _ in range(n):
        v = max((w, -i, i) for i, w in enumerate(weight) if not visited[i])[2]
        visited[v] = True
        order.append(v)
        for u in adj[v]:
            if not visited[u]:
                weight[u] += 1
    return order[::-1]


def chordal_decomposition(n: int, edges):
    """edges: iterable of (i, j) pairs.  Returns (cliques, nfill): the
    maximal cliques of the chordal extension as sorted tuples, and the
    number of fill-in edges added."""
    adj = [set() for _ in range(n)]
    for i, j in edges:
        if i != j:
            adj[i].add(j)
            adj[j].add(i)
    order = _mcs_order(n, adj)
    pos = {v: idx for idx, v in enumerate(order)}

    nfill = 0
    cliques = []
    for idx, v in enumerate(order):
        higher = {u for u in adj[v] if pos[u] > idx}
        cliques.append(tuple(sorted([v] + list(higher))))
        for a, b in itertools.combinations(sorted(higher), 2):   # fill-in
            if b not in adj[a]:
                adj[a].add(b)
                adj[b].add(a)
                nfill += 1

    cliques.sort(key=len, reverse=True)
    maximal, seen = [], []
    for c in cliques:
        fs = frozenset(c)
        if not any(fs <= s for s in seen):
            maximal.append(tuple(sorted(c)))
            seen.append(fs)
    return maximal, nfill


def clique_candidates(cliques, kmax: int) -> np.ndarray:
    """All distinct index subsets of size 2..kmax inside the cliques, padded
    to width kmax by repeating the last index, as an int32 (C, kmax) table
    in lexicographic order."""
    subs = set()
    for c in cliques:
        for k in range(2, min(kmax, len(c)) + 1):
            subs.update(itertools.combinations(c, k))
    rows = [list(s) + [s[-1]] * (kmax - len(s)) for s in sorted(subs)]
    if not rows:
        return np.zeros((0, kmax), dtype=np.int32)
    return np.asarray(rows, dtype=np.int32)
