"""Candidate subset enumeration (port of ``sdpcutsel_tpu/cuts/enumerate.py``).

The candidate set is the static table of all C(n, k) sorted index subsets in
lexicographic order.  ``combinations_table`` builds it once per (n, k) on the
host and caches it (at n = 125, k = 3 a (317750, 3) int32 table, ~3.8 MB),
for the tests and the host callers; ``combinations_table_on`` writes the
same rows straight into a tensor on a device, with no host copy and no
cache (at n = 2048, k = 3 the table takes 17.2 GB).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def combinations_table(n: int, k: int) -> np.ndarray:
    """All C(n, k) sorted index subsets as a (C, k) int32 array, in
    lexicographic order.  Callers must not write to the cached array."""
    if k == 1:
        return np.arange(n, dtype=np.int32)[:, None]
    blocks = []
    for i in range(n - k + 1):
        rest = combinations_table(n - i - 1, k - 1) + np.int32(i + 1)
        first = np.full((rest.shape[0], 1), i, dtype=np.int32)
        blocks.append(np.concatenate([first, rest], axis=1))
    return np.concatenate(blocks, axis=0)


def combinations_table_on(n: int, k: int, device) -> torch.Tensor:
    """``combinations_table(n, k)``'s rows, in its order, as a (C(n, k), k)
    int32 tensor written on ``device``, by first index: the rows that start
    with i are i beside the last C(n - i - 1, k - 1) rows of the table of
    width k - 1 over the same n (the subsets of i + 1 .. n - 1 come last in
    lexicographic order), and the table of width 2 is ``torch.triu_indices``'
    row-major pairs."""
    if not 1 <= k <= n:
        raise ValueError(f"combinations_table_on takes 1 <= k <= n, got n={n}, k={k}")
    if k == 1:
        return torch.arange(n, dtype=torch.int32, device=device)[:, None]
    if k == 2:
        return torch.triu_indices(n, n, 1, device=device).to(torch.int32).T.contiguous()
    sub = combinations_table_on(n, k - 1, device)
    out = torch.empty((math.comb(n, k), k), dtype=torch.int32, device=device)
    s = 0
    for i in range(n - k + 1):
        rows = math.comb(n - i - 1, k - 1)
        out[s:s + rows, 0] = i
        out[s:s + rows, 1:] = sub[sub.shape[0] - rows:]
        s += rows
    return out
