"""Candidate subset enumeration (port of ``sdpcutsel_tpu/cuts/enumerate.py``).

The candidate set is the static table of all C(n, k) sorted index subsets in
lexicographic order, built once per (n, k) on the host.  At n = 125, k = 3 it
is a (317750, 3) int32 table (~3.8 MB).
"""

from __future__ import annotations

import functools

import numpy as np


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
