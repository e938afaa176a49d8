"""Candidate subset enumeration (port of ``sdpcutsel_tpu/cuts/enumerate.py``).

The candidate set is the static table of all C(n, k) sorted index subsets in
lexicographic order.  ``combinations_table`` builds it once per (n, k) on the
host and caches it (at n = 125, k = 3 a (317750, 3) int32 table, ~3.8 MB),
for the tests and the host callers; ``combinations_table_on`` writes the
same rows straight into a tensor on a device, with no host copy and no
cache (at n = 2048, k = 3 the table takes 17.2 GB).  Past what a card
holds (137 GB at n = 4096), ``first_index_pieces`` cuts the table into
pieces of whole first indices and ``combinations_rows_on`` writes one
piece's rows, in the table's order, with their global row offset;
``range_pieces`` cuts it into pieces of a fixed number of rows and
``combinations_range_on`` writes any run of its rows, at k >= 4 from the
pair table alone (``combinations_table_on(n, 3)`` is already 2.1 GB at
n = 1024, the table of width 4 45 GB at n = 512).
"""

from __future__ import annotations

import bisect
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


def first_index_pieces(n: int, k: int, max_rows: int) -> list[tuple[int, int, int, int]]:
    """``combinations_table(n, k)`` cut by first index into pieces of at
    most ``max_rows`` rows (a piece holds at least one first index, however
    many rows that has): (i0, i1, offset, rows) each, the piece the rows
    whose first index lies in [i0, i1), ``offset`` the global index of its
    first row, in the table's order."""
    if not 1 <= k <= n or max_rows < 1:
        raise ValueError(f"first_index_pieces takes 1 <= k <= n and max_rows >= 1, got n={n}, "
                         f"k={k}, max_rows={max_rows}")
    pieces, i0, offset, rows = [], 0, 0, 0
    for i in range(n - k + 1):
        r = math.comb(n - i - 1, k - 1)          # the rows whose first index is i
        if rows and rows + r > max_rows:
            pieces.append((i0, i, offset, rows))
            i0, offset, rows = i, offset + rows, 0
        rows += r
    pieces.append((i0, n - k + 1, offset, rows))
    return pieces


def combinations_rows_on(n: int, k: int, i0: int, i1: int, device,
                         sub: torch.Tensor | None = None) -> torch.Tensor:
    """The rows of ``combinations_table(n, k)`` whose first index lies in
    [i0, i1), in its order, as an int32 tensor written on ``device``: the
    rows that start with i are i beside the last C(n - i - 1, k - 1) rows
    of the table of width k - 1 over the same n (``sub``, that table on
    ``device``, or made here).  They start at global row C(n, k) -
    C(n - i0, k)."""
    if not 2 <= k <= n or not 0 <= i0 <= i1 <= n - k + 1:
        raise ValueError(f"combinations_rows_on takes 2 <= k <= n and 0 <= i0 <= i1 <= n - k + 1, "
                         f"got n={n}, k={k}, i0={i0}, i1={i1}")
    if sub is None:
        sub = combinations_table_on(n, k - 1, device)
    total = sum(math.comb(n - i - 1, k - 1) for i in range(i0, i1))
    out = torch.empty((total, k), dtype=torch.int32, device=device)
    s = 0
    for i in range(i0, i1):
        rows = math.comb(n - i - 1, k - 1)
        out[s:s + rows, 0] = i
        out[s:s + rows, 1:] = sub[sub.shape[0] - rows:]
        s += rows
    return out


def range_pieces(n: int, k: int, rows: int) -> list[tuple[int, int, int, int]]:
    """``combinations_table(n, k)`` cut into runs of ``rows`` rows (the last
    one shorter), as ``first_index_pieces`` gives them: (i0, i1, offset,
    count), the run the rows [offset, offset + count), i0 .. i1 - 1 the
    first indices it touches.  Each offset is a multiple of ``rows``."""
    if not 1 <= k <= n or rows < 1:
        raise ValueError(f"range_pieces takes 1 <= k <= n and rows >= 1, got n={n}, k={k}, "
                         f"rows={rows}")
    total = math.comb(n, k)
    return [(_first_index(n, k, s), _first_index(n, k, min(s + rows, total) - 1) + 1, s,
             min(rows, total - s)) for s in range(0, total, rows)]


def _first_index(n: int, k: int, row: int) -> int:
    """The first index of ``combinations_table(n, k)``'s row ``row``: the
    largest i whose rows start at C(n, k) - C(n - i, k) <= row."""
    total = math.comb(n, k)
    return bisect.bisect_right(range(n - k + 1), row,
                               key=lambda i: total - math.comb(n - i, k)) - 1


def _level_shifts(n: int, j: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The rule of one level, as two (n - j + 1,) int64 tensors on
    ``device``: ``firsts[i]`` = C(n, j) - C(n - i, j), the global row of the
    first row of the table of width j that starts with i, and ``shift[i]``,
    what takes a row r that starts with i to the row of the table of width
    j - 1 beside which it is written (C(n, j - 1) - C(n - i - 1, j - 1) -
    firsts[i]: the rows that start with i are i beside the last
    C(n - i - 1, j - 1) rows of that table)."""
    firsts = [math.comb(n, j) - math.comb(n - i, j) for i in range(n - j + 1)]
    shift = [math.comb(n, j - 1) - math.comb(n - i - 1, j - 1) - f for i, f in enumerate(firsts)]
    return (torch.tensor(firsts, dtype=torch.int64, device=device),
            torch.tensor(shift, dtype=torch.int64, device=device))


def combinations_range_on(n: int, k: int, start: int, stop: int, device,
                          sub: torch.Tensor | None = None) -> torch.Tensor:
    """Rows [start, stop) of ``combinations_table(n, k)``, in its order, as
    an int32 tensor written on ``device`` from ``sub``, the table of some
    width w < k over the same n on ``device`` (by default the pair table,
    made here).  Where w = k - 1 (the pair table at k = 3) the run is
    written by first index, as ``combinations_rows_on`` writes whole first
    indices, whose rows these are where the run holds whole ones.  Above
    that, the table's rule is applied to every row of the run at once, one
    level a column: row r of the table of width j starts with the largest
    i whose rows start at or before r (``torch.searchsorted`` over the
    n - j + 1 starts), and goes on with a row of the table of width j - 1
    (``_level_shifts``), down to width w, whose rows ``sub`` gives.  All
    in int64, exact: no tensor of a wider table than the run is made."""
    if not 2 <= k <= n or not 0 <= start <= stop <= math.comb(n, k):
        raise ValueError(f"combinations_range_on takes 2 <= k <= n and 0 <= start <= stop <= "
                         f"C(n, k), got n={n}, k={k}, start={start}, stop={stop}")
    if math.comb(n, k) >= 2 ** 63:
        raise ValueError(f"combinations_range_on: C({n}, {k}) rows leave int64")
    if sub is None:
        sub = combinations_table_on(n, min(2, k - 1), device)
    w = sub.shape[1]
    if not 1 <= w < k or sub.shape[0] != math.comb(n, w):
        raise ValueError(f"combinations_range_on takes the table of a width w < k = {k} over "
                         f"n = {n}, got {tuple(sub.shape)}")
    out = torch.empty((stop - start, k), dtype=torch.int32, device=device)
    if w < k - 1:
        r = torch.arange(start, stop, dtype=torch.int64, device=device)
        for j in range(k, w, -1):                    # column k - j
            firsts, shift = _level_shifts(n, j, device)
            i = torch.searchsorted(firsts, r, right=True) - 1
            out[:, k - j] = i
            r += shift[i]
            del i
        out[:, k - w:] = sub[r]
        return out
    total, s = math.comb(n, k), start
    i = _first_index(n, k, start) if start < stop else 0
    while s < stop:
        first = total - math.comb(n - i, k)        # the global row of i's first row
        rows = math.comb(n - i - 1, k - 1)
        a, b = s - first, min(stop - first, rows)
        out[s - start:s - start + b - a, 0] = i
        out[s - start:s - start + b - a, 1:] = sub[sub.shape[0] - rows + a:sub.shape[0] - rows + b]
        s += b - a
        i += 1
    return out
