"""The kernel wrappers' launch counters, read and reset under one set of
names: each wrapper adds one to its ``launches`` where it launches its
kernel (the dense route's, ``lp/pdhg_dense.py``, and the grid route's,
``lp/pdhg_grid.py``, among them: a checked launch counts under "pdhg_dense"
and "pdhg_dense_check", or "pdhg_grid" and "pdhg_grid_check", as K2's
checked launch counts under "pdhg_block" and "pdhg_check"; the dense
route's launches past n = 256 count under the grid route's names); the
solve's plain PDHG blocks on the card, its twin checks and norms there, and
the scoring twins called on the card (``use_fused=False``) are counted
beside them and stay 0 on a main path; so are the solve loop's reads of its
control record (``lp/pdhg.py::read_record``, one a group of blocks) and the
solves themselves.  ``chip_smoke.py`` and every rank of ``run_multihost``
and ``multichip_dryrun`` report these counts."""

from __future__ import annotations

from ..lp.pdhg import SOLVE_COUNTS
from ..lp.pdhg_check import pdhg_block_checked
from ..lp.pdhg_dense import pdhg_dense_block, pdhg_dense_block_checked, pdhg_dense_norm
from ..lp.pdhg_grid import pdhg_grid_block, pdhg_grid_block_checked, pdhg_grid_norm
from ..lp.pdhg_kernel import pdhg_block
from ..lp.pdhg_norm import pdhg_norm
from .fused_score import fused_score
from .pair_packed import packed_score
from .pair_score import pair_score

WRAPPERS = {"pair_score": pair_score, "pair_packed": packed_score,
            "pdhg_block": pdhg_block, "fused_score": fused_score,
            "pdhg_check": pdhg_block_checked, "pdhg_norm": pdhg_norm,
            "pdhg_dense": pdhg_dense_block, "pdhg_dense_check": pdhg_dense_block_checked,
            "pdhg_dense_norm": pdhg_dense_norm, "pdhg_grid": pdhg_grid_block,
            "pdhg_grid_check": pdhg_grid_block_checked, "pdhg_grid_norm": pdhg_grid_norm}
PLAIN_BLOCKS = "pdhg_block plain"     # the solve's plain PDHG blocks on the card
PLAIN_CONTROL = "check/norm plain"    # the solve's twin checks and norms on the card
TWIN_SCORED = "twin-scored"           # scoring twins called on the card
READS = "solve reads"                 # the solve loop's reads of its control record
SOLVES = "solves"                     # the solve loops run


def launch_counts() -> dict:
    return {**{name: fn.launches for name, fn in WRAPPERS.items()},
            PLAIN_BLOCKS: pdhg_block.plain_launches,
            PLAIN_CONTROL: pdhg_block_checked.plain_launches + pdhg_norm.plain_launches,
            TWIN_SCORED: pair_score.plain_launches + fused_score.plain_launches,
            READS: SOLVE_COUNTS["reads"], SOLVES: SOLVE_COUNTS["solves"]}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    for fn in (pdhg_block, pdhg_block_checked, pdhg_norm, pair_score, fused_score):
        fn.plain_launches = 0
    SOLVE_COUNTS.update(reads=0, solves=0)
