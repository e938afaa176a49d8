"""The kernel wrappers' launch counters, read and reset under one set of
names: each wrapper adds one to its ``launches`` where it launches its
kernel; the solve's plain PDHG blocks on the card and the scoring twins
called on the card (``use_fused=False``) are counted beside them and stay 0
on a main path.  ``chip_smoke.py`` and every rank of ``run_multihost`` and
``multichip_dryrun`` report these counts."""

from __future__ import annotations

from ..lp.pdhg_kernel import pdhg_block
from .fused_score import fused_score
from .pair_packed import packed_score
from .pair_score import pair_score

WRAPPERS = {"pair_score": pair_score, "pair_packed": packed_score,
            "pdhg_block": pdhg_block, "fused_score": fused_score}
PLAIN_BLOCKS = "pdhg_block plain"     # the solve's plain PDHG blocks on the card
TWIN_SCORED = "twin-scored"           # scoring twins called on the card


def launch_counts() -> dict:
    return {**{name: fn.launches for name, fn in WRAPPERS.items()},
            PLAIN_BLOCKS: pdhg_block.plain_launches,
            TWIN_SCORED: pair_score.plain_launches + fused_score.plain_launches}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    pdhg_block.plain_launches = pair_score.plain_launches = fused_score.plain_launches = 0
