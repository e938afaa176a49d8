"""Re-run one (instance, strategy) suite cell and append a fresh record,
even if one is already there (port of ``scripts/rerun_cell.py``): refreshes
a cell with per-round wall times; the summaries take the LAST record per
(instance, strategy, k).  On the card unless ``--cpu``; records go to
``results/suite_torch.jsonl`` by default.

    python3 -m sdpcutsel_tpu_torch.rerun_cell spar125-100-1 neural --rounds 10 --sel-size 50
"""

from __future__ import annotations

import argparse

import torch

from .bench.suite import instance_gap_closed
from .config import CutConfig, LoopConfig, LPConfig, RunConfig, ScorerConfig
from .utils.logging import JSONLLogger


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sdpcutsel_tpu_torch.rerun_cell")
    ap.add_argument("instance")
    ap.add_argument("strategy")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--sel-size", type=int, default=50)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--lp-max-iters", type=int, default=20000)
    ap.add_argument("--polish-iters", type=int, default=60000)
    ap.add_argument("--data-dir", default="data/boxqp")
    ap.add_argument("--out", default="results/suite_torch.jsonl")
    ap.add_argument("--use-scan", action="store_true",
                    help="all rounds in one call (LoopConfig.use_scan)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    cfg = RunConfig(
        lp=LPConfig(max_iters=args.lp_max_iters),
        cuts=CutConfig(k=args.k, sel_size=args.sel_size),
        scorer=ScorerConfig(strategy=args.strategy),
        loop=LoopConfig(rounds=args.rounds, polish_iters=args.polish_iters,
                        use_scan=args.use_scan))
    with JSONLLogger(args.out) as logger:
        rec = instance_gap_closed(args.instance, cfg, args.data_dir, rounds=args.rounds,
                                  logger=logger,
                                  device=torch.device("cpu" if args.cpu else "cuda"))
    print(f"[rerun] {args.instance} {args.strategy}: "
          f"final_gap_closed={rec['final_gap_closed']:.3f} t={rec['wall_time_s']:.0f}s "
          f"rounds/s={rec['rounds_run'] / sum(rec['round_times_s']):.3f} ({rec['platform']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
