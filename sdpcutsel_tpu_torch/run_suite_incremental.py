"""Incremental BoxQP suite runner, resumable (port of
``scripts/run_suite_incremental.py``).

Runs (instance x strategy) cells of the benchmark grid on the card (``--cpu``:
the CPU), skipping cells already present in the results JSONL, so repeated
invocations (under a watchdog or a short time limit) make monotonic
progress.  SDP reference bounds are certified once per instance and cached
in the data-dir registry.  Records carry ``platform`` ("cuda" or "cpu") and
go to ``results/suite_torch.jsonl`` by default, never the JAX package's
``results/suite.jsonl``.

    python3 -m sdpcutsel_tpu_torch.run_suite_incremental \\
        --sizes 20,30,40,50 --densities 50,100 --seeds 1 \\
        --strategies neural,feasibility,random --rounds 10
"""

from __future__ import annotations

import argparse

import torch

from .bench.suite import instance_gap_closed
from .config import CutConfig, LoopConfig, LPConfig, RunConfig, ScorerConfig
from .utils.logging import JSONLLogger, read_records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sdpcutsel_tpu_torch.run_suite_incremental")
    ap.add_argument("--sizes", default="20,30,40,50")
    ap.add_argument("--densities", default="50,100")
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--strategies", default="neural,feasibility,random")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--sel-size", type=int, default=20)
    ap.add_argument("--data-dir", default="data/boxqp")
    ap.add_argument("--out", default="results/suite_torch.jsonl")
    ap.add_argument("--lp-max-iters", type=int, default=20000)
    ap.add_argument("--polish-iters", type=int, default=60000,
                    help="final tighter LP re-solve budget (0 = off)")
    ap.add_argument("--sdp-max-rounds", type=int, default=60)
    ap.add_argument("--use-scan", action="store_true",
                    help="all rounds in one call (LoopConfig.use_scan; no per-round early stop)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--redo", action="store_true",
                    help="re-run cells even if already present (appended rows win in "
                         "summarize_suite's last-row-per-cell ingestion)")
    ap.add_argument("--max-cells", type=int, default=0,
                    help="stop after N new cells (0 = unlimited), to exit cleanly inside "
                         "an external time budget")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")

    names = [f"spar{n:03d}-{d}-{s}"
             for n in (int(v) for v in args.sizes.split(","))
             for d in (int(v) for v in args.densities.split(","))
             for s in (int(v) for v in args.seeds.split(","))]
    done = {(r["instance"], r["strategy"], r.get("k", 3))
            for r in read_records(args.out) if "instance" in r}

    with JSONLLogger(args.out) as logger:
        completed = 0
        for name in names:
            for strat in args.strategies.split(","):
                if (name, strat, args.k) in done and not args.redo:
                    continue
                if args.max_cells and completed >= args.max_cells:
                    print(f"[suite] cell budget reached ({completed})", flush=True)
                    return 0
                cfg = RunConfig(
                    lp=LPConfig(max_iters=args.lp_max_iters, tol=2e-6),
                    cuts=CutConfig(k=args.k, sel_size=args.sel_size, capacity=1024),
                    scorer=ScorerConfig(strategy=strat),
                    loop=LoopConfig(polish_iters=args.polish_iters, use_scan=args.use_scan))
                rec = instance_gap_closed(name, cfg, args.data_dir, rounds=args.rounds,
                                          logger=logger, sdp_max_rounds=args.sdp_max_rounds,
                                          device=device)
                completed += 1
                print(f"[suite] {name} {strat}: final_gap_closed={rec['final_gap_closed']:.3f} "
                      f"t={rec['wall_time_s']:.1f}s ({rec['platform']})", flush=True)
    print("[suite] all cells complete", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
