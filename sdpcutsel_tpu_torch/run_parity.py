"""BoxQP parity of the port against the CPU replica's recorded cells (port
of ``scripts/run_parity.py``).

The replica (``sdpcutsel_tpu/baseline/``, numpy + HiGHS) cannot be imported
without JAX, so this runner does not run it.  For each instance it runs the
port's cell as the reference's ``--tpu-rerun`` does (a fresh solve of
``--rounds`` rounds with the final polish, on the card unless ``--cpu``) and
pairs it with the replica's latest recorded row in ``--replica`` (default
``results/parity.jsonl``) with the same instance, strategy, k, rounds,
sel_size, diversity (the port side's ``tpu_diversity_alpha`` and the
replica's ``cpu_diversity_alpha``) and purge (``tpu_purge``).  The appended
row has the keys ``scripts/summarize_parity.py`` reads, as a rerun row of
the reference, plus ``platform``; rows go to ``results/parity_torch.jsonl``
by default.  A cell already in ``--out`` is skipped unless ``--redo``.

    python3 -m sdpcutsel_tpu_torch.run_parity --instances spar020-50-1,spar030-100-1
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .bench.suite import bounds_registry, instance_gap_closed
from .config import CutConfig, LoopConfig, RunConfig, ScorerConfig
from .utils.logging import read_records


def replica_row(rows, name: str, args):
    """The latest recorded replica row of this cell, or None."""
    found = None
    for r in rows:
        if (r.get("instance") == name and r.get("strategy") == args.strategy
                and r.get("k", 3) == args.k and r.get("rounds") == args.rounds
                and r.get("sel_size") == args.sel_size
                and float(r.get("tpu_diversity_alpha", 0.0)) == args.diversity_alpha
                and float(r.get("cpu_diversity_alpha", 0.0)) == args.replica_diversity_alpha
                and r.get("tpu_purge", True) == (not args.no_purge)
                and r.get("cpu_final_gap_closed") is not None):
            found = r
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sdpcutsel_tpu_torch.run_parity")
    ap.add_argument("--instances", required=True, help="comma list")
    ap.add_argument("--strategy", default="feasibility")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--sel-size", type=int, default=20)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--data-dir", default="data/boxqp")
    ap.add_argument("--replica", default="results/parity.jsonl",
                    help="the replica's recorded rows (scripts/run_parity.py's output)")
    ap.add_argument("--out", default="results/parity_torch.jsonl")
    ap.add_argument("--polish-iters", type=int, default=60_000,
                    help="final-polish LP iteration budget")
    ap.add_argument("--diversity-alpha", type=float, default=0.0,
                    help="support-diverse selection penalty of the port's solve")
    ap.add_argument("--replica-diversity-alpha", type=float, default=0.0,
                    help="the replica row's own diversity (cpu_diversity_alpha) to pair with")
    ap.add_argument("--no-purge", action="store_true",
                    help="no slack-cut purging in the port's solve (as the replica)")
    ap.add_argument("--redo", action="store_true", help="re-run cells already in --out")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")

    reg = bounds_registry(os.path.join(args.data_dir, "bounds.json"))
    replica = read_records(args.replica)
    done = {(r["instance"], r["strategy"], r.get("k", 3), float(r.get("tpu_diversity_alpha", 0.0)),
             float(r.get("cpu_diversity_alpha", 0.0)), r.get("tpu_purge", True))
            for r in read_records(args.out) if "instance" in r and "strategy" in r}
    for name in args.instances.split(","):
        if (name, args.strategy, args.k, args.diversity_alpha, args.replica_diversity_alpha,
                not args.no_purge) in done and not args.redo:
            print(f"[parity] {name}: already done", flush=True)
            continue
        if name not in reg:
            print(f"[parity] {name}: no SDP bound in registry, skipping", flush=True)
            continue
        rep = replica_row(replica, name, args)
        if rep is None:
            print(f"[parity] {name}: no recorded replica row to pair with, skipping", flush=True)
            continue
        cfg = RunConfig(
            cuts=CutConfig(k=args.k, sel_size=args.sel_size, purge=not args.no_purge,
                           diversity_alpha=args.diversity_alpha),
            scorer=ScorerConfig(strategy=args.strategy),
            loop=LoopConfig(rounds=args.rounds, polish_iters=args.polish_iters))
        cell = instance_gap_closed(name, cfg, args.data_dir, rounds=args.rounds, device=device)
        cpu_final, port_final = rep["cpu_final_gap_closed"], cell["final_gap_closed"]
        rec = {
            "instance": name, "strategy": args.strategy, "k": args.k, "rounds": args.rounds,
            "sel_size": args.sel_size,
            "cpu_final_gap_closed": cpu_final,
            "cpu_gap_closed": rep.get("cpu_gap_closed"),
            "tpu_final_gap_closed": port_final,
            "ratio_tpu_over_cpu": port_final / cpu_final if cpu_final > 0 else None,
            "cpu_wall_time_s": rep.get("cpu_wall_time_s"),
            "cpu_diversity_alpha": args.replica_diversity_alpha,
            "cpu_from_recorded_row": True,
            "tpu_rerun": True,
            "tpu_backend": device.type,
            "tpu_diversity_alpha": args.diversity_alpha,
            "tpu_polish_iters": args.polish_iters,
            "tpu_purge": not args.no_purge,
            "tpu_gap_closed": cell["gap_closed"],
            "tpu_wall_time_s": cell["wall_time_s"],
            "platform": device.type,
            "ts": time.time(),
        }
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"[parity] {name}: replica={cpu_final:.3f} port={port_final:.3f} "
              f"({device.type}) t={cell['wall_time_s']:.0f}s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
