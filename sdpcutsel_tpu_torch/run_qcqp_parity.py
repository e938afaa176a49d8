"""QCQP parity of the port against the CPU replica's recorded cells (port of
``scripts/run_qcqp_parity.py``).

The replica (``sdpcutsel_tpu/baseline/cpu_reference_qcqp.py``) cannot be
imported without JAX, so this runner does not run it.  For each instance
and strategy it runs the port's ``CutSolverQCQP`` in the reference runner's
configuration (purge off, the final polish; on the card unless ``--cpu``)
and pairs it with the replica's latest recorded row in ``--replica``
(default ``results/qcqp_parity.jsonl``) with the same instance, strategy, k,
rounds, sel_size and diversity (``tpu_diversity_alpha``; the reference's QCQP
parity never purges).  Gap closed uses the per-instance (mccormick, sdp)
recorded in ``--suite`` when there, else both sides' improvement over round
0, as the reference does.  The appended row has the reference's keys
(``scripts/summarize_qcqp.py`` reads ``ratio``) plus ``platform``; rows go to
``results/qcqp_parity_torch.jsonl`` by default.

    python3 -m sdpcutsel_tpu_torch.run_qcqp_parity --names qcqp020-25-4-1,qcqp025-25-4-2 \\
        --strategies feasibility,neural --k 4 --rounds 8
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .config import CutConfig, LoopConfig, LPConfig, RunConfig, ScorerConfig
from .instances.qcqp import load_or_generate_qcqp
from .qcqp.solver import CutSolverQCQP
from .utils.logging import read_records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sdpcutsel_tpu_torch.run_qcqp_parity")
    ap.add_argument("--names", required=True, help="comma list of qcqp names")
    ap.add_argument("--strategies", default="feasibility,neural")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--sel-size", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--lp-max-iters", type=int, default=20000)
    ap.add_argument("--polish-iters", type=int, default=60000)
    ap.add_argument("--replica", default="results/qcqp_parity.jsonl",
                    help="the replica's recorded rows (scripts/run_qcqp_parity.py's output)")
    ap.add_argument("--suite", default="results/qcqp.jsonl",
                    help="per-instance gap denominators (mccormick, sdp)")
    ap.add_argument("--out", default="results/qcqp_parity_torch.jsonl")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--sel-gate", default=None,
                    help="CutConfig.sel_gate (default: the config's, 'residual')")
    ap.add_argument("--cooldown", type=int, default=0,
                    help="CutConfig.sel_cooldown (with --sel-gate cooldown)")
    ap.add_argument("--steer-eps", type=float, default=0.0,
                    help="vertex steering of the scoring point (LoopConfig.steer_eps)")
    ap.add_argument("--diversity-alpha", type=float, default=0.0,
                    help="support-diverse selection penalty (ops/topk.py diverse_topk)")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")

    denoms = {r["instance"]: (r["mccormick"], r["sdp"]) for r in read_records(args.suite)
              if "mccormick" in r and "sdp" in r}
    replica = read_records(args.replica)
    for name in args.names.split(","):
        inst = load_or_generate_qcqp(name)
        for strat in args.strategies.split(","):
            rep = None
            for r in replica:
                if (r.get("instance") == name and r.get("strategy") == strat
                        and r.get("k") == args.k and r.get("rounds") == args.rounds
                        and r.get("sel_size") == args.sel_size
                        and float(r.get("tpu_diversity_alpha", 0.0)) == args.diversity_alpha
                        and r.get("replica_bounds")):
                    rep = r                       # the latest matching row
            if rep is None:
                print(f"[qcqp-parity] {name} {strat}: no recorded replica row to pair with, "
                      "skipping", flush=True)
                continue
            rep_bounds = rep["replica_bounds"]
            cfg = RunConfig(
                lp=LPConfig(max_iters=args.lp_max_iters, tol=2e-6),
                cuts=CutConfig(k=args.k, sel_size=args.sel_size, capacity=1024, purge=False,
                               sel_cooldown=args.cooldown, diversity_alpha=args.diversity_alpha,
                               **({"sel_gate": args.sel_gate} if args.sel_gate else {})),
                scorer=ScorerConfig(strategy=strat),
                loop=LoopConfig(rounds=args.rounds, polish_iters=args.polish_iters,
                                steer_eps=args.steer_eps))
            t0 = time.perf_counter()
            out = CutSolverQCQP(inst, cfg, device=device).run(args.rounds)
            port_t = time.perf_counter() - t0
            port_bounds = [h.bound for h in out]

            mc, sdp = denoms.get(name, (rep_bounds[0], None))
            if sdp is not None:
                def gd(b):
                    return max(0.0, min(1.0, (mc - b) / max(mc - sdp, 1e-12)))
                rep_final, port_final = gd(rep_bounds[-1]), gd(port_bounds[-1])
                ratio = port_final / max(rep_final, 1e-12)
            else:
                rep_final = port_final = None
                ratio = ((port_bounds[0] - port_bounds[-1])
                         / max(rep_bounds[0] - rep_bounds[-1], 1e-12))
            rec = {
                "instance": name, "strategy": strat, "k": args.k,
                "sel_size": args.sel_size, "rounds": args.rounds,
                "replica_bounds": rep_bounds, "tpu_bounds": port_bounds,
                "replica_gap_closed": rep_final, "tpu_gap_closed": port_final,
                "ratio": ratio, "replica_wall_s": rep.get("replica_wall_s"),
                "tpu_wall_s": port_t, "replica_from_recorded_row": True,
                "tpu_diversity_alpha": args.diversity_alpha,
                "tpu_backend": device.type,
                "tpu_polish_iters": args.polish_iters,
                "tpu_steer_eps": args.steer_eps,
                "tpu_sel_gate": args.sel_gate or CutConfig().sel_gate,
                "tpu_sel_cooldown": args.cooldown,
                "platform": device.type,
                "ts": time.time(),
            }
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(f"[qcqp-parity] {name} {strat}: ratio={ratio:.3f} "
                  f"replica={rep_bounds[-1]:.4f} port={port_bounds[-1]:.4f} ({device.type})",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
