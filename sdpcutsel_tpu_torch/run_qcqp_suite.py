"""Incremental QCQP suite runner, resumable (port of
``scripts/run_qcqp_suite.py``).

Cells are (instance, strategy, k); done cells are skipped on re-invocation.
SDP reference bounds (with the quadratic-constraint rows in the relaxation)
are certified once per instance and cached in ``data/qcqp/bounds.json``.
Runs on the card unless ``--cpu``; records carry ``platform`` and go to
``results/qcqp_torch.jsonl`` by default, never the JAX package's
``results/qcqp.jsonl``.

    python3 -m sdpcutsel_tpu_torch.run_qcqp_suite --specs 015-30-3-1,020-25-4-1 \\
        --ks 4,5 --strategies neural,feasibility --rounds 8
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from .config import CutConfig, LoopConfig, LPConfig, RunConfig, ScorerConfig
from .instances.qcqp import generate_qcqp, load_or_generate_qcqp
from .loop.sdp_bound import gap_closed
from .qcqp.solver import CutSolverQCQP
from .utils.logging import JSONLLogger, read_records
from .utils.registry import ensure_certified_bounds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sdpcutsel_tpu_torch.run_qcqp_suite")
    ap.add_argument("--specs", default="015-30-3-1,020-25-4-1,025-20-4-1",
                    help="comma list of n-density-m-seed, or full qcqp names")
    ap.add_argument("--ks", default="4,5")
    ap.add_argument("--strategies", default="neural,feasibility,random")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--sel-size", type=int, default=16)
    ap.add_argument("--data-dir", default="data/qcqp")
    ap.add_argument("--out", default="results/qcqp_torch.jsonl")
    ap.add_argument("--lp-max-iters", type=int, default=20000)
    ap.add_argument("--polish-iters", type=int, default=60000)
    ap.add_argument("--sdp-max-rounds", type=int, default=60)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")

    os.makedirs(args.data_dir, exist_ok=True)
    reg_path = os.path.join(args.data_dir, "bounds.json")
    done = {(r["instance"], r["strategy"], r.get("k")) for r in read_records(args.out)
            if "instance" in r and "strategy" in r}

    with JSONLLogger(args.out) as logger:
        for spec in args.specs.split(","):
            if spec.startswith("qcqp"):       # a full name, band-structured ones too
                inst = load_or_generate_qcqp(spec)
            else:
                n, d, m, seed = (int(v) for v in spec.split("-"))
                inst = generate_qcqp(n, d, m, seed)
            # a registry miss certifies the sandwich with the validated settings
            mc, sdp = ensure_certified_bounds(inst, reg_path, None,
                                              max_rounds=args.sdp_max_rounds, device=device)
            for k in (int(v) for v in args.ks.split(",")):
                for strat in args.strategies.split(","):
                    if (inst.name, strat, k) in done:
                        continue
                    cfg = RunConfig(
                        lp=LPConfig(max_iters=args.lp_max_iters, tol=2e-6),
                        cuts=CutConfig(k=k, sel_size=args.sel_size, capacity=1024),
                        scorer=ScorerConfig(strategy=strat),
                        loop=LoopConfig(polish_iters=args.polish_iters))
                    t0 = time.perf_counter()
                    hist = CutSolverQCQP(inst, cfg, device=device).run(rounds=args.rounds)
                    gaps = gap_closed(mc, sdp, [h.bound for h in hist])
                    rec = {
                        "instance": inst.name, "strategy": strat, "k": k,
                        "sel_size": args.sel_size, "mccormick": mc, "sdp": sdp,
                        "bounds": [h.bound for h in hist],
                        "gap_closed": gaps.tolist(),
                        "final_gap_closed": float(gaps[-1]) if len(gaps) else 0.0,
                        "cuts_total": hist[-1].cuts_active if hist else 0,
                        "wall_time_s": time.perf_counter() - t0,
                        "platform": device.type,
                    }
                    logger.log(rec)
                    print(f"[qcqp] {inst.name} k={k} {strat}: {rec['final_gap_closed']:.3f} "
                          f"t={rec['wall_time_s']:.1f}s ({device.type})", flush=True)
    print("[qcqp] all cells complete", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
