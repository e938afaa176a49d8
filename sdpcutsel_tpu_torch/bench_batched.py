"""Instance-batched solve benchmark on one GPU (port of
``scripts/bench_batched.py``).

Cutting-plane rounds/s with B instances solved together by the batched
round step (``parallel/round.py``), and instance-rounds/s:

    python3 -m sdpcutsel_tpu_torch.bench_batched --n 30 --batch 8 --rounds 6

Modes, as in the reference script:
  * per-round steps (default): B = ``--batch`` instances
    ``generate_spar(n, 100, s + 1)``, one warm-up round (the kernel build),
    then ``--rounds`` timed rounds, certified in f64 after the timer;
  * ``--use-scan``: all rounds in one call (``make_sharded_scan_step``), a
    warm-up run, then one timed run from the same start state;
  * ``--suite``: the grid sizes x densities x seeds, bucketed by n
    (``bucket_instances``), each bucket solved as one batch (capacity 1024,
    k = 3); one line a bucket and a summary;
  * ``--qcqp``: ``generate_qcqp_family(n, density, m, 1, batch)``, the
    chordal clique table at k = 4, the constraints as a batched dense block.
Runs on the card unless ``--cpu`` is given; without a card it stops.  Each
line names the device (and the card's ``nvidia-smi`` name and power limit).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from .instances import generate_qcqp_family, generate_spar
from .parallel.mesh import make_mesh
from .parallel.round import (bucket_instances, certify_batched_f64, certify_scan_f64,
                             init_batched_state, make_sharded_round_step,
                             make_sharded_scan_step, shard_batched_state)
from .parallel.sharding import shard_candidates, shard_combinations
from .qcqp.chordal import chordal_decomposition, clique_candidates
from .relax.denserows import batched_dense_from_qcqp


def device_name(dev: torch.device) -> str:
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name(dev)} ({smi})"


def sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_rounds(step, state, table, valid, rounds: int, dev, dense=None):
    """One warm-up round, then ``rounds`` timed rounds; (state, seconds)."""
    state, _ = step(state, table, valid, dense)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(rounds):
        state, _ = step(state, table, valid, dense)
    sync(dev)
    return state, time.perf_counter() - t0


def run_suite(args, mesh, dev, where: str):
    sizes = [int(v) for v in args.suite_sizes.split(",")]
    densities = [int(v) for v in args.suite_densities.split(",")]
    seeds = [int(v) for v in args.suite_seeds.split(",")]
    insts = [generate_spar(n, d, s) for n in sizes for d in densities for s in seeds]
    total_t, recs = 0.0, []
    for n, bucket in bucket_instances(insts).items():
        B = len(bucket)
        state = shard_batched_state(init_batched_state(
            np.stack([i.Q for i in bucket]), np.stack([i.c for i in bucket]),
            capacity=1024, kmax=3, device=dev), mesh)
        table, valid = shard_combinations(n, 3, mesh, device=dev)
        step = make_sharded_round_step(mesh, lp_iters=args.lp_iters, sel_size=args.sel_size,
                                       strategy=args.strategy)
        state, dt = timed_rounds(step, state, table, valid, args.rounds, dev)
        total_t += dt
        rec = {"n": n, "batch": B, "rounds": args.rounds, "strategy": args.strategy,
               "seconds": dt, "instance_rounds_per_sec": B * args.rounds / dt,
               "mean_bound_certified_f64": float(certify_batched_f64(state).mean()),
               "device": where}
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    summary = {"suite_instances": len(insts), "rounds_each": args.rounds,
               "total_seconds_post_warmup": total_t,
               "aggregate_instance_rounds_per_sec": len(insts) * args.rounds / total_t,
               "mesh": f"{args.data}x{args.cand}", "device": where}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in recs + [summary]:
                f.write(json.dumps(r) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--lp-iters", type=int, default=400)
    ap.add_argument("--sel-size", type=int, default=16)
    ap.add_argument("--strategy", default="neural",
                    help="batched scoring strategy (neural is the headline)")
    ap.add_argument("--data", type=int, default=1, help="mesh data axis")
    ap.add_argument("--cand", type=int, default=1, help="mesh cand axis")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' twins)")
    ap.add_argument("--suite", action="store_true",
                    help="solve the sizes x densities x seeds grid, bucketed by n")
    ap.add_argument("--suite-sizes", default="20,30,40,50,60,70,80,90,100,125")
    ap.add_argument("--suite-densities", default="25,50,75,100")
    ap.add_argument("--suite-seeds", default="1,2,3")
    ap.add_argument("--out", default=None, help="JSONL path for suite mode")
    ap.add_argument("--qcqp", action="store_true",
                    help="QCQP family: clique-candidate table, dense constraint rows, k = 4")
    ap.add_argument("--qcqp-m", type=int, default=2,
                    help="quadratic constraints per QCQP instance")
    ap.add_argument("--qcqp-density", type=int, default=30)
    ap.add_argument("--use-scan", action="store_true",
                    help="all rounds in one call (make_sharded_scan_step)")
    args = ap.parse_args(argv)
    if args.cpu:
        dev = torch.device("cpu")
    elif torch.cuda.is_available():
        dev = torch.device("cuda", 0)
    else:
        print("bench_batched: no CUDA device visible to torch (--cpu runs on the CPU)",
              file=sys.stderr)
        return 2
    where = device_name(dev)
    mesh = make_mesh(data=args.data, cand=args.cand)
    if args.suite:
        run_suite(args, mesh, dev, where)
        return 0

    dense, kmax, m_dense = None, 3, 0
    if args.qcqp:
        fam = generate_qcqp_family(args.n, args.qcqp_density, args.qcqp_m, 1, args.batch)
        cliques, _ = chordal_decomposition(args.n, fam[0].sparsity_graph())
        table_np = clique_candidates(cliques, 4)
        Qb, cb = np.stack([i.Q0 for i in fam]), np.stack([i.c0 for i in fam])
        dense, kmax, m_dense = batched_dense_from_qcqp(fam, dev), 4, args.qcqp_m
        table, valid = shard_candidates(table_np, mesh, device=dev)
        candidates = table_np.shape[0]
    else:
        insts = [generate_spar(args.n, 100, s + 1) for s in range(args.batch)]
        Qb, cb = np.stack([i.Q for i in insts]), np.stack([i.c for i in insts])
        table, valid = shard_combinations(args.n, 3, mesh, device=dev)
        candidates = math.comb(args.n, 3)
    state = shard_batched_state(init_batched_state(Qb, cb, capacity=1024, kmax=kmax,
                                                   m_dense=m_dense, device=dev), mesh)
    knobs = dict(lp_iters=args.lp_iters, sel_size=args.sel_size, strategy=args.strategy,
                 kmax=kmax, m_dense=m_dense)
    rec = {"problem": "qcqp-k4" if args.qcqp else "boxqp-k3", "batch": args.batch,
           "n": args.n, "mesh": f"{args.data}x{args.cand}", "candidates": int(candidates)}
    if args.use_scan:
        scan = make_sharded_scan_step(mesh, rounds=args.rounds, **knobs)
        scan(state, table, valid, dense)                    # warm-up (kernel build)
        sync(dev)
        t0 = time.perf_counter()
        final, outs = scan(state, table, valid, dense)
        sync(dev)
        dt = time.perf_counter() - t0
        bounds = certify_scan_f64(final.Q, final.c, outs, dense=dense)[-1]
        rec["mode"] = "scan"
    else:
        step = make_sharded_round_step(mesh, **knobs)
        final, dt = timed_rounds(step, state, table, valid, args.rounds, dev, dense)
        bounds = certify_batched_f64(final, dense=dense)
    rec.update({"rounds_per_sec": args.rounds / dt,
                "instance_rounds_per_sec": args.batch * args.rounds / dt,
                "lp_iters_per_round": args.lp_iters, "mean_bound": float(bounds.mean()),
                "cuts": final.pool.count.tolist(), "device": where})
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
