"""Where a main path's time goes on one GPU.

    python3 -m sdpcutsel_tpu_torch.profile_round [--instance spar125-100-1]
        [--rounds N] [--pair-layout {auto,packed}] [--scan] [--strategy NAME]
        [--steer-eps EPS] [--out chiprun_out]

The main paths are chip_smoke.py's:
  * a BoxQP name (default spar125-100-1): CutSolver, strategy neural,
    default cuts, LPConfig(max_iters=20000, tol=2e-6), 10 rounds;
    ``--pair-layout packed --scan`` is chip_smoke.py's packed scan path
    (CutConfig(pair_layout="packed"), LoopConfig(use_scan=True));
  * a QCQP name (qcqp...; qcqpband100-5-25-1 in chip_smoke.py):
    CutSolverQCQP in the suite configuration of scripts/run_qcqp_suite.py
    (k = 5, sel_size 16, capacity 1024, the same LP), 8 rounds.  The final
    polish re-solve is left out: it is one LP solve after the rounds.
``--strategy`` (default neural) and ``--steer-eps`` (default 0: no vertex
steering; 1e-3 in chip_smoke.py's steered QCQP scan, 4,000 iterations a
round) apply to either family; ``--scan`` to either too.
``--batch`` profiles chip_smoke.py's batched suite bucket instead: the
twelve spar125-{25,50,75,100}-{1,2,3} of data/boxqp as one batch
(``parallel/round.py``, scripts/bench_batched.py --suite's configuration:
capacity 1024, k = 3, lp_iters 400, sel_size 16, neural, Mesh(1, 1)), 10
per-round steps; it prints instance-rounds/s, the batched setup, the KKT
reads per checked block and the split of the same stages.
After one warm-up round (kernel build, first cuSOLVER use), three runs of
``--rounds`` rounds, each from a fresh solver:

  1. plain: host wall time, synchronised at the end -> rounds/s, and
     rounds / the sum of the rounds' wall_time_s (in scan mode that leaves
     out the certificates computed after the loop);
  2. stage split: each stage wrapped with a CUDA synchronise on both sides
     and timed on the host clock.  The synchronises slow the run, so its
     wall time is printed beside the plain one;
  3. torch.profiler: the device time of every kernel and copy, summed; the
     device's idle share is 1 - that sum / the run's wall time.  The
     profiler's table goes to
     OUT/profile_table_<instance>[_<layout>][_scan][_<strategy>][_steer<eps>].txt.

Needs a CUDA device; prints the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .config import CutConfig, LoopConfig, LPConfig, RunConfig, ScorerConfig
from .instances import load_or_generate_qcqp, parse_boxqp
from .loop import solver as solver_mod
from .lp import pdhg as pdhg_mod
from .lp import pdhg_kernel as pdhg_kernel_mod
from .models import labels as labels_mod
from .parallel import round as round_mod
from .qcqp import solver as qcqp_mod
from .relax import batched as batched_mod

# ops/__init__ binds the names pair_score and fused_score to the wrappers,
# not the modules
pair_score_mod = importlib.import_module(".ops.pair_score", __package__)
pair_packed_mod = importlib.import_module(".ops.pair_packed", __package__)
fused_score_mod = importlib.import_module(".ops.fused_score", __package__)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "boxqp")
LP = LPConfig(max_iters=20000, tol=2e-6)

# (owner, attribute, label); a label indented by two spaces is part of the
# stage above it.  A function that both solvers import by name is patched
# in both modules under one label.
STAGES = [
    (solver_mod, "solve_setup", "solve_setup"),
    (pdhg_mod, "estimate_norm", "  estimate_norm"),
    (pdhg_mod, "build_cut_index", "  build_cut_index"),
    (solver_mod, "solve_lp", "solve_lp"),
    (pdhg_kernel_mod, "_launch", "  K2 pdhg_block (solve and steering)"),
    (pdhg_mod, "_kkt_error", "  _kkt_error (torch)"),
    (solver_mod, "steer_to_vertex", "steer_to_vertex"),
    *((mod, "dual_bound_f64", "dual_bound_f64 (host numpy)")
      for mod in (solver_mod, qcqp_mod)),
    (pair_score_mod, "_launch", "K1 pair_score"),
    (pair_packed_mod, "_launch", "K3 pair_packed"),
    (fused_score_mod, "_launch", "K4 fused_score"),
    (labels_mod, "exact_improvement", "optimality ADMM (exact_improvement)"),
    *((mod, "triangle_select_and_generate", "triangle select + rows")
      for mod in (solver_mod, qcqp_mod)),
    *((mod, name, label) for mod in (solver_mod, qcqp_mod) for name, label in (
        ("select_and_generate", "selection + eigh + cut rows"),
        ("cut_residuals", "purge: residuals"),
        ("purge_pool", "purge: compact"),
        ("append_cuts", "append_cuts"))),
]


# the batched suite bucket's stages (--batch)
BATCH_STAGES = [
    (round_mod, "solve_setup_batched", "batched setup"),
    (pdhg_mod, "estimate_norm_batched", "  estimate_norm_batched"),
    (batched_mod, "build_cut_index", "  build_cut_index (batched)"),
    (round_mod, "_solve_batched", "_solve_batched"),
    (pdhg_kernel_mod, "_launch_batched", "  K2 pdhg_block (batched launch)"),
    (pdhg_mod, "block_check", "  KKT check and its (B, 6) read"),
    (pdhg_mod, "_restart_distances", "  restart distances and their read"),
    (round_mod, "_dual_bound_batched", "f32 certificate"),
    (round_mod._Round, "select", "scoring + local top-k + merge"),
    (pair_score_mod, "_launch", "  K1 pair_score"),
    (round_mod, "diverse_topk", "  diverse merge"),
    (round_mod, "cuts_from_selected", "cut rows"),
    (batched_mod, "purge_pool", "purge: compact"),
    (batched_mod, "append_cuts", "append_cuts"),
]
SUITE_BUCKET = [f"spar125-{d}-{s}" for d in (25, 50, 75, 100) for s in (1, 2, 3)]


class BatchPath:
    """chip_smoke.py's batched suite bucket (``--batch``)."""
    rounds = 10

    def __init__(self):
        self.insts = [parse_boxqp(os.path.join(DATA, f"{name}.in"), name=name)
                      for name in SUITE_BUCKET]
        self.mesh = round_mod.Mesh(1, 1)
        self.step = round_mod.make_sharded_round_step(self.mesh, lp_iters=400, sel_size=16,
                                                      strategy="neural")

    def run(self, dev, rounds: int) -> float:
        from .cuts.enumerate import combinations_table
        from .parallel.sharding import shard_candidates

        table, valid = shard_candidates(combinations_table(self.insts[0].n, 3), self.mesh,
                                        device=dev)
        state = round_mod.init_batched_state(np.stack([i.Q for i in self.insts]),
                                             np.stack([i.c for i in self.insts]), 1024, 3,
                                             device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(rounds):
            state, _ = self.step(state, table, valid)
        torch.cuda.synchronize()
        return time.perf_counter() - t0


def load(name: str, pair_layout: str = "auto", scan: bool = False,
         strategy: str = "neural", steer_eps: float = 0.0):
    """(instance, solver class, config, default rounds) of a main path."""
    scorer = ScorerConfig(strategy=strategy)
    loop = LoopConfig(use_scan=scan, steer_eps=steer_eps)
    if name.startswith("qcqp"):
        cfg = RunConfig(lp=LP, cuts=CutConfig(k=5, sel_size=16, capacity=1024),
                        scorer=scorer, loop=loop)
        return load_or_generate_qcqp(name), qcqp_mod.CutSolverQCQP, cfg, 8
    inst = parse_boxqp(os.path.join(DATA, f"{name}.in"), name=name)
    cfg = RunConfig(lp=LP, cuts=CutConfig(pair_layout=pair_layout), scorer=scorer, loop=loop)
    return inst, solver_mod.CutSolver, cfg, 10


def _run(path, dev, rounds: int, history: list | None = None) -> float:
    if isinstance(path, BatchPath):
        return path.run(dev, rounds)
    inst, solver_cls, cfg, _ = path
    solver = solver_cls(inst, cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = solver.run(rounds=rounds)
    torch.cuda.synchronize()
    if history is not None:
        history.extend(hist)
    return time.perf_counter() - t0


def stage_split(path, dev, rounds: int, stages=STAGES):
    """(wall seconds, {label: (seconds, calls)}) of a run with every stage
    synchronised and timed."""
    seconds = collections.defaultdict(float)
    calls = collections.Counter()
    originals = []

    def timed(fn, label):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[label] += time.perf_counter() - t0
            calls[label] += 1
            return out
        return wrapper

    for owner, name, label in stages:
        fn = getattr(owner, name)
        originals.append((owner, name, fn))
        setattr(owner, name, timed(fn, label))
    try:
        wall = _run(path, dev, rounds)
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)
    return wall, {label: (seconds[label], calls[label]) for _, _, label in stages}


def device_time(path, dev, rounds: int, table_path: str):
    """(wall seconds, device seconds of all kernels and copies, top rows)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _run(path, dev, rounds)
    averages = prof.key_averages()
    field = ("self_device_time_total" if hasattr(averages[0], "self_device_time_total")
             else "self_cuda_time_total")
    rows = []
    for e in averages:
        dev_us = getattr(e, field)
        # device rows (kernels, copies) have no host time of their own
        if dev_us > 0 and e.self_cpu_time_total == 0:
            rows.append((dev_us * 1e-6, e.count, e.key))
    rows.sort(reverse=True)
    os.makedirs(os.path.dirname(table_path), exist_ok=True)
    with open(table_path, "w") as f:
        f.write(averages.table(sort_by=field, row_limit=40))
    return wall, sum(r[0] for r in rows), rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--instance", default="spar125-100-1",
                    help="a BoxQP name from data/boxqp or a QCQP name (qcqp...)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="default: 10 for BoxQP, 8 for QCQP")
    ap.add_argument("--pair-layout", default="auto", choices=("auto", "packed"),
                    help="BoxQP only: the candidate table's layout (CutConfig.pair_layout)")
    ap.add_argument("--scan", action="store_true", help="scan mode (LoopConfig.use_scan)")
    ap.add_argument("--strategy", default="neural", help="ScorerConfig.strategy")
    ap.add_argument("--steer-eps", type=float, default=0.0,
                    help="LoopConfig.steer_eps (0: no vertex steering)")
    ap.add_argument("--batch", action="store_true",
                    help="the batched suite bucket (12 x n = 125) instead of one instance")
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_round: no CUDA device visible to torch", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"[env] {smi.splitlines()[0]}; torch {torch.__version__}", flush=True)

    dev = torch.device("cuda", 0)
    if args.batch:
        path = BatchPath()
        rounds = args.rounds or path.rounds
        B = len(path.insts)
        print(f"[path] batched suite bucket: {B} x n = {path.insts[0].n} "
              f"({', '.join(SUITE_BUCKET)}), {rounds} per-round steps", flush=True)
        _run(path, dev, 1)                                    # warm-up
        wall = _run(path, dev, rounds)
        print(f"[plain] {rounds} rounds of {B} in {wall:.4f} s = {rounds / wall:.4f} "
              f"rounds/s = {B * rounds / wall:.4f} instance-rounds/s", flush=True)
        stage_list = BATCH_STAGES
    else:
        path = load(args.instance, args.pair_layout, args.scan, args.strategy, args.steer_eps)
        rounds = args.rounds or path[3]
        print(f"[path] {args.instance} with {path[1].__name__}, {rounds} rounds, cuts "
              f"{path[2].cuts}, scorer {path[2].scorer}, loop {path[2].loop}", flush=True)
        _run(path, dev, 1)                                    # warm-up

        hist = []
        wall = _run(path, dev, rounds, hist)
        round_s = sum(h.wall_time_s for h in hist)
        print(f"[plain] {rounds} rounds in {wall:.4f} s = {rounds / wall:.4f} rounds/s; "
              f"rounds / sum of wall_time_s {rounds / round_s:.4f} rounds/s", flush=True)
        stage_list = STAGES

    split_wall, stages = stage_split(path, dev, rounds, stage_list)
    print(f"[split] synchronised run: {split_wall:.4f} s", flush=True)
    for label, (s, n) in stages.items():
        print(f"[split] {label:<32} {1e3 * s:10.2f} ms {100 * s / split_wall:7.2f}%"
              f" {n:6d} calls", flush=True)
    if args.batch:
        blocks = stages["  K2 pdhg_block (batched launch)"][1]
        reads = stages["  KKT check and its (B, 6) read"][1]
        restarts = stages["  restart distances and their read"][1]
        print(f"[split] host reads of the KKT check: {reads} for {blocks} checked blocks "
              f"({reads / max(blocks, 1):.2f} a block, each one (B, 6) array for the whole "
              f"batch), and {restarts} (B, 2) reads on restarts", flush=True)

    tag = "batch_suite125" if args.batch else args.instance
    tag += "" if args.pair_layout == "auto" else f"_{args.pair_layout}"
    tag += "_scan" if args.scan else ""
    tag += "" if args.strategy == "neural" else f"_{args.strategy}"
    tag += f"_steer{args.steer_eps:g}" if args.steer_eps > 0 else ""
    prof_wall, busy, rows = device_time(path, dev, rounds,
                                        os.path.join(args.out, f"profile_table_{tag}.txt"))
    print(f"[profile] wall {prof_wall:.4f} s (with the profiler); device busy "
          f"{busy:.4f} s; idle share {1 - busy / prof_wall:.4f}", flush=True)
    for s, n, name in rows[:8]:
        print(f"[profile] {1e3 * s:10.3f} ms {n:7d}x {name[:70]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
