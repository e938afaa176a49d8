"""Where a main path's time goes on one GPU.

    python3 -m sdpcutsel_tpu_torch.profile_round [--instance spar125-100-1]
        [--rounds N] [--pair-layout {auto,packed}] [--scan] [--strategy NAME]
        [--k K] [--sel-size S] [--steer-eps EPS] [--batch] [--groups 1,2,4,8,16]
        [--spread RUNS] [--out chiprun_out]

The main paths are chip_smoke.py's:
  * a BoxQP name (default spar125-100-1; one data/boxqp lacks is generated
    from its name): CutSolver, strategy neural, default cuts,
    LPConfig(max_iters=20000, tol=2e-6), 10 rounds; ``--k`` and
    ``--sel-size`` set CutConfig's k and sel_size (chip_smoke.py's phase 26:
    k = 4, or k = 5 with sel_size 10).  Past its threshold
    (``loop/solver.py`` PIECE_N_OF: n = 2048 at k = 3) the round goes by
    pieces of the table, and the split then also times each piece's rows
    written, at k = 4 and 5 its features (K4's triQ and scale), the
    survivors' filter and the final greedy;
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
per-round steps; it prints instance-rounds/s, the batched setup, the host
reads of the solves' control record per checked block and the split of the
same stages.  ``--groups`` first times plain runs with each number of
blocks between two reads of the record (``lp/pdhg.py::GROUP_BLOCKS``), in
turns (the list, then the list reversed).
``--spread RUNS`` measures, instead of the profile, how far the path's final
bound moves with rounding-level changes (a QCQP path with chip_smoke.py's
60,000-iteration polish): the bounds of one run under each of two controls
of the solve, K5 and K6 as the solve runs them and their plain twins (the
host loop's arithmetic that K5 and K6 replaced; K2 runs in both), then,
under each control, the final bounds with omega0 or step_scale moved up by
1 to RUNS float32 ulps, each alone (min, median, max and the unmoved
run's rank), and the first solve and block at which the two controls'
runs part: the first ||K|| whose bits differ, the first record word that
differs, and the first that steers the iterates (it, wlen, stop, restart,
use_avg, omega, tau, sigma), with both records there.
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
import contextlib
import dataclasses
import importlib
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .config import CutConfig, LoopConfig, LPConfig, RunConfig, ScorerConfig
from .instances import load_or_generate, load_or_generate_qcqp, parse_boxqp
from .loop import solver as solver_mod
from .lp import pdhg as pdhg_mod
from .lp import pdhg_check as pdhg_check_mod
from .lp import pdhg_kernel as pdhg_kernel_mod
from .lp import pdhg_norm as pdhg_norm_mod
from .models import labels as labels_mod
from .ops import topk as topk_mod
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
QCQP_POLISH = 60000            # chip_smoke.py's QCQP main path

# (owner, attribute, label); a label indented by two spaces is part of the
# stage above it.  A function that both solvers import by name is patched
# in both modules under one label.
STAGES = [
    (solver_mod, "solve_setup", "solve_setup"),
    (pdhg_norm_mod, "_launch", "  K6 pdhg_norm"),
    (pdhg_mod, "build_cut_index", "  build_cut_index"),
    (solver_mod, "solve_lp", "solve_lp"),
    (pdhg_check_mod, "_enqueue", "  K2+K5 checked block (solve)"),
    (pdhg_kernel_mod, "_launch_core", "  K2 pdhg_block (steering)"),
    (pdhg_mod, "read_record", "  record reads (one a group)"),
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
    # the round by pieces (K1 or K4, random's draw or the ADMM above is each
    # piece's scoring): the rows written, at k = 4, 5 each piece's features
    # (also the whole table's, once, in the solver's set-up), the survivors'
    # filter, the final greedy over the survivors, and the cut rows of the
    # picks
    (solver_mod, "combinations_range_on", "pieces: rows written"),
    (solver_mod, "candidate_q_features", "pieces: features (k = 4, 5)"),
    (topk_mod.StreamedTopk, "add", "pieces: survivors' filter"),
    (topk_mod.StreamedTopk, "result", "pieces: final greedy"),
    (solver_mod, "cut_rows_at", "eigh + cut rows (in the selection above, or by pieces)"),
]


# the batched suite bucket's stages (--batch)
BATCH_STAGES = [
    (round_mod, "solve_setup_batched", "batched setup"),
    (pdhg_norm_mod, "_launch", "  K6 pdhg_norm (batched launch)"),
    (batched_mod, "build_cut_index", "  build_cut_index (batched)"),
    (round_mod, "_solve_batched", "_solve_batched"),
    (pdhg_check_mod, "_enqueue", "  K2+K5 checked block (batched launch)"),
    (pdhg_mod, "read_record", "  record reads (one a group)"),
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
         strategy: str = "neural", steer_eps: float = 0.0, k: int = 3,
         sel_size: int | None = None):
    """(instance, solver class, config, default rounds) of a main path
    (``k`` and ``sel_size``: BoxQP's CutConfig; None the default)."""
    scorer = ScorerConfig(strategy=strategy)
    loop = LoopConfig(use_scan=scan, steer_eps=steer_eps)
    if name.startswith("qcqp"):
        cfg = RunConfig(lp=LP, cuts=CutConfig(k=5, sel_size=16, capacity=1024),
                        scorer=scorer, loop=loop)
        return load_or_generate_qcqp(name), qcqp_mod.CutSolverQCQP, cfg, 8
    inst = load_or_generate(name, data_dir=DATA)
    cuts = CutConfig(pair_layout=pair_layout, k=k)
    if sel_size is not None:
        cuts = dataclasses.replace(cuts, sel_size=sel_size)
    cfg = RunConfig(lp=LP, cuts=cuts, scorer=scorer, loop=loop)
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


def time_groups(path, dev, rounds: int, groups: str | None):
    """Plain runs with each number of blocks between two reads of the
    solve's record, in turns (the list, then reversed); the default is
    restored after."""
    if not groups:
        return
    sizes = [int(g) for g in groups.split(",")]
    default = pdhg_mod.GROUP_BLOCKS
    walls = collections.defaultdict(list)
    try:
        for g in sizes + sizes[::-1]:
            pdhg_mod.GROUP_BLOCKS = g
            walls[g].append(_run(path, dev, rounds))
    finally:
        pdhg_mod.GROUP_BLOCKS = default
    for g in sizes:
        print(f"[groups] {g:3d} blocks a read: runs {walls[g]!r} s, {rounds} rounds each; mean "
              f"{2 * rounds / sum(walls[g]):.4f} rounds/s", flush=True)


@contextlib.contextmanager
def control(twins: bool):
    """Single solves whose control is K5 and K6 (``twins`` False: the
    checked K2 launch) or their plain twins in their place on the card (K2
    unchecked, then ``pdhg_check_plain``), with the record after every
    checked block and every ||K|| kept on the device in the yielded trace
    (with the solve of each block).  The solve's step
    (``pdhg_check.checked_step``) and K6's launch (``_launch``, a batch of
    one) are what is wrapped."""
    make_step, norm = pdhg_check_mod.checked_step, pdhg_norm_mod._launch
    if twins:
        def one(o):
            return None if o is None else batched_mod.instance(o, 0)

        def make_step(cx, cX, pool, index, st, acc, anchor, rec, check_every,
                      restart_period, max_iters, tol, dense=None, batched=False):
            def step():
                pdhg_kernel_mod.pdhg_block_steps(cx, cX, pool, index, st, acc, rec,
                                                 check_every, dense)
                pdhg_mod.pdhg_check_plain(cx, cX, pool, index, st, acc, anchor, rec,
                                          check_every, restart_period, max_iters, tol, dense)
            return step

        def norm(pool, n, iters, generator, index, dense):
            return pdhg_mod.estimate_norm_plain(one(pool), n, iters, generator, one(index),
                                                one(dense))[None]

    trace = {"records": [], "solves": [], "norms": []}
    before = pdhg_mod.SOLVE_COUNTS["solves"]

    def traced_step(*args, **kwargs):
        step = make_step(*args, **kwargs)
        rec = args[7]                                      # the solve's record

        def traced():
            step()
            trace["records"].append(rec.clone())
            trace["solves"].append(pdhg_mod.SOLVE_COUNTS["solves"] - before)
        return traced

    def traced_norm(*args):
        out = norm(*args)
        trace["norms"].append(out[0].clone())
        return out

    saved = pdhg_check_mod.checked_step, pdhg_norm_mod._launch
    pdhg_check_mod.checked_step, pdhg_norm_mod._launch = traced_step, traced_norm
    try:
        yield trace
    finally:
        pdhg_check_mod.checked_step, pdhg_norm_mod._launch = saved


TRAJECTORY = {"it": pdhg_mod.REC_IT, "wlen": pdhg_mod.REC_WLEN, "stop": pdhg_mod.REC_STOP,
              "restart": pdhg_mod.REC_RESTART, "use_avg": pdhg_mod.REC_USE_AVG,
              "omega": pdhg_mod.REC_OMEGA, "tau": pdhg_mod.REC_TAU, "sigma": pdhg_mod.REC_SIGMA}
VALUES = {"err": pdhg_mod.REC_ERR, "p": pdhg_mod.REC_P, "d": pdhg_mod.REC_D,
          "dp": pdhg_mod.REC_DP, "dd": pdhg_mod.REC_DD}


def describe(row: np.ndarray) -> str:
    f = pdhg_mod.record_floats(row)
    return ", ".join([f"{k} {int(row[j])}" for k, j in TRAJECTORY.items() if j < 5]
                     + [f"{k} {float(f[j])!r}" for k, j in
                        list(TRAJECTORY.items())[5:] + list(VALUES.items())])


def first_divergence(a: dict, b: dict, names=("K5/K6", "twins")):
    """Print where two traced runs of one path part."""
    na, nb = (torch.stack(t["norms"]).cpu().numpy() for t in (a, b))
    s = min(na.size, nb.size)
    bad = np.flatnonzero(na[:s] != nb[:s])
    print(f"[spread] ||K|| of {na.size} and {nb.size} solve set-ups; " + (
        f"first differing at solve {bad[0] + 1}: {float(na[bad[0]])!r} against "
        f"{float(nb[bad[0]])!r}"
        if bad.size else f"the first {s} equal bit for bit"), flush=True)
    ra, rb = (torch.stack(t["records"]).cpu().numpy() for t in (a, b))
    n = min(len(ra), len(rb))
    print(f"[spread] checked blocks: {len(ra)} and {len(rb)}", flush=True)
    for what, cols in (("any word", list(range(pdhg_mod.REC_WORDS))),
                       ("a word that steers the iterates", list(TRAJECTORY.values()))):
        diff = ra[:n][:, cols] != rb[:n][:, cols]
        rows = np.flatnonzero(diff.any(1))
        if not rows.size:
            print(f"[spread] no block differs in {what}", flush=True)
            continue
        i = rows[0]
        solve = a["solves"][i]
        block = i - a["solves"].index(solve) + 1
        words = [name for name, j in {**TRAJECTORY, **VALUES}.items()
                 if ra[i, j] != rb[i, j]]
        print(f"[spread] first block differing in {what}: block {block} of solve {solve} "
              f"(checked block {i + 1} of the run); words {words}", flush=True)
        for name, r in zip(names, (ra, rb)):
            print(f"[spread]   {name}: {describe(r[i])}", flush=True)


def spread(name: str, dev, runs: int):
    """The final bounds under both controls, unmoved and moved by 1 to
    ``runs`` ulps of omega0 and of step_scale, and where the controls part."""
    inst, solver_cls, cfg, rounds = load(name)
    if name.startswith("qcqp"):
        cfg = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop,
                                                                polish_iters=QCQP_POLISH))

    def final(twins: bool, lp_change: dict | None = None):
        c = cfg if not lp_change else dataclasses.replace(
            cfg, lp=dataclasses.replace(cfg.lp, **lp_change))
        with control(twins) as trace:
            hist = solver_cls(inst, c, device=dev).run(rounds=rounds)
        return [h.bound for h in hist], trace

    traces = {}
    for twins, label in ((False, "K5/K6"), (True, "twins")):
        t0 = time.perf_counter()
        bounds, traces[label] = final(twins)
        print(f"[spread] {name}, {label} control: final {bounds[-1]!r} after {len(bounds)} "
              f"rounds; bounds {bounds}; "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        finals = []
        for k in range(1, runs + 1):
            for field in ("omega0", "step_scale"):
                base = np.float32(getattr(cfg.lp, field))
                value = float(base + np.float32(k) * np.spacing(base))
                moved = final(twins, {field: value})[0]
                finals.append(moved[-1])
                print(f"[spread] {name}, {label} control, {field} = {value!r}: final "
                      f"{finals[-1]!r} after {len(moved)} rounds", flush=True)
        f = np.array(finals)
        print(f"[spread] {name}, {label} control: {f.size} moved runs, final bounds min "
              f"{float(f.min())!r}, median {float(np.median(f))!r}, max {float(f.max())!r}; "
              f"(max - min) / median {(f.max() - f.min()) / np.median(f):.4e}; the unmoved "
              f"run is {int((f < bounds[-1]).sum()) + 1} of {f.size + 1} from the lowest",
              flush=True)
    first_divergence(traces["K5/K6"], traces["twins"])


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
                    help="a BoxQP name from data/boxqp (else generated from its name, as "
                         "spar4096-100-1) or a QCQP name (qcqp...)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="default: 10 for BoxQP, 8 for QCQP")
    ap.add_argument("--pair-layout", default="auto", choices=("auto", "packed"),
                    help="BoxQP only: the candidate table's layout (CutConfig.pair_layout)")
    ap.add_argument("--scan", action="store_true", help="scan mode (LoopConfig.use_scan)")
    ap.add_argument("--strategy", default="neural", help="ScorerConfig.strategy")
    ap.add_argument("--k", type=int, default=3, help="BoxQP only: CutConfig.k")
    ap.add_argument("--sel-size", type=int, default=None,
                    help="BoxQP only: CutConfig.sel_size (default: its default)")
    ap.add_argument("--steer-eps", type=float, default=0.0,
                    help="LoopConfig.steer_eps (0: no vertex steering)")
    ap.add_argument("--batch", action="store_true",
                    help="the batched suite bucket (12 x n = 125) instead of one instance")
    ap.add_argument("--groups", default=None,
                    help="comma-separated blocks between two reads of the solve's record, "
                         "each timed in a plain run first")
    ap.add_argument("--spread", type=int, default=0, metavar="RUNS",
                    help="instead of the profile: the final bound under K5/K6 and under "
                         "their twins, and moved by 1 to RUNS ulps of omega0 and step_scale")
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
    if args.spread:
        spread(args.instance, dev, args.spread)
        print(f"[env] {smi.splitlines()[0]}", flush=True)
        return 0
    if args.batch:
        path = BatchPath()
        rounds = args.rounds or path.rounds
        B = len(path.insts)
        print(f"[path] batched suite bucket: {B} x n = {path.insts[0].n} "
              f"({', '.join(SUITE_BUCKET)}), {rounds} per-round steps", flush=True)
        _run(path, dev, 1)                                    # warm-up
        time_groups(path, dev, rounds, args.groups)
        wall = _run(path, dev, rounds)
        print(f"[plain] {rounds} rounds of {B} in {wall:.4f} s = {rounds / wall:.4f} "
              f"rounds/s = {B * rounds / wall:.4f} instance-rounds/s", flush=True)
        stage_list = BATCH_STAGES
    else:
        path = load(args.instance, args.pair_layout, args.scan, args.strategy, args.steer_eps,
                    args.k, args.sel_size)
        rounds = args.rounds or path[3]
        print(f"[path] {args.instance} with {path[1].__name__}, {rounds} rounds, cuts "
              f"{path[2].cuts}, scorer {path[2].scorer}, loop {path[2].loop}", flush=True)
        _run(path, dev, 1)                                    # warm-up
        time_groups(path, dev, rounds, args.groups)

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
    blocks = stages[[lb for lb in stages if lb.startswith("  K2+K5")][0]][1]
    reads = stages["  record reads (one a group)"][1]
    print(f"[split] host reads of the solves' control record: {reads} for {blocks} checked "
          f"blocks ({reads / max(blocks, 1):.3f} a block, groups of {pdhg_mod.GROUP_BLOCKS})",
          flush=True)

    tag = "batch_suite125" if args.batch else args.instance
    tag += "" if args.pair_layout == "auto" else f"_{args.pair_layout}"
    tag += "_scan" if args.scan else ""
    tag += "" if args.strategy == "neural" else f"_{args.strategy}"
    tag += "" if args.k == 3 else f"_k{args.k}"
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
