"""Smoke run of the PyTorch + CUDA port (sdpcutsel_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:
  1. environment: the card (nvidia-smi name and power limit), CUDA, nvcc,
     triton; no CUDA device -> exit 2 before any result is printed;
  2. build the four kernels from csrc/, one nvcc each, in parallel (timed
     as set-up), and beside them a variant of the scoring kernels without
     the Jacobi's overflow guard (scoring_variants.UNGUARDED); print
     ptxas's registers and spills, and for the scoring kernels (K1, K3, K4
     at k = 2..5) their persistent grid, their dynamic shared memory and
     the tensor-core (HMMA) instructions that cuobjdump finds in each (no
     TF32 HMMA, or a spill, fails);
  3. check each kernel against its plain PyTorch twin on the card at the
     main paths' shapes, and time both with CUDA events (the scoring
     kernels also on the device, with the profiler):
       pair_score   n = 125, all 317,750 candidates of spar125-100-1, and
                    the 1,140 of spar020-100-1 with 6 sweeps (checked only);
       pair_packed  n = 125, the 507,904 slots of the packed layout on
                    spar125-100-1's Q: the 317,750 valid ones against the
                    twin, and bit for bit against pair_score on the same
                    triples; the rest -inf;
       pdhg_block   n = 125, M = 1024 with 400 active unit k = 3 cuts, and
                    n = 100 with the 25 dense rows of qcqpband100-5-25-1 and
                    400 active k = 5 cuts (some supports repeat an index);
                    blocks of 7 and 100 iterations, two runs bit for bit, the
                    inputs unchanged; its cluster plan and ptxas report, and
                    the portable cluster of 8 checked and timed in turns
                    with the plan's;
     each kernel's time stands beside its bound (the largest of its
     operations over 67 TFLOP/s fp32, those it runs on the tensor cores over
     495 TFLOP/s dense TF32, and its bytes, each input read and each output
     written once, over 3.35 TB/s) and its roofline share;
       pdhg_block   batched: the twelve n = 125 instances of the suite bucket
                    (below), each with its own pool of 400 random active cuts,
                    one instance left out of the launch: against the twin, the
                    one left out unchanged bit for bit, every other one bit for
                    bit equal to a batch of one and to the single wrapper; the
                    clusters of 16 and of 8 the card runs at once; the batch
                    timed at a cluster of 16 and of 8, in turns;
       fused_score  k = 2 over C(125, 2) and k = 3 over C(30, 3) (5 sweeps);
                    k = 4 and 5 over the clique tables of qcqp025-25-4-2
                    and qcqpband100-5-25-1 (6 sweeps); with its launch grid;
     then the guard: K1 on all of C(125, 3) and K4 at k = 5 on both clique
     tables give the unguarded variant's bits (torch.equal), timed in turns
     (the variant's entry points called directly, outside the wrappers);
  4. the rounds on the card against the CPU port, 3 rounds each:
     spar020-100-1 at k = 3 and at k = 2, qcqp015-30-3-1 at k = 5; 2
     rounds of the packed route (generate_spar(70, 100, 1), feasibility);
     spar020-100-1 with strategies triangle, optimality and random, and
     neural with vertex steering (the random draws come from a CPU
     generator, so both devices see the same numbers); and spar150-100-1
     (generated), outside K2's launch plan: by default its solve refuses on
     the card with the plan's reason, and with LPConfig(use_kernel="off") 2
     rounds run the plain loop there, K2 not launched;
  5. the BoxQP main path: CutSolver on spar125-100-1, strategy neural,
     default cuts, LPConfig(max_iters=20000, tol=2e-6), 10 rounds, with the
     launch counters reset before and read after; the bounds are held to
     the instance registry (data/boxqp/bounds.json, optima.json), and a
     second run from a fresh solver must repeat the first bit for bit;
  6. the QCQP main path: CutSolverQCQP on qcqpband100-5-25-1 in the
     configuration of scripts/run_qcqp_suite.py (k = 5, sel_size 16,
     capacity 1024, LPConfig(max_iters=20000, tol=2e-6), polish 60,000
     iterations), 8 rounds, counters reset before and read after; the
     bounds are held to data/qcqp/bounds.json and to the JAX package's
     recorded round 0 (results/qcqp.jsonl), and a second run, round by
     round, must repeat the first bit for bit, polish included, while K4 is
     held to its twin at every round's LP point;
  7. the packed scan path: CutSolver on spar125-100-1 with
     CutConfig(pair_layout="packed"), strategy neural, the same LP,
     LoopConfig(use_scan=True), 10 rounds after a one-round warm-up, counters
     reset before and read after (pair_packed and pdhg_block launched,
     pair_score not); the same bound checks as phase 5, and a second scan
     run and a per-round run of the same configuration must both repeat
     every round bit for bit;
  8. the steered QCQP scan: phase 6's configuration with use_scan and
     steer_eps 1e-3 (4,000 steering iterations a round), 8 rounds and the
     polish, twice, bit for bit; K2 launched exactly once a round for
     steering beside the solves' blocks; every certificate >= sdp_lower;
     steering's time a round; a per-round run writing a snapshot every
     round repeats the scan bit for bit, and a fresh solver restored from
     round 4's snapshot repeats rounds 5-8 and the polish, gate state
     included;
  9. resume on the BoxQP main path: a run with a snapshot every round, and
     a fresh solver restored from round 5's, both repeat phase 5's rounds
     bit for bit;
 10. the strategies at full width, each run twice, bit for bit, every
     certificate valid: spar125-100-1 with triangle and random (5 rounds)
     and optimality (2 rounds, with the ADMM's time a round and its
     repeatability); qcqpband100-5-25-1 at k = 4 with feasibility, random
     and optimality (8 rounds and the polish); gap closed printed beside the
     JAX package's records (results/suite.jsonl, results/qcqp.jsonl);
 11. the batched suite bucket (parallel/round.py): the twelve
     spar125-{25,50,75,100}-{1,2,3} of data/boxqp as one batch in
     scripts/bench_batched.py --suite's configuration (capacity 1024, k = 3,
     lp_iters 400, sel_size 16, neural, Mesh(1, 1)), 10 per-round steps,
     certify_batched_f64: every certificate finite and >= the instance's
     best known (optima.json), the running bounds monotone, a second run
     bit for bit, instances 0 and 7 as batches of one within rtol 2e-3 (bit
     equality printed), gap closed printed; pdhg_block launched once a
     checked block of the batch, pair_score once an instance a round;
 12. bench.py:188-223's batched configuration: 8 x generate_spar(30, 100,
     s + 1), scan mode, 10 rounds, certify_scan_f64; the scan repeats its
     per-round run bit for bit; instance-rounds/s, the median of 3 after a
     warm-up, beside the card's name and power limit (not a benchmark line);
 13. scripts/bench_batched.py --qcqp at its defaults: generate_qcqp_family(30,
     30, 2, 1, 8), the chordal clique table at k = 4, 2 dense rows, 6
     per-round steps (K4 once an instance a round, the batched K2 with the
     dense rows), the first 2 rounds within rtol 2e-3 of the CPU port;
 14. one JSON line of kernel results, each kernel's launches summed over
     the main paths 5-13 (each counted from 0; K2's entry also holds the
     batched launch's time, bound and the clusters the card runs at once),
     then the last line {"ok": true, "device": {...}}.
Every path's launch counts include the solve's plain PDHG blocks on the
card ("pdhg_block plain") and the scoring twins called on the card
("twin-scored"), which must be 0 on every main path.

TF32 is turned off for the whole process at its start: the scoring twin's
MLP runs as cuBLAS matrix products, and it agrees with the kernel to 2e-4
only in full float32.  The solver itself does no cuBLAS product on CUDA.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from sdpcutsel_tpu_torch import _build
from sdpcutsel_tpu_torch.config import CutConfig, LoopConfig, LPConfig, RunConfig, ScorerConfig
from sdpcutsel_tpu_torch.cuts.enumerate import combinations_table
from sdpcutsel_tpu_torch.instances import (generate_qcqp_family, generate_spar,
                                           load_or_generate, load_or_generate_qcqp, parse_boxqp)
from sdpcutsel_tpu_torch.loop import CutSolver
from sdpcutsel_tpu_torch.lp.pdhg import (estimate_norm, estimate_norm_batched, init_state,
                                         solve_setup, steer_to_vertex)
from sdpcutsel_tpu_torch.lp import pdhg_kernel
from sdpcutsel_tpu_torch.lp.pdhg_kernel import (launch_plan, max_active_clusters, pdhg_block,
                                                pdhg_block_batched, pdhg_block_batched_plain,
                                                pdhg_block_plain, plan_refusal)
from sdpcutsel_tpu_torch.models.labels import EIGH_CHUNK
from sdpcutsel_tpu_torch.models.scorer import MLPScorer, load_params
from sdpcutsel_tpu_torch.ops.fused_score import fused_score, fused_score_plain
from sdpcutsel_tpu_torch.ops.pair_packed import packed_layout, packed_score, packed_score_plain
from sdpcutsel_tpu_torch.ops.pair_score import pair_score, pair_score_plain
from sdpcutsel_tpu_torch.parallel import make_mesh, shard_candidates
from sdpcutsel_tpu_torch.parallel.round import (certify_batched_f64, certify_scan_f64,
                                                init_batched_state, make_sharded_round_step,
                                                make_sharded_scan_step)
from sdpcutsel_tpu_torch.qcqp import CutSolverQCQP
from sdpcutsel_tpu_torch.qcqp.chordal import chordal_decomposition, clique_candidates
from sdpcutsel_tpu_torch.qcqp.solver import SWEEPS as QCQP_SWEEPS
from sdpcutsel_tpu_torch.relax import batched as rb
from sdpcutsel_tpu_torch.relax.cutbuffer import append_cuts, build_cut_index, empty_pool
from sdpcutsel_tpu_torch.relax.denserows import batched_dense_from_qcqp, dense_from_qcqp
from sdpcutsel_tpu_torch.scoring_variants import (UNGUARDED, clique_table, device_ms,
                                                  fused_args, k1_call, k4_call, scoring_point,
                                                  start_variants)

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "data", "boxqp")
INSTANCE = "spar125-100-1"
ROUNDS = 10
QCQP_INSTANCE = "qcqpband100-5-25-1"
QCQP_ROUNDS = 8
BOXQP_LP = LPConfig(max_iters=20000, tol=2e-6)      # bench.py's suite LP config
QCQP_CFG = RunConfig(lp=LPConfig(max_iters=20000, tol=2e-6),
                     cuts=CutConfig(k=5, sel_size=16, capacity=1024),
                     loop=LoopConfig(polish_iters=60000))
# the steered QCQP scan: results/qcqp_parity.jsonl:28's steer_eps, the
# default 4,000 steering iterations a round
QCQP_STEER_CFG = dataclasses.replace(QCQP_CFG, loop=dataclasses.replace(
    QCQP_CFG.loop, use_scan=True, steer_eps=1e-3))
RESUME_AT = {"qcqp": 4, "boxqp": 5}          # rounds before the snapshot a run resumes from
BOXQP_STRATEGY_ROUNDS = {"triangle": 5, "random": 5, "optimality": 2}
QCQP_STRATEGIES = ("feasibility", "random", "optimality")     # at k = 4, QCQP_ROUNDS each
SNAPSHOTS = os.path.join(REPO, "build", "chip_smoke_snapshots")
# the batched paths (parallel/round.py): scripts/bench_batched.py's defaults
# (lp_iters 400, sel_size 16, neural; capacity 1024) on a 1 x 1 mesh
SUITE_BUCKET = [f"spar125-{d}-{s}" for d in (25, 50, 75, 100) for s in (1, 2, 3)]
SUITE_ALONE = (0, 7)                  # bucket instances also run as batches of one
BATCH_ROUNDS = 10
BATCH_KNOBS = dict(lp_iters=400, sel_size=16, strategy="neural")
BENCH_BATCH = (30, 8)                 # bench.py:188-223: 8 x generate_spar(30, 100, s + 1)
QCQP_FAMILY = (30, 30, 2, 1, 8)       # generate_qcqp_family(n, density, m, seed, B), --qcqp
QCQP_FAMILY_ROUNDS, QCQP_FAMILY_CPU_ROUNDS = 6, 2
SEED = 0
# H100 SXM peaks (NVIDIA's data sheet): fp32 outside the tensor cores, dense
# TF32 on the tensor cores, HBM3
PEAK_FLOPS = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# K2's microseconds an iteration before the cluster design (PERF.md, PR 3)
K2_PR3_US = {0: 35.11, 25: 72.39}
# the main paths' final bounds as PERF.md records them, printed beside this run's
BOXQP_RECORDED_FINAL = 46173.94073905878
QCQP_RECORDED_FINAL = 2996.008999203225
WRAPPERS = {"pair_score": pair_score, "pair_packed": packed_score,
            "pdhg_block": pdhg_block, "fused_score": fused_score}
PLAIN_BLOCKS = "pdhg_block plain"     # the solve's plain PDHG blocks on the card
TWIN_SCORED = "twin-scored"           # scoring twins called on the card (use_fused=False)
PATH_LAUNCHES: dict = {}              # main path -> its launch counts (launch_counts())
SMI = ""                              # the card's nvidia-smi name and power limit
SCORING_KERNELS = ("pair_score_kernel", "pair_packed_kernel",
                   *(f"fused_score_kernelILi{k}E" for k in (2, 3, 4, 5)))


def log(*args):
    print(*args, flush=True)


def environment() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    nvcc_v = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                            timeout=60).stdout.strip().splitlines()
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "absent"
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} triton {triton_v}")
    log(f"[env] nvcc: {nvcc_v[-1] if nvcc_v else 'absent'}")
    log(f"[env] device 0: {torch.cuda.get_device_name(0)}; count "
        f"{torch.cuda.device_count()}")
    return smi


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call from CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def excess(got, want, rtol: float, atol: float):
    """(max |got - want|, max |got - want| / (atol + rtol |want|)); the
    second is <= 1 exactly when allclose(got, want, rtol, atol) holds."""
    d = (got - want).abs()
    return float(d.max()), float((d / (atol + rtol * want.abs())).max())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, moved: int, tc_flops: float = 0.0) -> dict:
    """The least time the card could take: the largest of the operations
    outside the tensor cores over the fp32 peak, those on the tensor cores
    over the dense TF32 peak, and the bytes (each input read once, each
    output written once) over the memory rate."""
    t_ops = max(flops / PEAK_FLOPS, tc_flops / PEAK_TF32) * 1e3
    t_bytes = moved / PEAK_BYTES * 1e3
    return ({"bound_ms": t_ops, "bound_by": "operations"} if t_ops >= t_bytes
            else {"bound_ms": t_bytes, "bound_by": "bytes"})


def score_ops(k: int, sweeps: int) -> int:
    """Operations to score one candidate of width k: the features, `sweeps`
    cyclic Jacobi sweeps on the (k + 1) x (k + 1) Z(rho) (about 18 + 6 (M - 2)
    per rotation), and the F-64-64-1 relu MLP (csrc/score_common.cuh)."""
    M, F = k + 1, k * (k + 1) + k
    jacobi = sweeps * M * (M - 1) // 2 * (18 + 6 * (M - 2)) + M - 1
    mlp = 2 * 64 * F + 2 * 64 * 64 + 2 * 64 + 4 * 64 + 3
    return jacobi + mlp + 3 * (k * (k + 1) // 2)


def mlp_product_ops(k: int) -> int:
    """The MLP's products F -> 64 and 64 -> 64 a candidate of width k, which
    the scoring kernels run on the tensor cores (the three passes of split
    TF32 are the kernels' own cost, not more work)."""
    return 2 * 64 * (k * (k + 1) + k) + 2 * 64 * 64


def scoring_bound(T: int, moved: int, ms: float, k: int = 3,
                  sweeps: int = 5) -> tuple[dict, str]:
    """A scoring kernel's bound for T candidates of width k: the MLP's
    products on the tensor cores, the rest of score_ops(k, sweeps) at fp32,
    the bytes; and the three times, with the earlier bound (every operation
    at fp32) beside."""
    tc = T * mlp_product_ops(k)
    rest = T * score_ops(k, sweeps) - tc
    fp32_only = bound(T * score_ops(k, sweeps), moved)["bound_ms"]
    return bound(rest, moved, tc), (
        f"TF32 products {tc / PEAK_TF32 * 1e3:.5f} ms, the rest at fp32 "
        f"{rest / PEAK_FLOPS * 1e3:.5f} ms, bytes {moved / PEAK_BYTES * 1e3:.5f} ms; "
        f"every operation at fp32 (the earlier count) {fp32_only:.5f} ms, share "
        f"{fp32_only / ms:.4%}")


def mlp_bytes(mlp) -> int:
    return nbytes(*mlp.parameters())


def share(ms: float, b: dict) -> str:
    return (f"bound {b['bound_ms']:.5f} ms ({b['bound_by']}); roofline share "
            f"{b['bound_ms'] / ms:.4%}")


def reset_launches():
    for fn in WRAPPERS.values():
        fn.launches = 0
    pdhg_block.plain_launches = pair_score.plain_launches = fused_score.plain_launches = 0


def launch_counts() -> dict:
    return {**{name: fn.launches for name, fn in WRAPPERS.items()},
            PLAIN_BLOCKS: pdhg_block.plain_launches,
            TWIN_SCORED: pair_score.plain_launches + fused_score.plain_launches}


def k1_twin_check(label: str, inst, sweeps: int, dev):
    """K1 against its twin on all C(n, 3) triples of ``inst`` at the
    scoring point: feas atol 5e-5, nn rtol/atol 2e-4 (tests/test_pair_score.py)."""
    x, X, Q = scoring_point(inst, dev)
    table = torch.as_tensor(combinations_table(inst.n, 3), device=dev)
    mlp = MLPScorer(load_params(3), dev)
    nn_k, feas_k = pair_score(x, X, Q, table, mlp, sweeps)
    nn_p, feas_p = pair_score_plain(x, X, Q, table, mlp, sweeps)
    torch.cuda.synchronize()
    err_f, r_f = excess(feas_k, feas_p, 0.0, 5e-5)
    err_n, r_n = excess(nn_k, nn_p, 2e-4, 2e-4)
    log(f"[pair_score {label}] T={table.shape[0]} sweeps={sweeps} feas max|err| {err_f:.3e} "
        f"(atol 5e-5: {r_f:.3f} of limit); nn max|err| {err_n:.3e} (rtol/atol 2e-4: "
        f"{r_n:.3f} of limit)")
    if not (r_f <= 1.0 and r_n <= 1.0):
        raise AssertionError(f"pair_score kernel disagrees with its twin ({label})")
    return (x, X, Q, table, mlp), max(err_f, err_n), nbytes(x, X, Q, table, nn_k, feas_k)


def check_pair_score(inst, small, dev) -> dict:
    """K1 at n = 125 (checked and timed) and on the small instance of the
    card-against-CPU phase with 6 sweeps (checked)."""
    args, err, moved = k1_twin_check(inst.name, inst, 5, dev)
    _, err_small, _ = k1_twin_check(small.name, small, 6, dev)
    x, X, Q, table, mlp = args
    ms = cuda_ms(lambda: pair_score(*args), reps=50)
    dev_ms = device_ms(lambda: pair_score(*args), "pair_score_kernel")
    plain_ms = cuda_ms(lambda: pair_score_plain(*args), reps=5)
    T = table.shape[0]
    b, parts = scoring_bound(T, moved + mlp_bytes(mlp), ms)
    log(f"[pair_score] kernel {ms:.4f} ms by events ({T / ms / 1e3:.1f} M cand/s), "
        f"{dev_ms:.4f} ms on the device (profiler); twin {plain_ms:.4f} ms "
        f"({T / plain_ms / 1e3:.1f} M cand/s); {share(ms, b)}; {parts}")
    return {"max_abs_err": max(err, err_small), "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, **b}


def check_pair_packed(inst, dev) -> dict:
    """K3 against its twin on every valid slot (the K1 tolerances), -inf at
    every other slot, and bit for bit against K1 on the same triples."""
    x, X, Q = scoring_point(inst, dev)
    lay = packed_layout(inst.n, dev)
    mlp = MLPScorer(load_params(3), dev)
    nn_k, feas_k = packed_score(x, X, Q, lay, mlp)
    nn_p, feas_p = packed_score_plain(x, X, Q, lay, mlp)
    triples = lay.table[lay.valid]
    nn_1, feas_1 = pair_score(x, X, Q, triples, mlp)
    torch.cuda.synchronize()
    v = lay.valid
    err_f, r_f = excess(feas_k[v], feas_p[v], 0.0, 5e-5)
    err_n, r_n = excess(nn_k[v], nn_p[v], 2e-4, 2e-4)
    inf_ok = bool((nn_k[~v] == -torch.inf).all() and (feas_k[~v] == -torch.inf).all())
    vs_k1 = max(float((nn_k[v] - nn_1).abs().max()), float((feas_k[v] - feas_1).abs().max()))
    log(f"[pair_packed] slots {lay.slots} (tiers of {lay.R} rows), valid {int(v.sum())}: "
        f"feas max|err| {err_f:.3e} (atol 5e-5: {r_f:.3f} of limit); nn max|err| "
        f"{err_n:.3e} (rtol/atol 2e-4: {r_n:.3f} of limit); invalid slots all -inf: "
        f"{inf_ok}; largest difference from pair_score on the same triples {vs_k1!r}")
    n = inst.n
    if not (r_f <= 1.0 and r_n <= 1.0 and inf_ok and triples.shape[0] == n * (n - 1) * (n - 2) // 6):
        raise AssertionError("pair_packed kernel disagrees with its twin")
    if vs_k1 != 0.0:      # both kernels run score_mma.cuh::score_warp
        raise AssertionError("pair_packed kernel does not give pair_score's bits")
    # in turns: K3, K1 on the same triples, K1, K3
    k3_ms, k1_ms = [], []
    for runs, fn in ((k3_ms, lambda: packed_score(x, X, Q, lay, mlp)),
                     (k1_ms, lambda: pair_score(x, X, Q, triples, mlp)),
                     (k1_ms, lambda: pair_score(x, X, Q, triples, mlp)),
                     (k3_ms, lambda: packed_score(x, X, Q, lay, mlp))):
        runs.append(cuda_ms(fn, reps=50))
    ms = sum(k3_ms) / 2
    dev_ms = device_ms(lambda: packed_score(x, X, Q, lay, mlp), "pair_packed_kernel")
    plain_ms = cuda_ms(lambda: packed_score_plain(x, X, Q, lay, mlp), reps=5)
    # the valid slots' work; every slot writes its two scores
    b, parts = scoring_bound(triples.shape[0], nbytes(
        x, X, Q, lay.valid_slots, lay.rows, lay.iu, lay.ju, nn_k, feas_k) + mlp_bytes(mlp), ms)
    log(f"[pair_packed] kernel {ms:.4f} ms by events ({triples.shape[0] / ms / 1e3:.1f} M "
        f"valid cand/s), {dev_ms:.4f} ms on the device (profiler); in turns K3 {k3_ms!r} ms, "
        f"pair_score on the same triples {k1_ms!r} ms (K3 / K1 "
        f"{sum(k3_ms) / sum(k1_ms):.4f}); twin {plain_ms:.4f} ms; {share(ms, b)}; {parts}")
    return {"max_abs_err": max(err_f, err_n), "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, **b}


def random_pool(table: np.ndarray, M: int, active: int, rng, dev):
    """``active`` random unit-norm cuts on distinct rows of ``table`` (the
    candidate supports) in a pool of M."""
    k = table.shape[1]
    idx = table[rng.choice(table.shape[0], active, replace=False)]
    lin = rng.standard_normal((active, k))
    quad = rng.standard_normal((active, k, k))
    quad = 0.5 * (quad + quad.transpose(0, 2, 1))
    nrm = np.sqrt((lin ** 2).sum(1) + (quad ** 2).sum((1, 2)))
    cuts = (idx, lin / nrm[:, None], quad / nrm[:, None, None],
            -0.1 * rng.random(active) / nrm, np.ones(active))
    return append_cuts(empty_pool(M, k, dev), *(
        torch.as_tensor(a, dtype=torch.int64 if a.dtype.kind == "i" else torch.float32,
                        device=dev) for a in cuts))


def random_state(n: int, M: int, m: int, pool, rng, dev):
    """A random PDHG state for K2's checks: x, X in [0, 1], small duals,
    yC on the pool's active slots."""
    st = init_state(n, M, dev, m)
    X = rng.random((n, n))
    f32 = dict(dtype=torch.float32, device=dev)
    st.x = torch.as_tensor(rng.random(n), **f32)
    st.X = torch.as_tensor(0.5 * (X + X.T), **f32)
    st.yA = torch.as_tensor(0.1 * rng.random((n, n)), **f32)
    st.yB = torch.as_tensor(0.1 * rng.random((n, n)), **f32)
    st.yC = torch.as_tensor(0.05 * rng.random(M), **f32) * pool.active
    st.yD = torch.as_tensor(0.2 * rng.random(m), **f32)
    return st


def pdhg_ops(n: int, k: int, m: int, active: int, terms: int, iters: int) -> int:
    """Operations of `iters` iterations of lp/pdhg.py::_one_iter: about 31
    an (n, n) entry (adjoint, pre-step, projection, extrapolation, dual
    ascent, sums) and 4 m more for the dense adjoint and residuals, 2 a
    cut-index term, 2 k + 2 k^2 + 6 an active cut, 10 + 2 m an x entry."""
    return iters * (n * n * (31 + 4 * m) + 2 * terms + active * (2 * k + 2 * k * k + 6)
                    + n * (10 + 2 * m) + 4 * m)


def sass_mma(kernels) -> dict:
    """The tensor-core instructions (HMMA, HGMMA) of each kernel in the built
    library, from cuobjdump -sass: {kernel: {opcode: count}}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", _build.library_path()], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, current = {k: {} for k in kernels}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((k for k in kernels if k in line), None)
        elif current is not None:
            for word in line.replace(";", " ").split():
                if word.startswith(("HMMA", "HGMMA")):
                    counts[current][word] = counts[current].get(word, 0) + 1
    return counts


def scoring_grid(kernel: str) -> tuple:
    """(CTAs the card holds, threads a CTA, dynamic shared bytes a CTA) of a
    scoring kernel's persistent launch (SCORING_KERNELS names)."""
    out = (ctypes.c_int * 3)()
    lib = _build.lib()
    if kernel.startswith("fused_score"):
        err = lib.fused_score_grid(int(kernel[-2]), out)
    else:
        err = getattr(lib, kernel.replace("_kernel", "_grid"))(out)
    _build.check(err, f"{kernel} grid")
    return tuple(out)


def tensor_core_kernels():
    """ptxas's registers and spills, the persistent grid and the dynamic
    shared memory of K1, K3 and K4 at k = 2..5, and the tensor-core
    instructions in each; fails unless every one runs its products on the
    tensor cores without spilling."""
    sass = sass_mma(SCORING_KERNELS)
    for name in SCORING_KERNELS:
        ctas, threads, smem = scoring_grid(name)
        ptxas = ptxas_report(name)
        log(f"[build] {name}: {ptxas}; persistent grid {ctas} CTAs x {threads} threads, "
            f"{smem} bytes of dynamic shared memory a CTA; tensor-core instructions "
            f"{sass[name]}")
        if not any(op.startswith("HMMA") and "TF32" in op for op in sass[name]):
            raise AssertionError(f"{name} has no TF32 HMMA instruction")
        if "spill" in ptxas and "0 bytes spill stores" not in ptxas:
            raise AssertionError(f"{name} spills registers: {ptxas}")


def ptxas_report(kernel: str) -> str:
    """Registers, stack and spills of one kernel from the nvcc -Xptxas -v log."""
    lines, on = [], False
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            on = kernel in line
        elif on and ("registers" in line or "spill" in line):
            lines.append(line.split(":", 1)[-1].strip())
    return "; ".join(lines) or "not in this process's build log"


def check_pdhg_block(label: str, Q, c, table, dense, dev) -> dict:
    """K2 against its twin from a random state, M = 1024 with 400 active
    cuts on rows of ``table``, and the dense rows ``dense`` (or none); then
    the cluster launch's plan, its time beside the bound and PR 3's, and the
    portable cluster of 8 timed in turns with the plan's."""
    n, M = c.shape[0], 1024
    m = 0 if dense is None else dense.m
    rng = np.random.default_rng(SEED + 1)
    pool = random_pool(table, M, 400, rng, dev)
    k = pool.idx.shape[1]
    st = random_state(n, M, m, pool, rng, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    cx = torch.as_tensor(-c, **f32)
    cX = torch.as_tensor(-0.5 * Q, **f32)
    index = build_cut_index(pool, n)
    eta = 0.95 / estimate_norm(pool, n, 30, torch.Generator().manual_seed(0), index,
                               dense)
    zero = st.map(torch.zeros_like)
    args = (cx, cX, pool, index, st, zero, eta, eta)
    inputs = [t.clone() for t in (*st.fields(), *zero.fields())]
    # 7 iterations: the reference's own kernel tolerance (tests/test_pdhg_kernel.py).
    # 100 iterations (one checked block of the solve): PDHG is nonexpansive, so
    # f32 rounding differences add up rather than multiply; the 7-iteration
    # tolerance scaled linearly to 100 iterations is 3e-4, and the ergodic sums
    # of 100 iterates take 100 x that as atol.
    nf = len(st.fields())

    def compare(got, want, tol_st, tol_acc):
        errs, ratio = [], 0.0
        for (g, w), (rtol, atol) in zip([*zip(got[0].fields(), want[0].fields()),
                                         *zip(got[1].fields(), want[1].fields())],
                                        [tol_st] * nf + [tol_acc] * nf):
            if g.numel():
                e, r = excess(g, w, rtol, atol)
                errs.append(e)
                ratio = max(ratio, r)
        return errs, ratio

    worst = 0.0
    for iters, tol_st, tol_acc in [(7, (2e-5, 2e-5), (2e-5, 2e-5)),
                                   (100, (3e-4, 3e-4), (3e-4, 3e-2))]:
        got = pdhg_block(*args, iters, dense)
        want = pdhg_block_plain(*args, iters, dense)
        torch.cuda.synchronize()
        errs, ratio = compare(got, want, tol_st, tol_acc)
        log(f"[pdhg_block {label}] {iters} iterations: max|err| state "
            f"{max(errs[:len(errs) // 2]):.3e} sums {max(errs[len(errs) // 2:]):.3e}; "
            f"{ratio:.3f} of the limit (state rtol/atol {tol_st}, sums {tol_acc})")
        if ratio > 1.0:
            raise AssertionError(f"pdhg_block kernel disagrees with its twin at {iters} "
                                 f"iterations ({label})")
        worst = max(worst, *errs)
    unchanged = all(torch.equal(a, b) for a, b in zip(
        [*st.fields(), *zero.fields()], inputs))
    first = pdhg_block(*args, 100, dense)
    again = pdhg_block(*args, 100, dense)
    same = all(torch.equal(a, b) for a, b in zip([*first[0].fields(), *first[1].fields()],
                                                 [*again[0].fields(), *again[1].fields()]))
    log(f"[pdhg_block {label}] two 100-iteration runs bit-identical: {same}; inputs "
        f"unchanged: {unchanged}")
    if not (same and unchanged):
        raise AssertionError(f"pdhg_block kernel is not deterministic or wrote its "
                             f"inputs ({label})")

    plan = launch_plan(n, M, k, m)
    log(f"[pdhg_block {label}] cluster of {plan.cluster} CTAs x 512 threads: {plan.rows} "
        f"rows and {plan.slots} pool slots a CTA, {plan.smem_bytes} bytes of shared "
        f"memory a CTA ({plan.term_cap} cut-index terms); ptxas: "
        f"{ptxas_report('pdhg_cluster_kernel')}")
    # the portable cluster of 8 against the plan's, held to the same tolerance,
    # then both timed in turns (plan, 8, 8, plan)
    portable = pdhg_kernel._launch(*args, 100, dense, cluster=8)
    errs8, ratio8 = compare(portable, want, (3e-4, 3e-4), (3e-4, 3e-2))
    log(f"[pdhg_block {label}] cluster of 8 ({launch_plan(n, M, k, m, 8).smem_bytes} "
        f"bytes a CTA), 100 iterations: max|err| {max(errs8):.3e}; {ratio8:.3f} of the limit")
    if ratio8 > 1.0:
        raise AssertionError(f"pdhg_block with a cluster of 8 disagrees with its twin ({label})")
    t_plan, t_8 = [], []
    for order in ((t_plan, plan.cluster), (t_8, 8), (t_8, 8), (t_plan, plan.cluster)):
        order[0].append(cuda_ms(lambda: pdhg_kernel._launch(*args, 100, dense,
                                                            cluster=order[1]), reps=20))
    ms = cuda_ms(lambda: pdhg_block(*args, 100, dense), reps=20)
    plain_ms = cuda_ms(lambda: pdhg_block_plain(*args, 100, dense), reps=3, warmup=1)
    b = bound(pdhg_ops(n, k, m, int(pool.active.sum()),
                       index.Xcut.numel() + index.xcut.numel(), 100),
              nbytes(cx, cX, index.idx, pool.lin, pool.quad, pool.rhs, pool.active,
                     index.xoff, index.xcut, index.xcoef, index.Xoff, index.Xcut,
                     index.Xcoef, *inputs, *first[0].fields(), *first[1].fields(),
                     *([] if dense is None else [dense.G, dense.g, dense.h])))
    log(f"[pdhg_block {label}] 100-iteration block: kernel {ms:.4f} ms ({ms * 10:.3f} "
        f"us/iter; PR 3's single CTA: {K2_PR3_US[m]} us/iter); twin {plain_ms:.4f} ms "
        f"({plain_ms * 10:.2f} us/iter); {share(ms, b)} ({b['bound_ms'] * 10:.5f} us/iter)")
    log(f"[pdhg_block {label}] in turns: cluster of {plan.cluster} {t_plan!r} ms, "
        f"cluster of 8 {t_8!r} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **b}


def check_pdhg_block_batched(insts, single: dict, dev) -> dict:
    """K2's instance axis at the suite bucket's shape: the B = 12 instances'
    Q and c, each with its own pool of M = 1024 and 400 active random k = 3
    cuts and a random state, one instance left out of ``ids``.  Against the
    twin (pdhg_block_plain on each listed instance) at the single phase's
    tolerances, 7 and 100 iterations; the instance left out unchanged bit for
    bit; every listed instance bit for bit equal to a B = 1 launch of it and
    to the single wrapper on its own cut index; how many clusters of 16 and
    of 8 the card runs at once; 100-iteration launches of all 12 at the
    plan's cluster and at 8, in turns, beside B x the single launch's time
    and bound."""
    B, n, M = len(insts), insts[0].n, 1024
    rng = np.random.default_rng(SEED + 2)
    table = combinations_table(n, 3)
    pools = [random_pool(table, M, 400, rng, dev) for _ in insts]
    P = rb.stack(pools)
    st = rb.stack([random_state(n, M, 0, p, rng, dev) for p in pools])
    acc = st.map(torch.zeros_like)
    f32 = dict(dtype=torch.float32, device=dev)
    cx = torch.as_tensor(np.stack([-i.c for i in insts]), **f32)
    cX = torch.as_tensor(np.stack([-0.5 * i.Q for i in insts]), **f32)
    index = rb.build_cut_index(P, n)
    eta = (np.float32(0.95) / estimate_norm_batched(
        P, n, 30, torch.Generator().manual_seed(0), index).cpu().numpy()).astype(np.float32)
    frozen = B // 2 - 1
    ids = [b for b in range(B) if b != frozen]
    inputs = [t.clone() for t in (*st.fields(), *acc.fields())]
    args = (cx, cX, P, index, st, acc, eta, eta)
    worst = 0.0
    for iters, tol_st, tol_acc in [(7, (2e-5, 2e-5), (2e-5, 2e-5)),
                                   (100, (3e-4, 3e-4), (3e-4, 3e-2))]:
        got = pdhg_block_batched(*args, iters, ids)
        want = pdhg_block_batched_plain(*args, iters, ids)
        torch.cuda.synchronize()
        ratio, errs = 0.0, []
        for g, w, tol in zip([*got[0].fields(), *got[1].fields()],
                             [*want[0].fields(), *want[1].fields()], [tol_st] * 6 + [tol_acc] * 6):
            if g.numel():
                e, r = excess(g[ids], w[ids], *tol)
                errs.append(e)
                ratio = max(ratio, r)
        frozen_same = all(torch.equal(g[frozen], w[frozen]) for g, w in zip(
            [*got[0].fields(), *got[1].fields()], inputs))
        alone = single_too = True
        for b in ids:
            one = pdhg_kernel._launch_batched(*(t[b:b + 1] for t in (cx, cX)),
                                              *(rb.instance(o, slice(b, b + 1))
                                                for o in (P, index, st, acc)),
                                              eta[b:b + 1], eta[b:b + 1], iters, [0], None)
            ref = pdhg_block(cx[b], cX[b], pools[b], build_cut_index(pools[b], n),
                             rb.instance(st, b), rb.instance(acc, b), float(eta[b]),
                             float(eta[b]), iters)
            outs = [t[b] for t in (*got[0].fields(), *got[1].fields())]
            alone &= all(torch.equal(u[0], v) for u, v in zip((*one[0].fields(),
                                                               *one[1].fields()), outs))
            single_too &= all(torch.equal(u, v) for u, v in zip((*ref[0].fields(),
                                                                 *ref[1].fields()), outs))
        log(f"[pdhg_block batched] B={B}, n={n}, M={M}, {iters} iterations, instance {frozen} "
            f"left out: max|err| {max(errs):.3e}, {ratio:.3f} of the limit (state {tol_st}, "
            f"sums {tol_acc}); the instance left out unchanged bit for bit: {frozen_same}; "
            f"each listed instance equal to a B = 1 launch of it: {alone}, and to the single "
            f"wrapper on its own cut index: {single_too}")
        if not (ratio <= 1.0 and frozen_same and alone and single_too):
            raise AssertionError(f"the batched pdhg_block fails its checks at {iters} iterations")
        worst = max(worst, *errs)
    unchanged = all(torch.equal(a, b) for a, b in zip([*st.fields(), *acc.fields()], inputs))
    clusters = {c: max_active_clusters(n, M, 3, 0, B, c) for c in (16, 8)}
    everyone = list(range(B))
    t16, t8 = [], []
    for runs, c in ((t16, 16), (t8, 8), (t8, 8), (t16, 16)):
        runs.append(cuda_ms(lambda: pdhg_kernel._launch_batched(*args, 100, everyone, None, c),
                            reps=20))
    ms, ms8 = sum(t16) / 2, sum(t8) / 2
    out = pdhg_block_batched(*args, 100, everyone)
    b = bound(sum(pdhg_ops(n, 3, 0, int(p.active.sum()), int(i.xoff[-1] + i.Xoff[-1]), 100)
                  for p, i in ((p, build_cut_index(p, n)) for p in pools)),
              nbytes(cx, cX, index.idx, P.lin, P.quad, P.rhs, P.active, index.xoff,
                     index.xcut, index.xcoef, index.Xoff, index.Xcut, index.Xcoef, *inputs,
                     *out[0].fields(), *out[1].fields()))
    log(f"[pdhg_block batched] inputs unchanged: {unchanged}; clusters the card runs at once "
        f"(cudaOccupancyMaxActiveClusters, a grid of {B}): {clusters[16]} of 16 CTAs, "
        f"{clusters[8]} of 8")
    log(f"[pdhg_block batched] 100-iteration launch of all {B}: cluster of 16 {ms:.4f} ms = "
        f"{ms * 10:.3f} us a batched iteration, {ms * 10 / B:.4f} us an instance-iteration; "
        f"cluster of 8 {ms8:.4f} ms = {ms8 * 10:.3f} us, {ms8 * 10 / B:.4f} us an "
        f"instance-iteration (in turns: 16 {t16!r} ms, 8 {t8!r} ms); B x the single launch "
        f"{B * single['ms']:.4f} ms ({B * single['ms'] * 10:.3f} us a batched iteration); "
        f"bound {b['bound_ms']:.5f} ms ({b['bound_by']}; B x the single bound "
        f"{B * single['bound_ms']:.5f}); roofline share {b['bound_ms'] / ms:.4%}")
    if not unchanged:
        raise AssertionError("the batched pdhg_block wrote its inputs")
    return {"batch": B, "batched_ms": ms, "batched_cluster8_ms": ms8,
            "batched_bound_ms": b["bound_ms"], "batched_bound_by": b["bound_by"],
            "max_active_clusters": clusters[16], "max_active_clusters_8": clusters[8],
            "batched_max_abs_err": worst}


def check_fused_score(label: str, Q, table: np.ndarray, sweeps: int, dev) -> dict:
    """K4 against its twin at the reference's kernel tolerances
    (tests/test_fused_score.py): feas atol 5e-4, nn rtol 2e-4 / atol 2e-5;
    its launch grid, its time by events and on the device, its bound."""
    args = fused_args(Q, table, sweeps, dev)
    x, X, table, triQ, scale, mlp, _ = args
    T, k = table.shape
    nn_k, feas_k = fused_score(*args)
    nn_p, feas_p = fused_score_plain(*args)
    torch.cuda.synchronize()
    err_f, r_f = excess(feas_k, feas_p, 0.0, 5e-4)
    err_n, r_n = excess(nn_k, nn_p, 2e-4, 2e-5)
    ms = cuda_ms(lambda: fused_score(*args), reps=50)
    dev_ms = device_ms(lambda: fused_score(*args), "fused_score_kernel")
    plain_ms = cuda_ms(lambda: fused_score_plain(*args), reps=5)
    ctas, threads, smem = scoring_grid(f"fused_score_kernelILi{k}E")
    b, parts = scoring_bound(T, nbytes(x, X, table, triQ, scale, nn_k, feas_k)
                             + mlp_bytes(mlp), dev_ms, k, sweeps)
    log(f"[fused_score {label}] k={k} T={T} sweeps={sweeps}: {min(ctas, -(-T // 32))} CTAs "
        f"x {threads} threads ({-(-T // 32)} tiles of 32, {smem} bytes of shared memory a "
        f"CTA); feas max|err| {err_f:.3e} ({r_f:.3f} of atol 5e-4); nn max|err| "
        f"{err_n:.3e} ({r_n:.3f} of rtol 2e-4 / atol 2e-5); kernel {ms:.4f} ms by events "
        f"({T / ms / 1e3:.1f} M cand/s), {dev_ms:.4f} ms on the device (profiler); twin "
        f"{plain_ms:.4f} ms; on the device time {share(dev_ms, b)}; {parts}")
    if not (r_f <= 1.0 and r_n <= 1.0):
        raise AssertionError(f"fused_score kernel disagrees with its twin ({label}, k={k})")
    return {"max_abs_err": max(err_f, err_n), "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, **b}


def check_k4(inst, dev) -> list:
    """K4 at the shapes of its callers: k = 2 over C(125, 2) (5 sweeps), k = 4
    and 5 over the clique tables of qcqp025-25-4-2 and qcqpband100-5-25-1 (6
    sweeps), and k = 3 over C(30, 3) (5 sweeps; no main path takes it).  The
    last entry is the QCQP main path's shape."""
    small = generate_spar(30, 100, 1)
    out = [check_fused_score(f"C({inst.n},2)", inst.Q, combinations_table(inst.n, 2), 5, dev),
           check_fused_score("C(30,3)", small.Q, combinations_table(30, 3), 5, dev)]
    for name in ("qcqp025-25-4-2", QCQP_INSTANCE):
        q = load_or_generate_qcqp(name)
        for k in (4, 5):
            out.append(check_fused_score(name, q.Q0, clique_table(q, k), 6, dev))
    return out


def check_guard(inst, unguarded, dev):
    """The overflow guard of score_common.cuh::rotate keeps the bits of the
    build without it (``unguarded``, scoring_variants.UNGUARDED): K1 on all
    C(n, 3) triples of ``inst`` at the scoring point, and K4 at k = 5 on the
    clique tables of qcqpband100-5-25-1 and qcqp025-25-4-2 (torch.equal on
    nn and feas); each timed on the device (profiler) in turns, guarded,
    unguarded, unguarded, guarded."""
    x, X, Q = scoring_point(inst, dev)
    table = torch.as_tensor(combinations_table(inst.n, 3), device=dev)
    mlp = MLPScorer(load_params(3), dev)
    cases = [(f"K1 {inst.name}", "pair_score_kernel",
              lambda lib: k1_call(lib, x, X, Q, table, mlp, 5))]
    for name in (QCQP_INSTANCE, "qcqp025-25-4-2"):
        q = load_or_generate_qcqp(name)
        args = fused_args(q.Q0, clique_table(q, 5), 6, dev)
        cases.append((f"K4 {name} k=5", "fused_score_kernel",
                      lambda lib, a=args: k4_call(lib, *a)))
    built = _build.lib()
    for label, kernel, call in cases:
        calls = {"guarded": call(built), "unguarded": call(unguarded)}
        for run, *_ in calls.values():
            run()
        same = all(torch.equal(a, b) for a, b in zip(calls["guarded"][1:],
                                                     calls["unguarded"][1:]))
        guarded, plain = [], []
        for runs, which in ((guarded, "guarded"), (plain, "unguarded"), (plain, "unguarded"),
                            (guarded, "guarded")):
            runs.append(device_ms(calls[which][0], kernel))
        log(f"[guard] {label}: nn and feas bit for bit equal to the unguarded build: {same}; "
            f"on the device in turns guarded {guarded!r} ms, unguarded {plain!r} ms (guarded / "
            f"unguarded {sum(guarded) / sum(plain):.4f})")
        if not same:
            raise AssertionError(f"the overflow guard changes the scores ({label})")


def check_large_instance(dev):
    """A BoxQP solve outside K2's launch plan (n = 150 > 128), spar150-100-1
    (generated): by default the solve refuses on the card with the plan's
    reason, K2 not launched; with LPConfig(use_kernel="off") 2 rounds run
    the plain loop on the card, against the CPU port."""
    inst = load_or_generate("spar150-100-1")
    lp = LPConfig(max_iters=3000, tol=1e-5)
    why = plan_refusal(inst.n, CutConfig().capacity, 3, 0)
    reset_launches()
    try:
        CutSolver(inst, RunConfig(lp=lp), device=dev).run(rounds=1)
        refused = None
    except ValueError as e:
        refused = str(e)
    log(f"[small] spar150-100-1, use_kernel='auto': {refused!r}; launches {launch_counts()}")
    if refused is None or why is None or why not in refused or launch_counts()["pdhg_block"]:
        raise AssertionError("the n = 150 solve on the card did not refuse with the plan's "
                             "reason")
    reset_launches()
    card_vs_cpu("spar150-100-1 k=3 use_kernel='off'", CutSolver, inst,
                RunConfig(lp=dataclasses.replace(lp, use_kernel="off")), dev, rounds=2)
    launches = launch_counts()
    log(f"[small] spar150-100-1, use_kernel='off': launches {launches}")
    if launches["pdhg_block"] != 0 or launches[PLAIN_BLOCKS] == 0:
        raise AssertionError("the n = 150 solve did not run the plain PDHG loop alone")


def card_vs_cpu(label: str, solver_cls, inst, cfg, dev, rounds: int = 3):
    """A few rounds on the card against the CPU port, which the CPU tests
    hold to the JAX package.  Round 0 precedes any selection and agrees at
    rtol 2e-3 (tests/test_loop.py); later rounds may differ by tie order
    only, and stay within 2% (tests/test_pair_score.py)."""
    gpu = [h.bound for h in solver_cls(inst, cfg, device=dev).run(rounds=rounds)]
    cpu = [h.bound for h in solver_cls(inst, cfg, device="cpu").run(rounds=rounds)]
    rel = [abs(g - c) / abs(c) for g, c in zip(gpu, cpu)]
    log(f"[small] {label}: bounds on the card {gpu}, on the CPU {cpu}; rel diff {rel}")
    if len(gpu) != len(cpu) or rel[0] > 2e-3 or max(rel) > 2e-2:
        raise AssertionError(f"the round on the card disagrees with the CPU port ({label})")


def check_small_instances(dev):
    name = "spar020-100-1"
    inst = parse_boxqp(os.path.join(DATA, f"{name}.in"), name=name)
    lp = LPConfig(max_iters=6000, tol=1e-5)
    card_vs_cpu(f"{name} k=3", CutSolver, inst, RunConfig(lp=lp), dev)
    card_vs_cpu(f"{name} k=2", CutSolver, inst, RunConfig(lp=lp, cuts=CutConfig(k=2)), dev)
    name = "qcqp015-30-3-1"
    card_vs_cpu(f"{name} k=5", CutSolverQCQP, load_or_generate_qcqp(name),
                RunConfig(lp=lp, cuts=CutConfig(k=5, sel_size=8, capacity=128)), dev)
    # the packed route in tests/test_pair_packed.py's configuration
    cfg = RunConfig(lp=LPConfig(max_iters=3000, tol=2e-6),
                    cuts=CutConfig(k=3, sel_size=10, capacity=256, pair_layout="packed"),
                    scorer=ScorerConfig(strategy="feasibility"))
    card_vs_cpu("spar070-100-1 packed feasibility", CutSolver, generate_spar(70, 100, 1),
                cfg, dev, rounds=2)
    # the strategies and steering on spar020-100-1 (inst): their random
    # draws come from a CPU generator, so both devices see the same numbers
    for strategy in ("triangle", "optimality", "random"):
        card_vs_cpu(f"{inst.name} k=3 {strategy}", CutSolver, inst,
                    RunConfig(lp=lp, scorer=ScorerConfig(strategy=strategy)), dev)
    card_vs_cpu(f"{inst.name} k=3 neural steered (steer_eps 1e-3)", CutSolver, inst,
                RunConfig(lp=lp, loop=LoopConfig(steer_eps=1e-3)), dev)


def registry(family: str, name: str) -> dict:
    """The instance registry's values for ``name``: mccormick, sdp, and the
    floor every certificate must keep (BoxQP: the best known objective,
    data/boxqp/optima.json; QCQP: the certified sdp_lower)."""
    with open(os.path.join(REPO, "data", family, "bounds.json")) as f:
        reg = json.load(f)[name]
    if family == "qcqp":
        return {"mc": reg["mccormick"], "sdp": reg["sdp"], "floor": reg["sdp_lower"]}
    with open(os.path.join(DATA, "optima.json")) as f:
        best_known = json.load(f)[name]["best_known"]
    return {"mc": reg["mccormick"], "sdp": reg["sdp"], "floor": best_known}


def outcome(hist) -> list:
    """Everything a round reports except its wall time."""
    return [(h.bound, h.certificate, h.lp_iters, h.lp_kkt_error, h.cuts_added,
             h.cuts_active) for h in hist]


def report(tag: str, hist, mc: float, sdp: float):
    for h in hist:
        gap = min(max((mc - h.bound) / (mc - sdp), 0.0), 1.0)
        log(f"[{tag}] round {h.round}: bound {h.bound!r} certificate {h.certificate!r} "
            f"cuts_added {h.cuts_added} active {h.cuts_active} lp_iters {h.lp_iters} "
            f"kkt {h.lp_kkt_error:.3e} gap_closed {gap!r} wall {h.wall_time_s:.3f}s")


def finish(tag: str, checks: dict):
    for name, ok in checks.items():
        log(f"[{tag}] check {name}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError(f"{tag} checks failed")


def boxqp_path(tag: str, inst, cfg, dev, launched: tuple, idle: tuple = ()):
    """CutSolver on spar125-100-1 in ``cfg``, ROUNDS rounds, counters reset
    before and read after; the bounds are held to the instance registry and
    a second run from a fresh solver must repeat the first bit for bit.
    Returns (launch counts, history, checks so far)."""
    reg = registry("boxqp", INSTANCE)
    mc, sdp, best_known = reg["mc"], reg["sdp"], reg["floor"]
    solver = CutSolver(inst, cfg, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    hist = solver.run(rounds=ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    report(tag, hist, mc, sdp)
    bounds = np.array([h.bound for h in hist])
    certs = np.array([h.certificate for h in hist])
    round_s = sum(h.wall_time_s for h in hist)
    rel0 = float((bounds[0] - mc) / abs(mc))
    log(f"[{tag}] {len(hist)} rounds in {wall:.3f}s = {len(hist) / wall!r} rounds/s; "
        f"rounds / sum of wall_time_s {len(hist) / round_s!r} rounds/s; launches "
        f"{launches}; round-0 vs McCormick {mc!r}: rel {rel0!r}; final gap closed vs "
        f"sdp {sdp!r}: {float((mc - bounds[-1]) / (mc - sdp))!r}; rounds whose own "
        f"certificate rose: {int((np.diff(certs) > 0).sum())}; final bound "
        f"{float(bounds[-1])!r} (recorded: {BOXQP_RECORDED_FINAL!r}, equal: "
        f"{float(bounds[-1]) == BOXQP_RECORDED_FINAL})")
    # A reported bound is the running minimum of the rounds' certificates, so
    # it cannot rise; what can fail is each certificate, checked on its own.
    again = CutSolver(inst, cfg, device=dev).run(rounds=ROUNDS)
    return launches, hist, {
        f"{ROUNDS} rounds ran": len(hist) == ROUNDS,
        f"{' and '.join(launched)} launched": min(launches[k] for k in launched) > 0,
        **({f"{' and '.join(idle)} not launched": all(launches[k] == 0 for k in idle)}
           if idle else {}),
        "no plain PDHG block": launches[PLAIN_BLOCKS] == 0,
        "certificates finite": bool(np.isfinite(certs).all()),
        f"every certificate >= best known {best_known}": bool((certs >= best_known).all()),
        "bounds are the running minimum of the certificates":
            bool((bounds == np.minimum.accumulate(certs)).all()),
        "round 0 within 1e-2 of McCormick": abs(rel0) <= 1e-2,
        "last round below round 0": bool(bounds[-1] < bounds[0]),
        "a second run repeats every round bit for bit": outcome(again) == outcome(hist),
    }


def main_path(inst, dev):
    """Strategy neural, default cuts (the lexicographic table), per round.
    Returns (launch counts, history)."""
    cfg = RunConfig(lp=BOXQP_LP)
    launches, hist, checks = boxqp_path("main", inst, cfg, dev, ("pair_score", "pdhg_block"))
    finish("main", checks)
    return launches, hist


def packed_scan_path(inst, dev) -> dict:
    """Strategy neural on the packed layout, scan mode, after a one-round
    warm-up; a per-round run of the same configuration repeats the scan."""
    cfg = RunConfig(lp=BOXQP_LP, cuts=CutConfig(pair_layout="packed"),
                    loop=LoopConfig(use_scan=True))
    CutSolver(inst, cfg, device=dev).run(rounds=1)
    launches, hist, checks = boxqp_path("packed", inst, cfg, dev,
                                        ("pair_packed", "pdhg_block"), ("pair_score",))
    per_round_cfg = dataclasses.replace(cfg, loop=LoopConfig(use_scan=False))
    per_round = CutSolver(inst, per_round_cfg, device=dev).run(rounds=ROUNDS)
    checks["a per-round run repeats every round of the scan bit for bit"] = (
        outcome(per_round) == outcome(hist))
    finish("packed", checks)
    return launches


def rerun_with_k4_checks(inst, rounds: int, dev):
    """The QCQP main path again from a fresh solver, as run() goes: the
    first run's number of rounds one by one, then the polish.  After each
    round K4 and its twin score that round's LP point (x and X of the
    state, which do_round leaves as it scored them) at check_fused_score's
    tolerances; scoring is pure, so the run is the first one's.  Returns
    (solver, the largest nn excess as a share of its limit)."""
    solver = CutSolverQCQP(inst, QCQP_CFG, device=dev)
    worst = 0.0
    for _ in range(rounds):
        s = solver.do_round()
        args = (solver.state.x, solver.state.X, solver.table, solver.triQ, solver.scale,
                solver.mlp, QCQP_SWEEPS)
        nn_k, feas_k = fused_score(*args)
        nn_p, feas_p = fused_score_plain(*args)
        err_f, r_f = excess(feas_k, feas_p, 0.0, 5e-4)
        err_n, r_n = excess(nn_k, nn_p, 2e-4, 2e-5)
        log(f"[qcqp] round {s.round} point: K4 against its twin feas max|err| {err_f:.3e} "
            f"({r_f:.3f} of atol 5e-4); nn max|err| {err_n:.3e} ({r_n:.3f} of rtol 2e-4 / "
            f"atol 2e-5)")
        if not (r_f <= 1.0 and r_n <= 1.0):
            raise AssertionError(f"K4 disagrees with its twin at round {s.round}'s point")
        worst = max(worst, r_n)
    solver.polish()
    return solver, worst


def qcqp_main_path(dev) -> dict:
    """CutSolverQCQP on qcqpband100-5-25-1 in the suite configuration."""
    inst = load_or_generate_qcqp(QCQP_INSTANCE)
    reg = registry("qcqp", QCQP_INSTANCE)
    mc, sdp, sdp_lower = reg["mc"], reg["sdp"], reg["floor"]
    with open(os.path.join(REPO, "results", "qcqp.jsonl")) as f:
        jax_rec = next(r for r in map(json.loads, f)
                       if (r["instance"], r["strategy"], r.get("k")) == (QCQP_INSTANCE, "neural", 5))
    jax0 = jax_rec["bounds"][0]          # round 0 precedes any cut
    solver = CutSolverQCQP(inst, QCQP_CFG, device=dev)
    log(f"[qcqp] {QCQP_INSTANCE}: n={inst.n} m={inst.m} dense rows on the card "
        f"{tuple(solver.dense.G.shape)}, {solver.table.shape[0]} clique candidates at "
        f"k={QCQP_CFG.cuts.k}")
    reset_launches()
    t0 = time.perf_counter()
    hist = solver.run(rounds=QCQP_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    report("qcqp", hist, mc, sdp)
    bounds = np.array([h.bound for h in hist])
    certs = np.array([h.certificate for h in hist])
    round_s = sum(h.wall_time_s for h in hist)
    d0 = float(bounds[0] - jax0)
    log(f"[qcqp] {len(hist)} rounds in {round_s:.3f}s = {len(hist) / round_s!r} rounds/s "
        f"(whole run with polish {wall:.3f}s); launches {launches} (pdhg_block with "
        f"m={solver.dense.m}); polish certificate {solver.polish_certificate!r}")
    log(f"[qcqp] final bound {float(bounds[-1])!r} (recorded: {QCQP_RECORDED_FINAL!r}, equal: "
        f"{float(bounds[-1]) == QCQP_RECORDED_FINAL})")
    log(f"[qcqp] round 0 {float(bounds[0])!r} vs the JAX package's recorded {jax0!r}: "
        f"diff {d0!r}, rel {d0 / jax0!r}; gap closed vs mccormick {mc!r}, "
        f"sdp {sdp!r}: round 0 {float((mc - bounds[0]) / (mc - sdp))!r}, final "
        f"{float((mc - bounds[-1]) / (mc - sdp))!r} (the JAX package's record: "
        f"{jax_rec['final_gap_closed']!r} after {len(jax_rec['bounds'])} rounds)")
    again_solver, worst = rerun_with_k4_checks(inst, len(hist), dev)
    again = again_solver.history
    log(f"[qcqp] K4's largest nn excess at the main path's round points: {worst:.3f} of the "
        f"limit")
    runmin = np.minimum.accumulate(certs)
    finish("qcqp", {
        f"{QCQP_ROUNDS} rounds ran (or the early stop ended the run)":
            len(hist) == QCQP_ROUNDS or hist[-1].cuts_added == 0,
        "pdhg_block and fused_score launched": min(launches["pdhg_block"],
                                                   launches["fused_score"]) > 0,
        "no plain PDHG block": launches[PLAIN_BLOCKS] == 0,
        "certificates finite": bool(np.isfinite(certs).all()),
        f"every certificate >= sdp_lower {sdp_lower}": bool((certs >= sdp_lower).all()),
        "bounds are the running minimum of the certificates, polish lowering only "
        "the last": bool((bounds[:-1] == runmin[:-1]).all()
                         and bounds[-1] == min(runmin[-1], solver.polish_certificate)),
        "round 0 within 1e-2 of the JAX package's round 0":
            abs(d0) <= 1e-2 * abs(jax0),
        "last bound below round 0": bool(bounds[-1] < bounds[0]),
        "a second run repeats every round bit for bit, polish included":
            outcome(again) == outcome(hist)
            and again_solver.polish_certificate == solver.polish_certificate,
    })
    return launches


def gap_closed(reg: dict, bound: float) -> float:
    return float((reg["mc"] - bound) / (reg["mc"] - reg["sdp"]))


def recorded_gap(path: str, **match) -> str:
    """The JAX package's final gap closed in the last row of results/``path``
    whose keys match, with its line, for printing beside a run."""
    found = None
    with open(os.path.join(REPO, "results", path)) as f:
        for line, row in enumerate(map(json.loads, f), 1):
            if all(row.get(k) == v for k, v in match.items()):
                found = (line, row)
    if found is None:
        return "no JAX record"
    line, row = found
    return (f"JAX record {row['final_gap_closed']!r} after {len(row['bounds'])} rounds "
            f"(results/{path}:{line})")


def keep_snapshot(solver, at_round: int, directory: str) -> str:
    """Make ``solver`` keep a copy, in ``directory``, of the snapshot its
    run writes after round ``at_round`` (each snapshot overwrites the last
    at ``<checkpoint_dir>/<instance>.ck``).  Returns the copy's path."""
    write = solver.checkpoint
    copy = os.path.join(directory, os.path.basename(solver._checkpoint_path()))

    def checkpoint(path):
        write(path)
        if len(solver.history) == at_round:
            os.makedirs(directory, exist_ok=True)
            shutil.copy(path, copy)
            shutil.copy(path + ".json", copy + ".json")

    solver.checkpoint = checkpoint
    return copy


def validity(hist, reg: dict) -> dict:
    """Every certificate finite and above the registry's floor; the bounds
    the certificates' running minimum (the last may be lowered by polish)."""
    certs = np.array([h.certificate for h in hist])
    bounds = np.array([h.bound for h in hist])
    runmin = np.minimum.accumulate(certs)
    return {
        "certificates finite": bool(np.isfinite(certs).all()),
        f"every certificate >= {reg['floor']}": bool((certs >= reg["floor"]).all()),
        "bounds are the running minimum of the certificates (polish may lower the last)":
            bool((bounds[:-1] == runmin[:-1]).all() and bounds[-1] <= runmin[-1]),
    }


def steered_qcqp_scan(dev) -> dict:
    """qcqpband100-5-25-1 in QCQP_CFG with scan mode and steering (steer_eps
    1e-3, 4,000 iterations a round), QCQP_ROUNDS rounds and the polish:
    twice, bit for bit; once per round with a snapshot every round, which
    repeats the scan's rounds bit for bit; and a fresh solver restored from
    round RESUME_AT's snapshot, which repeats the rest, gate state included.
    K2 launches exactly once a round for steering besides the solves' blocks."""
    inst = load_or_generate_qcqp(QCQP_INSTANCE)
    reg = registry("qcqp", QCQP_INSTANCE)
    cfg = QCQP_STEER_CFG
    solver = CutSolverQCQP(inst, cfg, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    hist = solver.run(rounds=QCQP_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    every = cfg.lp.check_every
    blocks = (sum(h.lp_iters for h in hist) + solver.polish_info["iters"]) // every
    report("steer", hist, reg["mc"], reg["sdp"])
    final = float(hist[-1].bound)
    log(f"[steer] {len(hist)} scan rounds + polish in {wall:.3f}s; rounds / sum of "
        f"wall_time_s {len(hist) / sum(h.wall_time_s for h in hist)!r} rounds/s; launches "
        f"{launches}: the solves' and the polish's blocks {blocks}, steering "
        f"{launches['pdhg_block'] - blocks}; final bound {final!r} (PR 6's unsteered main "
        f"path: {QCQP_RECORDED_FINAL!r}); gap closed {gap_closed(reg, final)!r} ("
        f"{recorded_gap('qcqp.jsonl', instance=QCQP_INSTANCE, strategy='neural', k=5)}, "
        f"unsteered)")
    # steering's time a round at the last round's pool and solved state
    setup = solve_setup(solver.c, solver.pool, cfg.lp, solver.dense)
    gen = torch.Generator().manual_seed(SEED)
    steer_ms = cuda_ms(lambda: steer_to_vertex(
        solver.Q, solver.c, solver.pool, solver.state, cfg.lp, gen, cfg.loop.steer_eps,
        cfg.loop.steer_iters, solver.dense, setup), reps=5, warmup=1)
    log(f"[steer] steering a round ({cfg.loop.steer_iters} iterations, one K2 launch, "
        f"m={inst.m}): {steer_ms:.4f} ms = {steer_ms * 1e3 / cfg.loop.steer_iters:.3f} "
        f"us/iteration by events")
    again = CutSolverQCQP(inst, cfg, device=dev)
    again.run(rounds=QCQP_ROUNDS)
    shutil.rmtree(SNAPSHOTS, ignore_errors=True)
    per_cfg = dataclasses.replace(cfg, loop=dataclasses.replace(
        cfg.loop, use_scan=False, checkpoint_every=1, checkpoint_dir=SNAPSHOTS))
    per = CutSolverQCQP(inst, per_cfg, device=dev)
    snapshot = keep_snapshot(per, RESUME_AT["qcqp"], os.path.join(SNAPSHOTS, "resume"))
    per.run(rounds=QCQP_ROUNDS)
    resumed = CutSolverQCQP(inst, dataclasses.replace(
        cfg, loop=dataclasses.replace(cfg.loop, use_scan=False)), device=dev)
    resumed.restore(snapshot)
    resumed.run(rounds=QCQP_ROUNDS - RESUME_AT["qcqp"])
    log(f"[steer] resumed from round {RESUME_AT['qcqp']}'s snapshot: final bound "
        f"{float(resumed.history[-1].bound)!r}")
    shutil.rmtree(SNAPSHOTS, ignore_errors=True)
    finish("steer", {
        f"{QCQP_ROUNDS} scan rounds ran": len(hist) == QCQP_ROUNDS,
        "pdhg_block and fused_score launched": min(launches["pdhg_block"],
                                                   launches["fused_score"]) > 0,
        "steering is exactly one K2 launch a round": launches["pdhg_block"] == blocks + len(hist),
        "no plain PDHG block": launches[PLAIN_BLOCKS] == 0,
        **validity(hist, reg),
        "a second scan run repeats every round bit for bit, polish included":
            outcome(again.history) == outcome(hist)
            and again.polish_certificate == solver.polish_certificate,
        "a per-round run repeats every round of the scan bit for bit, polish included":
            outcome(per.history) == outcome(hist)
            and per.polish_certificate == solver.polish_certificate,
        f"the run resumed from round {RESUME_AT['qcqp']}'s snapshot repeats it bit for bit, "
        "polish and gate state included":
            outcome(resumed.history) == outcome(per.history)
            and resumed.polish_certificate == per.polish_certificate
            and torch.equal(resumed._last_viol, per._last_viol)
            and torch.equal(resumed._cooldown, per._cooldown),
    })
    return launches


def boxqp_resume(inst, main_hist, dev) -> dict:
    """The BoxQP main path's configuration per round with a snapshot every
    round, and a fresh solver restored from round RESUME_AT's snapshot: both
    repeat the main path's rounds bit for bit."""
    cfg = RunConfig(lp=BOXQP_LP,
                    loop=LoopConfig(checkpoint_every=1, checkpoint_dir=SNAPSHOTS))
    shutil.rmtree(SNAPSHOTS, ignore_errors=True)
    per = CutSolver(inst, cfg, device=dev)
    snapshot = keep_snapshot(per, RESUME_AT["boxqp"], os.path.join(SNAPSHOTS, "resume"))
    reset_launches()
    per.run(rounds=ROUNDS)
    resumed = CutSolver(inst, RunConfig(lp=cfg.lp), device=dev).restore(snapshot)
    resumed.run(rounds=ROUNDS - RESUME_AT["boxqp"])
    torch.cuda.synchronize()
    launches = launch_counts()
    shutil.rmtree(SNAPSHOTS, ignore_errors=True)
    log(f"[resume] {INSTANCE}: launches {launches}; final bound "
        f"{float(resumed.history[-1].bound)!r}")
    finish("resume", {
        "pair_score and pdhg_block launched": min(launches["pair_score"],
                                                  launches["pdhg_block"]) > 0,
        "no plain PDHG block": launches[PLAIN_BLOCKS] == 0,
        "the run with snapshots repeats the main path bit for bit":
            outcome(per.history) == outcome(main_hist),
        f"the run resumed from round {RESUME_AT['boxqp']}'s snapshot repeats the main path "
        "bit for bit": outcome(resumed.history) == outcome(main_hist),
    })
    return launches


def strategy_path(tag: str, solver_cls, inst, cfg, rounds: int, reg: dict, record: str,
                  dev):
    """One strategy at full width: a run, counters reset before and read
    after, and a second run from a fresh solver that must repeat it bit for
    bit; every certificate valid.  Returns (launch counts, solver)."""
    solver = solver_cls(inst, cfg, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    hist = solver.run(rounds=rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    report(tag, hist, reg["mc"], reg["sdp"])
    final = float(hist[-1].bound)
    log(f"[{tag}] {len(hist)} rounds in {wall:.3f}s (polish included: "
        f"{cfg.loop.polish_iters > 0}); rounds / sum of wall_time_s "
        f"{len(hist) / sum(h.wall_time_s for h in hist)!r} rounds/s; per-round wall "
        f"{[round(h.wall_time_s, 4) for h in hist]} s; launches {launches}; final bound "
        f"{final!r}, gap closed {gap_closed(reg, final)!r} ({record})")
    again = solver_cls(inst, cfg, device=dev).run(rounds=rounds)
    finish(tag, {
        f"{rounds} rounds ran (or the early stop ended the run)":
            len(hist) == rounds or hist[-1].cuts_added == 0,
        "pdhg_block launched": launches["pdhg_block"] > 0,
        "no plain PDHG block": launches[PLAIN_BLOCKS] == 0,
        **validity(hist, reg),
        "last bound below round 0": bool(hist[-1].bound < hist[0].bound),
        "a second run repeats every round bit for bit": outcome(again) == outcome(hist),
    })
    return launches, solver


def strategies(inst, dev) -> dict:
    """Strategies triangle, random and optimality on spar125-100-1 (k = 3,
    the BoxQP main path's LP) and feasibility, random and optimality on
    qcqpband100-5-25-1 at k = 4 (QCQP_CFG), each run twice; the optimality
    ADMM's time and repeatability at the last BoxQP point."""
    out = {}
    reg = registry("boxqp", INSTANCE)
    for strategy, rounds in BOXQP_STRATEGY_ROUNDS.items():
        cfg = RunConfig(lp=BOXQP_LP, scorer=ScorerConfig(strategy=strategy))
        record = "; ".join(recorded_gap("suite.jsonl", instance=INSTANCE, strategy=strategy,
                                        k=3, sel_size=sel) + f" at sel_size {sel}"
                           for sel in (cfg.cuts.sel_size, 50))
        out[f"boxqp {strategy}"], solver = strategy_path(
            f"box-{strategy}", CutSolver, inst, cfg, rounds, reg, record, dev)
    x, X = solver.state.x, solver.state.X            # the last optimality run's point
    first, second = solver._exact(x, X), solver._exact(x, X)
    admm_ms = cuda_ms(lambda: solver._exact(x, X), reps=2, warmup=0)
    log(f"[box-optimality] the ADMM over {solver.table.shape[0]} blocks (300 iterations of "
        f"a batched 3x3 eigh, {EIGH_CHUNK} blocks a call): {admm_ms:.2f} ms a round by "
        f"events; two calls bit for bit: {torch.equal(first, second)}")
    finish("box-optimality", {"the ADMM repeats bit for bit": torch.equal(first, second)})
    qinst = load_or_generate_qcqp(QCQP_INSTANCE)
    qreg = registry("qcqp", QCQP_INSTANCE)
    for strategy in QCQP_STRATEGIES:
        cfg = dataclasses.replace(QCQP_CFG, cuts=dataclasses.replace(QCQP_CFG.cuts, k=4),
                                  scorer=ScorerConfig(strategy=strategy))
        record = recorded_gap("qcqp.jsonl", instance=QCQP_INSTANCE, strategy=strategy, k=4)
        out[f"qcqp {strategy}"], _ = strategy_path(
            f"qcqp-{strategy}", CutSolverQCQP, qinst, cfg, QCQP_ROUNDS, qreg, record, dev)
    return out


def batched_states_equal(a, b) -> bool:
    """Every tensor of two BatchedRoundStates equal, bit for bit."""
    return all(torch.equal(u, v) for u, v in zip(
        [a.Q, a.c, *rb.values(a.pool), *a.pdhg.fields(), a.bound, a.best_bound],
        [b.Q, b.c, *rb.values(b.pool), *b.pdhg.fields(), b.bound, b.best_bound]))


def batched_run(step, insts, table, valid, dev, rounds: int, kmax: int = 3, dense=None):
    """Per-round steps from a fresh batched state of ``insts`` (BoxQP or
    QCQP).  Returns (state, f32 best bound after each round (rounds, B),
    lp_iters (rounds, B), seconds, synchronised)."""
    qcqp = hasattr(insts[0], "Q0")
    state = init_batched_state(np.stack([i.Q0 if qcqp else i.Q for i in insts]),
                               np.stack([i.c0 if qcqp else i.c for i in insts]), 1024, kmax,
                               m_dense=0 if dense is None else dense.G.shape[1], device=dev)
    best, iters = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        state, info = step(state, table, valid, dense)
        best.append(state.best_bound)
        iters.append(info["lp_iters"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return state, torch.stack(best).cpu().numpy(), np.stack(iters), wall


def suite_bucket_path(dev) -> dict:
    """The n = 125 bucket of scripts/bench_batched.py --suite (the twelve
    spar125-{25,50,75,100}-{1,2,3} of data/boxqp), capacity 1024, k = 3,
    BATCH_KNOBS, Mesh(1, 1), BATCH_ROUNDS per-round steps, then
    certify_batched_f64; twice, bit for bit; instances SUITE_ALONE also as
    batches of one."""
    insts = [parse_boxqp(os.path.join(DATA, f"{name}.in"), name=name) for name in SUITE_BUCKET]
    regs = [registry("boxqp", name) for name in SUITE_BUCKET]
    B, n = len(insts), insts[0].n
    mesh = make_mesh(1, 1)
    table, valid = shard_candidates(combinations_table(n, 3), mesh, device=dev)
    step = make_sharded_round_step(mesh, **BATCH_KNOBS)
    reset_launches()
    state, best, iters, wall = batched_run(step, insts, table, valid, dev, BATCH_ROUNDS)
    launches = launch_counts()
    cert = certify_batched_f64(state)
    blocks = int(sum(it.max() // 100 for it in iters))       # checked blocks of the batch
    again, best2, iters2, wall2 = batched_run(step, insts, table, valid, dev, BATCH_ROUNDS)
    repeat = (batched_states_equal(state, again) and np.array_equal(best, best2)
              and np.array_equal(iters, iters2)
              and np.array_equal(cert, certify_batched_f64(again)))
    alone = {}
    for b in SUITE_ALONE:
        one = batched_run(step, [insts[b]], table, valid, dev, BATCH_ROUNDS)[0]
        alone[b] = (float(certify_batched_f64(one)[0]),
                    torch.equal(one.pool.idx[0], state.pool.idx[b])
                    and all(torch.equal(u[0], v[b]) for u, v in zip(one.pdhg.fields(),
                                                                    state.pdhg.fields())))
    for i, (inst, reg) in enumerate(zip(insts, regs)):
        log(f"[suite] {inst.name}: certified f64 {float(cert[i])!r} (best known {reg['floor']!r}), "
            f"gap closed {gap_closed(reg, cert[i])!r}; f32 bound by round "
            f"{best[:, i].tolist()}; lp_iters by round {iters[:, i].tolist()}; cuts "
            f"{int(state.pool.count[i])}")
    for b, (c1, bits) in alone.items():
        log(f"[suite] {insts[b].name} as a batch of one: certified {c1!r} against {float(cert[b])!r} "
            f"in the batch of {B} (rel {float(abs(c1 - cert[b]) / abs(cert[b]))!r}); bit-equal pool "
            f"and state: {bits}")
    log(f"[suite] {B} x {BATCH_ROUNDS} rounds in {wall:.4f} s = "
        f"{B * BATCH_ROUNDS / wall!r} instance-rounds/s, again {wall2:.4f} s = "
        f"{B * BATCH_ROUNDS / wall2!r} ({SMI}); launches {launches}; checked blocks {blocks}")
    finish("suite", {
        "every certificate finite and >= its best known": bool(
            np.isfinite(cert).all() and all(c >= r["floor"] for c, r in zip(cert, regs))),
        "running bounds monotone over rounds": bool((np.diff(best, axis=0) <= 0).all()),
        "f32 bound within 1e-2 of the f64 certificate":
            bool((np.abs(best[-1] - cert) <= 1e-2 * (1 + np.abs(cert))).all()),
        "a second run repeats every bound and pool bit for bit": repeat,
        "the batches of one agree within rtol 2e-3":
            all(abs(c1 - cert[b]) <= 2e-3 * abs(cert[b]) for b, (c1, _) in alone.items()),
        "pdhg_block launched once a checked block of the batch": launches["pdhg_block"] == blocks,
        f"pair_score launched once an instance a round ({B * BATCH_ROUNDS})":
            launches["pair_score"] == B * BATCH_ROUNDS,
        "no plain PDHG block, no twin-scored call":
            launches[PLAIN_BLOCKS] == 0 and launches[TWIN_SCORED] == 0,
    })
    return launches


def bench_scan_path(dev) -> dict:
    """bench.py:188-223's configuration: 8 x generate_spar(30, 100, s + 1),
    scan mode, BATCH_ROUNDS rounds, BATCH_KNOBS; certify_scan_f64; the scan
    repeats a per-round run bit for bit; instance-rounds/s, the median of 3
    after a warm-up."""
    n, B = BENCH_BATCH
    insts = [generate_spar(n, 100, s + 1) for s in range(B)]
    mesh = make_mesh(1, 1)
    table, valid = shard_candidates(combinations_table(n, 3), mesh, device=dev)
    start = init_batched_state(np.stack([i.Q for i in insts]), np.stack([i.c for i in insts]),
                               1024, 3, device=dev)
    scan = make_sharded_scan_step(mesh, rounds=BATCH_ROUNDS, **BATCH_KNOBS)
    scan(start, table, valid)                                   # warm-up
    reset_launches()
    final, outs = scan(start, table, valid)
    torch.cuda.synchronize()
    launches = launch_counts()
    blocks = int(outs["lp_iters"].max(1).values.sum()) // 100    # checked blocks of the batch
    bounds = certify_scan_f64(final.Q, final.c, outs)
    step = make_sharded_round_step(mesh, **BATCH_KNOBS)
    state, same_pools = start, True
    for r in range(BATCH_ROUNDS):
        same_pools &= all(torch.equal(getattr(outs["pool"], f)[r], v)
                          for f, v in zip(("idx", "lin", "quad", "rhs", "active", "count"),
                                          rb.values(state.pool)))
        state, _ = step(state, table, valid)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scan(start, table, valid)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rate = B * BATCH_ROUNDS / sorted(times)[1]
    log(f"[bench-scan] {B} x generate_spar({n}, 100, s + 1), {BATCH_ROUNDS} rounds in one scan: "
        f"certified bounds of the last round {bounds[-1].tolist()}; cuts "
        f"{final.pool.count.tolist()}; launches {launches}")
    log(f"[bench-scan] instance-rounds/s {rate!r} (median of 3 after a warm-up; runs "
        f"{times!r} s) on {SMI}")
    finish("bench-scan", {
        "certificates finite and monotone over rounds":
            bool(np.isfinite(bounds).all() and (np.diff(bounds, axis=0) <= 0).all()),
        "the scan repeats a per-round run bit for bit":
            same_pools and batched_states_equal(final, state),
        "pdhg_block launched once a checked block of the batch": launches["pdhg_block"] == blocks,
        f"pair_score launched once an instance a round ({B * BATCH_ROUNDS})":
            launches["pair_score"] == B * BATCH_ROUNDS,
        "no plain PDHG block, no twin-scored call":
            launches[PLAIN_BLOCKS] == 0 and launches[TWIN_SCORED] == 0,
    })
    return launches


def qcqp_family_path(dev) -> dict:
    """scripts/bench_batched.py --qcqp at its defaults: the family
    QCQP_FAMILY, the chordal clique table at k = 4, the constraints as a
    batched dense block, BATCH_KNOBS, QCQP_FAMILY_ROUNDS per-round steps on
    the card; the first QCQP_FAMILY_CPU_ROUNDS held to the CPU port at rtol
    2e-3."""
    fam = generate_qcqp_family(*QCQP_FAMILY)
    n, m, B = fam[0].n, fam[0].m, len(fam)
    cliques, _ = chordal_decomposition(n, fam[0].sparsity_graph())
    table_np = clique_candidates(cliques, 4)
    mesh = make_mesh(1, 1)
    step = make_sharded_round_step(mesh, **BATCH_KNOBS, kmax=4, m_dense=m)

    def run(device, rounds):
        dense = batched_dense_from_qcqp(fam, device)
        table, valid = shard_candidates(table_np, mesh, device=device)
        state = init_batched_state(np.stack([i.Q0 for i in fam]), np.stack([i.c0 for i in fam]),
                                   1024, 4, m_dense=m, device=device)
        certs, best, blocks = [], [], 0
        for _ in range(rounds):
            state, info = step(state, table, valid, dense)
            certs.append(certify_batched_f64(state, dense))
            best.append(state.best_bound.cpu().numpy())
            blocks += int(info["lp_iters"].max()) // 100
        return state, np.stack(certs), np.stack(best), blocks

    reset_launches()
    t0 = time.perf_counter()
    state, certs, best, blocks = run(dev, QCQP_FAMILY_ROUNDS)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    cpu_certs = run(torch.device("cpu"), QCQP_FAMILY_CPU_ROUNDS)[1]
    rel = np.abs(certs[:QCQP_FAMILY_CPU_ROUNDS] - cpu_certs) / np.abs(cpu_certs)
    log(f"[qcqp-family] {B} x n={n}, m={m}, {table_np.shape[0]} clique candidates at k = 4; "
        f"certified bounds by round {certs.tolist()}; cuts {state.pool.count.tolist()}; "
        f"{QCQP_FAMILY_ROUNDS} rounds with the certificates in {wall:.3f} s; launches "
        f"{launches}")
    log(f"[qcqp-family] against the CPU port, rounds 0-{QCQP_FAMILY_CPU_ROUNDS - 1}: largest "
        f"rel diff {float(rel.max())!r}")
    finish("qcqp-family", {
        "certificates finite": bool(np.isfinite(certs).all()),
        "running bounds monotone over rounds": bool((np.diff(best, axis=0) <= 0).all()),
        "the last certificate below round 0's": bool((certs[-1] < certs[0]).all()),
        "within rtol 2e-3 of the CPU port": bool((rel <= 2e-3).all()),
        f"fused_score launched once an instance a round ({B * QCQP_FAMILY_ROUNDS})":
            launches["fused_score"] == B * QCQP_FAMILY_ROUNDS,
        "pdhg_block launched once a checked block of the batch": launches["pdhg_block"] == blocks,
        "no plain PDHG block, no twin-scored call":
            launches[PLAIN_BLOCKS] == 0 and launches[TWIN_SCORED] == 0,
    })
    return launches


def main() -> int:
    global SMI
    t_start = time.perf_counter()
    smi = SMI = environment()
    torch.backends.cuda.matmul.allow_tf32 = False    # see the module docstring
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    # the build without the Jacobi's overflow guard, for the bit check, in
    # parallel with the port's own
    finish_variants = start_variants({"unguarded": ([UNGUARDED], [])},
                                     ("pair_score", "fused_score"))
    _build.lib()
    log(f"[build] {os.path.relpath(_build.library_path(), REPO)} built and loaded in "
        f"{time.perf_counter() - t0:.2f}s (nvcc {_build.build_seconds:.2f}s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")
    tensor_core_kernels()
    unguarded = finish_variants()["unguarded"]
    log(f"[build] unguarded variant ready after {time.perf_counter() - t0:.2f}s")

    inst = parse_boxqp(os.path.join(DATA, f"{INSTANCE}.in"), name=INSTANCE)
    band = load_or_generate_qcqp(QCQP_INSTANCE)
    small = parse_boxqp(os.path.join(DATA, "spar020-100-1.in"), name="spar020-100-1")
    k1 = check_pair_score(inst, small, dev)
    k3 = check_pair_packed(inst, dev)
    k2_box = check_pdhg_block(f"{INSTANCE} m=0", inst.Q, inst.c,
                              combinations_table(inst.n, 3), None, dev)
    k2 = check_pdhg_block(f"{QCQP_INSTANCE} m={band.m}", band.Q0, band.c0,
                          clique_table(band, 5), dense_from_qcqp(band.Qs, band.cs, band.bs, dev),
                          dev)
    bucket = [parse_boxqp(os.path.join(DATA, f"{name}.in"), name=name) for name in SUITE_BUCKET]
    k2_batched = check_pdhg_block_batched(bucket, k2_box, dev)
    k4 = check_k4(inst, dev)
    check_guard(inst, unguarded, dev)
    check_small_instances(dev)
    check_large_instance(dev)
    PATH_LAUNCHES["boxqp main"], main_hist = main_path(inst, dev)
    PATH_LAUNCHES["qcqp main"] = qcqp_main_path(dev)
    PATH_LAUNCHES["boxqp packed scan"] = packed_scan_path(inst, dev)
    PATH_LAUNCHES["qcqp steered scan"] = steered_qcqp_scan(dev)
    PATH_LAUNCHES["boxqp resume"] = boxqp_resume(inst, main_hist, dev)
    PATH_LAUNCHES.update(strategies(inst, dev))
    PATH_LAUNCHES["batched suite bucket"] = suite_bucket_path(dev)
    PATH_LAUNCHES["batched bench scan"] = bench_scan_path(dev)
    PATH_LAUNCHES["batched qcqp family"] = qcqp_family_path(dev)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")
    for path, counts in PATH_LAUNCHES.items():
        log(f"[launches] {path}: {counts}")
    total = {name: sum(c[name] for c in PATH_LAUNCHES.values()) for name in WRAPPERS}

    kernels = [
        {"name": "pair_score", "route": "cuda",
         "source": "sdpcutsel_tpu_torch/csrc/pair_score.cu",
         "replaces": "sdpcutsel_tpu/ops/pair_score.py:192",
         "launches": total["pair_score"], **k1},
        {"name": "pair_packed", "route": "cuda",
         "source": "sdpcutsel_tpu_torch/csrc/pair_packed.cu",
         "replaces": "sdpcutsel_tpu/ops/pair_packed.py:196",
         "launches": total["pair_packed"], **k3},
        {"name": "pdhg_block", "route": "cuda",
         "source": "sdpcutsel_tpu_torch/csrc/pdhg_block.cu",
         "replaces": "sdpcutsel_tpu/lp/pdhg_kernel.py:51",
         "launches": total["pdhg_block"], **k2, **k2_batched,
         "max_abs_err": max(k2["max_abs_err"], k2_box["max_abs_err"],
                            k2_batched["batched_max_abs_err"])},
        {"name": "fused_score", "route": "cuda",
         "source": "sdpcutsel_tpu_torch/csrc/fused_score.cu",
         "replaces": "sdpcutsel_tpu/ops/fused_score.py:52",
         "launches": total["fused_score"], **k4[-1],
         "max_abs_err": max(r["max_abs_err"] for r in k4)},
    ]
    for entry in kernels:
        entry["library_ms"] = None       # no single PyTorch call computes any of them
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
