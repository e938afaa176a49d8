"""Smoke run of the PyTorch + CUDA port (sdpcutsel_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:
  1. environment: the card (nvidia-smi name and power limit), CUDA, nvcc,
     triton; no CUDA device -> exit 2 before any result is printed;
  2. build both kernels from csrc/ (timed as set-up);
  3. check each kernel against its plain PyTorch twin on the card at the
     main path's shapes, and time both with CUDA events:
       pair_score  n = 125, all 317,750 candidates of spar125-100-1;
       pdhg_block  n = 125, M = 1024 with 400 active unit cuts, blocks of
                   7 and 100 iterations;
  4. the round on the card against the CPU port on spar020-100-1;
  5. the main path: CutSolver on spar125-100-1, strategy neural, default
     cuts, LPConfig(max_iters=20000, tol=2e-6), 10 rounds, with both launch
     counters reset before and read after; the bounds are held to the
     instance registry (data/boxqp/bounds.json, optima.json), and a second
     run from a fresh solver must repeat the first bit for bit;
  6. one JSON line of kernel results, then the last line
     {"ok": true, "device": {...}}.

TF32 is turned off for the whole process at its start: the scoring twin's
MLP runs as cuBLAS matrix products, and it agrees with the kernel to 2e-4
only in full float32.  The solver itself does no cuBLAS product on CUDA.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from sdpcutsel_tpu.config import LPConfig, RunConfig
from sdpcutsel_tpu.instances.boxqp import parse_boxqp
from sdpcutsel_tpu_torch import _build
from sdpcutsel_tpu_torch.cuts.enumerate import combinations_table
from sdpcutsel_tpu_torch.loop import CutSolver
from sdpcutsel_tpu_torch.lp.pdhg import estimate_norm, init_state
from sdpcutsel_tpu_torch.lp.pdhg_kernel import pdhg_block, pdhg_block_plain
from sdpcutsel_tpu_torch.models.scorer import MLPScorer, load_params
from sdpcutsel_tpu_torch.ops.pair_score import pair_score, pair_score_plain
from sdpcutsel_tpu_torch.relax.cutbuffer import append_cuts, build_cut_index, empty_pool

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "data", "boxqp")
INSTANCE = "spar125-100-1"
ROUNDS = 10
SEED = 0


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


def check_pair_score(inst, dev) -> dict:
    n = inst.n
    rng = np.random.default_rng(SEED)
    x = rng.random(n)
    X = np.clip(np.outer(x, x) + 0.15 * rng.standard_normal((n, n)), 0, 1)
    x, X, Q = (torch.as_tensor(a, dtype=torch.float32, device=dev)
               for a in (x, 0.5 * (X + X.T), inst.Q))
    table = torch.as_tensor(combinations_table(n, 3), device=dev)
    mlp = MLPScorer(load_params(3), dev)
    nn_k, feas_k = pair_score(x, X, Q, table, mlp)
    nn_p, feas_p = pair_score_plain(x, X, Q, table, mlp)
    torch.cuda.synchronize()
    err_f, r_f = excess(feas_k, feas_p, 0.0, 5e-5)
    err_n, r_n = excess(nn_k, nn_p, 2e-4, 2e-4)
    log(f"[pair_score] T={table.shape[0]} feas max|err| {err_f:.3e} (atol 5e-5: "
        f"{r_f:.3f} of limit); nn max|err| {err_n:.3e} (rtol/atol 2e-4: "
        f"{r_n:.3f} of limit)")
    if not (r_f <= 1.0 and r_n <= 1.0):
        raise AssertionError("pair_score kernel disagrees with its twin")
    ms = cuda_ms(lambda: pair_score(x, X, Q, table, mlp), reps=50)
    plain_ms = cuda_ms(lambda: pair_score_plain(x, X, Q, table, mlp), reps=5)
    log(f"[pair_score] kernel {ms:.4f} ms ({table.shape[0] / ms / 1e3:.1f} M cand/s); "
        f"twin {plain_ms:.4f} ms ({table.shape[0] / plain_ms / 1e3:.1f} M cand/s)")
    return {"max_abs_err": max(err_f, err_n), "ms": ms, "plain_ms": plain_ms}


def random_pool(n: int, M: int, active: int, rng, dev):
    """``active`` random unit-norm cuts on distinct triples in a pool of M."""
    tab = combinations_table(n, 3)
    idx = tab[rng.choice(tab.shape[0], active, replace=False)]
    lin = rng.standard_normal((active, 3))
    quad = rng.standard_normal((active, 3, 3))
    quad = 0.5 * (quad + quad.transpose(0, 2, 1))
    nrm = np.sqrt((lin ** 2).sum(1) + (quad ** 2).sum((1, 2)))
    cuts = (idx, lin / nrm[:, None], quad / nrm[:, None, None],
            -0.1 * rng.random(active) / nrm, np.ones(active))
    return append_cuts(empty_pool(M, 3, dev), *(
        torch.as_tensor(a, dtype=torch.int64 if a.dtype.kind == "i" else torch.float32,
                        device=dev) for a in cuts))


def check_pdhg_block(inst, dev) -> dict:
    n, M = inst.n, 1024
    rng = np.random.default_rng(SEED + 1)
    pool = random_pool(n, M, 400, rng, dev)
    st = init_state(n, M, dev)
    X = rng.random((n, n))
    f32 = dict(dtype=torch.float32, device=dev)
    st.x = torch.as_tensor(rng.random(n), **f32)
    st.X = torch.as_tensor(0.5 * (X + X.T), **f32)
    st.yA = torch.as_tensor(0.1 * rng.random((n, n)), **f32)
    st.yB = torch.as_tensor(0.1 * rng.random((n, n)), **f32)
    st.yC = torch.as_tensor(0.05 * rng.random(M), **f32) * pool.active
    cx = torch.as_tensor(-inst.c, **f32)
    cX = torch.as_tensor(-0.5 * inst.Q, **f32)
    index = build_cut_index(pool, n)
    eta = 0.95 / estimate_norm(pool, n, 30, torch.Generator().manual_seed(0), index)
    zero = st.map(torch.zeros_like)
    # 7 iterations: the reference's own kernel tolerance (tests/test_pdhg_kernel.py).
    # 100 iterations (one checked block of the solve): PDHG is nonexpansive, so
    # f32 rounding differences add up rather than multiply; the 7-iteration
    # tolerance scaled linearly to 100 iterations is 3e-4, and the ergodic sums
    # of 100 iterates take 100 x that as atol.
    worst = 0.0
    for iters, tol_st, tol_acc in [(7, (2e-5, 2e-5), (2e-5, 2e-5)),
                                   (100, (3e-4, 3e-4), (3e-4, 3e-2))]:
        sk, ak = pdhg_block(cx, cX, pool, index, st, zero, eta, eta, iters)
        sp, ap = pdhg_block_plain(cx, cX, pool, index, st, zero, eta, eta, iters)
        torch.cuda.synchronize()
        errs, ratio = [], 0.0
        for (got, want), (rtol, atol) in zip(
                [*zip(sk.fields(), sp.fields()), *zip(ak.fields(), ap.fields())],
                [tol_st] * 5 + [tol_acc] * 5):
            e, r = excess(got, want, rtol, atol)
            errs.append(e)
            ratio = max(ratio, r)
        log(f"[pdhg_block] {iters} iterations: max|err| state {max(errs[:5]):.3e} "
            f"sums {max(errs[5:]):.3e}; {ratio:.3f} of the limit "
            f"(state rtol/atol {tol_st}, sums {tol_acc})")
        if ratio > 1.0:
            raise AssertionError(f"pdhg_block kernel disagrees with its twin at {iters} iterations")
        worst = max(errs)
    first = pdhg_block(cx, cX, pool, index, st, zero, eta, eta, 100)
    again = pdhg_block(cx, cX, pool, index, st, zero, eta, eta, 100)
    same = all(torch.equal(a, b) for a, b in zip(first[0].fields(), again[0].fields()))
    log(f"[pdhg_block] two 100-iteration runs bit-identical: {same}")
    if not same:
        raise AssertionError("pdhg_block kernel is not deterministic")
    ms = cuda_ms(lambda: pdhg_block(cx, cX, pool, index, st, zero, eta, eta, 100), reps=20)
    plain_ms = cuda_ms(lambda: pdhg_block_plain(cx, cX, pool, index, st, zero, eta, eta, 100),
                       reps=3, warmup=1)
    log(f"[pdhg_block] 100-iteration block: kernel {ms:.4f} ms ({ms * 10:.2f} us/iter); "
        f"twin {plain_ms:.4f} ms ({plain_ms * 10:.2f} us/iter)")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def check_small_instance(dev):
    """The round on the card against the CPU port, which the CPU tests hold to
    the JAX package: spar020-100-1, 3 rounds.  Round 0 precedes any selection
    and agrees at rtol 2e-3 (tests/test_loop.py); later rounds may differ by
    tie order only, and stay within 2% (tests/test_pair_score.py)."""
    name = "spar020-100-1"
    inst = parse_boxqp(os.path.join(DATA, f"{name}.in"), name=name, use_native=False)
    cfg = RunConfig(lp=LPConfig(max_iters=6000, tol=1e-5))
    gpu = [h.bound for h in CutSolver(inst, cfg, device=dev).run(rounds=3)]
    cpu = [h.bound for h in CutSolver(inst, cfg, device="cpu").run(rounds=3)]
    rel = [abs(g - c) / abs(c) for g, c in zip(gpu, cpu)]
    log(f"[small] {name} bounds on the card {gpu}, on the CPU {cpu}; rel diff {rel}")
    if len(gpu) != len(cpu) or rel[0] > 2e-3 or max(rel) > 2e-2:
        raise AssertionError("the round on the card disagrees with the CPU port")


def outcome(hist) -> list:
    """Everything a round reports except its wall time."""
    return [(h.bound, h.certificate, h.lp_iters, h.lp_kkt_error, h.cuts_added,
             h.cuts_active) for h in hist]


def main_path(inst, dev) -> dict:
    with open(os.path.join(DATA, "bounds.json")) as f:
        reg = json.load(f)[INSTANCE]
    with open(os.path.join(DATA, "optima.json")) as f:
        best_known = json.load(f)[INSTANCE]["best_known"]
    mc, sdp = reg["mccormick"], reg["sdp"]
    cfg = RunConfig(lp=LPConfig(max_iters=20000, tol=2e-6))
    solver = CutSolver(inst, cfg, device=dev)
    pair_score.launches = 0
    pdhg_block.launches = 0
    t0 = time.perf_counter()
    hist = solver.run(rounds=ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"pair_score": pair_score.launches, "pdhg_block": pdhg_block.launches}
    for h in hist:
        gap = min(max((mc - h.bound) / (mc - sdp), 0.0), 1.0)
        log(f"[main] round {h.round}: bound {h.bound!r} cuts_added {h.cuts_added} "
            f"active {h.cuts_active} lp_iters {h.lp_iters} kkt {h.lp_kkt_error:.3e} "
            f"gap_closed {gap!r} wall {h.wall_time_s:.3f}s")
    bounds = np.array([h.bound for h in hist])
    certs = np.array([h.certificate for h in hist])
    rel0 = float((bounds[0] - mc) / abs(mc))
    log(f"[main] {len(hist)} rounds in {wall:.3f}s = {len(hist) / wall!r} rounds/s; "
        f"launches {launches}; round-0 vs McCormick {mc!r}: rel {rel0!r}; "
        f"final gap closed vs sdp {sdp!r}: {float((mc - bounds[-1]) / (mc - sdp))!r}; "
        f"rounds whose own certificate rose: {int((np.diff(certs) > 0).sum())}")
    # A reported bound is the running minimum of the rounds' certificates, so
    # it cannot rise; what can fail is each certificate, checked on its own.
    again = CutSolver(inst, cfg, device=dev).run(rounds=ROUNDS)
    checks = {
        "10 rounds ran": len(hist) == ROUNDS,
        "both kernels launched": min(launches.values()) > 0,
        "certificates finite": bool(np.isfinite(certs).all()),
        f"every certificate >= best known {best_known}": bool((certs >= best_known).all()),
        "bounds are the running minimum of the certificates":
            bool((bounds == np.minimum.accumulate(certs)).all()),
        "round 0 within 1e-2 of McCormick": abs(rel0) <= 1e-2,
        "last round below round 0": bool(bounds[-1] < bounds[0]),
        "a second run repeats every round bit for bit": outcome(again) == outcome(hist),
    }
    for name, ok in checks.items():
        log(f"[main] check {name}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError("main path checks failed")
    return launches


def main() -> int:
    smi = environment()
    torch.backends.cuda.matmul.allow_tf32 = False    # see the module docstring
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    _build.lib()
    log(f"[build] {os.path.relpath(_build.library_path(), REPO)} built and loaded in "
        f"{time.perf_counter() - t0:.2f}s (nvcc {_build.build_seconds:.2f}s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"[build] {line.strip()}")

    inst = parse_boxqp(os.path.join(DATA, f"{INSTANCE}.in"), name=INSTANCE,
                       use_native=False)
    k1 = check_pair_score(inst, dev)
    k2 = check_pdhg_block(inst, dev)
    check_small_instance(dev)
    launches = main_path(inst, dev)

    kernels = [
        {"name": "pair_score", "route": "cuda",
         "source": "sdpcutsel_tpu_torch/csrc/pair_score.cu",
         "replaces": "sdpcutsel_tpu/ops/pair_score.py:192",
         "launches": launches["pair_score"], **k1},
        {"name": "pdhg_block", "route": "cuda",
         "source": "sdpcutsel_tpu_torch/csrc/pdhg_block.cu",
         "replaces": "sdpcutsel_tpu/lp/pdhg_kernel.py:51",
         "launches": launches["pdhg_block"], **k2},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
