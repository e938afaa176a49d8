"""Where the scoring kernels' time goes, on the card.

    python3 -m sdpcutsel_tpu_torch.scoring_variants

K1 (``csrc/pair_score.cu``), K3 (``csrc/pair_packed.cu``) and K4
(``csrc/fused_score.cu`` at k = 5 on qcqpband100-5-25-1's clique table, the
QCQP path's shape) as built, timed on the device (profiler) in turns with
variants built from the same sources into ``build/cuda/variants/``
(ignored):
  - ``producers=N``: the warp-specialised CTA with N producer warps in place
    of 20 at K = 3 (``producers_for`` in ``csrc/score_mma.cuh`` is the only
    change);
  - ``fast-math``: the sources as they are, compiled with
    ``nvcc -use_fast_math`` (approximate division and square root, flush to
    zero).  Its feas bits differ from the port's, so it is never a kernel of
    the port: it measures what the Jacobi's IEEE semantics cost;
  - ``unguarded``: ``rotate`` in ``csrc/score_common.cuh`` without its
    overflow guard (the IEEE slow paths where tau^2 overflows), the same
    bits.
K1 and K3 at n = 125 on spar125-100-1's scoring point (the point of
``chip_smoke.py``) with 5 Jacobi sweeps, K4 with 6, and each with 0 (no
Jacobi: the gathers, the features and the MLP alone), over 50 launches after
a warm-up, in the order as built, variants, variants reversed, as built.

It also counts, in numpy float32 on the host (IEEE arithmetic, as the card's;
the card contracts some products into FMAs, so the counts are close, not
exact), the rotations of the 4 x 4 Jacobi where tau^2 overflows to inf.
Unguarded, ``sqrtf(1 + tau^2)`` and ``sgn / (|tau| + inf)`` take the slow
paths of the IEEE square root and division there; the share of 32-triple
tiles with at least one such lane is the share of warps that would wait on
that path in that rotation.

``device_ms`` (the profiler's device time of a kernel), ``start_variants``
(variants built from edited copies of the sources) and ``k1_call`` /
``k4_call`` (a launch of K1 or K4 from a given library, outside the
wrappers and their launch counts) serve ``chip_smoke.py`` too.  Needs a CUDA
device; exits 2 without one.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from . import _build
from .cuts.enumerate import combinations_table
from .instances import load_or_generate_qcqp, parse_boxqp
from .models.features import candidate_q_features
from .models.scorer import MLPScorer, load_params
from .ops.pair_packed import packed_layout
from .qcqp.chordal import chordal_decomposition, clique_candidates

INSTANCE = "spar125-100-1"
BAND = "qcqpband100-5-25-1"
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "boxqp")
VARIANT_DIR = os.path.join(_build.BUILD_DIR, "variants")
PRODUCERS = "return K == 5 ? 12 : K == 4 ? 16 : 20;"    # score_mma.cuh producers_for
GUARD = "const bool over = fabsf(tau) >= kTauOverflow;"   # score_common.cuh rotate
UNGUARDED = ("score_common.cuh", GUARD, "const bool over = false;")


def scoring_point(inst, dev, seed: int = 0):
    """The random (x, X) of the k = 3 kernel checks (here and in
    chip_smoke.py), with the instance's Q."""
    n = inst.n
    rng = np.random.default_rng(seed)
    x = rng.random(n)
    X = np.clip(np.outer(x, x) + 0.15 * rng.standard_normal((n, n)), 0, 1)
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                 for a in (x, 0.5 * (X + X.T), inst.Q))


def clique_table(inst, k: int) -> np.ndarray:
    """A QCQP instance's candidate table, as CutSolverQCQP builds it."""
    cliques, _ = chordal_decomposition(inst.n, inst.sparsity_graph())
    return clique_candidates(cliques, k)


def fused_args(Q, table: np.ndarray, sweeps: int, dev, seed: int = 0) -> tuple:
    """fused_score's arguments at a random point (x, X) from seed + k, with
    the instance's Q and the candidate table (here and in chip_smoke.py)."""
    n, k = Q.shape[0], table.shape[1]
    rng = np.random.default_rng(seed + k)
    x = rng.random(n)
    X = np.clip(np.outer(x, x) + 0.3 * rng.standard_normal((n, n)), 0, 1)
    x, X, Q = (torch.as_tensor(a, dtype=torch.float32, device=dev)
               for a in (x, 0.5 * (X + X.T), Q))
    table = torch.as_tensor(table, device=dev)
    triQ, scale = candidate_q_features(Q, table)
    return x, X, table, triQ, scale, MLPScorer(load_params(k), dev), sweeps


def device_ms(fn, kernel: str, reps: int = 50, sessions: int = 3) -> float:
    """Mean device milliseconds of one launch of the kernels whose name holds
    ``kernel``, from torch.profiler over ``reps`` calls of ``fn`` after a
    warm-up call.  Beside the CUDA-event time of back-to-back calls it shows
    how much of that time is host dispatch.  A profiling session on the
    card's machine now and then returns no device records at all; such a
    session is run again, up to ``sessions`` in all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if kernel in e.key]
        count = sum(e.count for e in rows)
        if count:
            field = ("self_device_time_total" if hasattr(rows[0], "self_device_time_total")
                     else "self_cuda_time_total")
            return sum(getattr(e, field) for e in rows) / count / 1e3
        print(f"[profiler] no launch of {kernel} recorded in a session of {reps} calls; "
              f"{len(prof.key_averages())} rows in all", flush=True)
    raise RuntimeError(f"the profiler recorded no launch of {kernel} in {sessions} sessions")


def _weights(mlp) -> list:
    return [t.contiguous() for lin in mlp.layers for t in (lin.weight, lin.bias)]


def k1_call(lib, x, X, Q, table, mlp, sweeps: int):
    """(run, nn, feas): run() launches K1 from ``lib`` (the built library or
    a variant) on these inputs and writes its scores into nn and feas."""
    T, n, w = table.shape[0], x.shape[0], _weights(mlp)
    nn, feas = torch.empty(T, device=x.device), torch.empty(T, device=x.device)

    def run():
        err = lib.pair_score_launch(
            T, n, sweeps, *(t.data_ptr() for t in (table, x, X, Q, *w)),
            nn.data_ptr(), feas.data_ptr(), torch.cuda.current_stream().cuda_stream)
        _build.check(err, "pair_score_launch")
    return run, nn, feas


def k4_call(lib, x, X, table, triQ, scale, mlp, sweeps: int):
    """(run, nn, feas): run() launches K4 from ``lib`` on fused_score's
    arguments and writes its scores into nn and feas."""
    (T, k), n, w = table.shape, x.shape[0], _weights(mlp)
    nn, feas = torch.empty(T, device=x.device), torch.empty(T, device=x.device)

    def run():
        err = lib.fused_score_launch(
            T, n, k, sweeps, *(t.data_ptr() for t in (table, x, X, triQ, scale, *w)),
            nn.data_ptr(), feas.data_ptr(), torch.cuda.current_stream().cuda_stream)
        _build.check(err, "fused_score_launch")
    return run, nn, feas


def start_variants(variants: dict, sources=("pair_score", "pair_packed")):
    """{name: ([(header, text, replacement), ...], extra nvcc flags)}: copy
    csrc/ once per variant, edit its headers, and start one nvcc per variant
    and source, all at once.  Returns a function that waits for them, links
    each variant and returns {name: ctypes library}."""
    nvcc = _build._nvcc()
    shutil.rmtree(VARIANT_DIR, ignore_errors=True)
    procs = {}
    for name, (subs, flags) in variants.items():
        d = os.path.join(VARIANT_DIR, name)
        shutil.copytree(_build.CSRC_DIR, d)
        for header, text, replacement in subs:
            path = os.path.join(d, header)
            with open(path) as f:
                src = f.read()
            if text not in src:
                raise RuntimeError(f"variant {name}: {header} no longer holds {text!r}")
            with open(path, "w") as f:
                f.write(src.replace(text, replacement))
        procs[name] = [subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *flags, "-c", "-o", os.path.join(d, f"{k}.o"),
             os.path.join(d, f"{k}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for k in sources]

    def finish() -> dict:
        libs = {}
        for name, ps in procs.items():
            log = "".join(p.communicate(timeout=600)[0] for p in ps)
            if any(p.returncode for p in ps):
                raise RuntimeError(f"variant {name} does not build:\n{log}")
            d = os.path.join(VARIANT_DIR, name)
            subprocess.run([nvcc, *_build.NVCC_FLAGS[:2], "-shared", "-o",
                            os.path.join(d, "lib.so"),
                            *(os.path.join(d, f"{k}.o") for k in sources)],
                           check=True, capture_output=True, timeout=600)
            regs = [line.split(":", 1)[-1].strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line]
            print(f"[variant {name}] {'; '.join(regs)}", flush=True)
            lib = ctypes.CDLL(os.path.join(d, "lib.so"))
            for fn, argtypes in _build._SIGNATURES.items():
                if fn.startswith(tuple(f"{k}_" for k in sources)):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            libs[name] = lib
        return libs

    return finish


def overflow_counts(x, X, table, sweeps: int = 5):
    """Per rotation: the share of triples whose tau^2 overflows (and which
    are not 'small'), and the share of 32-triple tiles with one or more."""
    x, X = x.cpu().numpy(), X.cpu().numpy()
    i, j, l = table.T
    M = 4

    def U(p, q):
        p, q = min(p, q), max(p, q)
        return p * M - p * (p - 1) // 2 + (q - p)

    a = np.stack([np.ones(len(i), np.float32), x[i], x[j], x[l], X[i, i], X[i, j], X[i, l],
                  X[j, j], X[j, l], X[l, l]])
    one = np.float32(1)
    rows = []
    with np.errstate(all="ignore"):
        for sweep in range(sweeps):
            for P in range(M - 1):
                for Q in range(P + 1, M):
                    apq, app, aqq = a[U(P, Q)].copy(), a[U(P, P)].copy(), a[U(Q, Q)].copy()
                    small = np.abs(apq) < np.float32(1e-30)
                    tau = (aqq - app) / (np.float32(2) * np.where(small, one, apq))
                    sgn = np.where(tau >= 0, one, -one)
                    tt = tau * tau
                    t = np.where(small, np.float32(0), sgn / (np.abs(tau) + np.sqrt(one + tt)))
                    c = one / np.sqrt(one + t * t)
                    s = t * c
                    a[U(P, P)], a[U(Q, Q)], a[U(P, Q)] = app - t * apq, aqq + t * apq, 0
                    for r in range(M):
                        if r not in (P, Q):
                            arp, arq = a[U(r, P)].copy(), a[U(r, Q)].copy()
                            a[U(r, P)], a[U(r, Q)] = c * arp - s * arq, s * arp + c * arq
                    over = np.isinf(tt) & ~small
                    tiles = over[: len(over) // 32 * 32].reshape(-1, 32).any(axis=1)
                    rows.append((sweep, P, Q, float(over.mean()), float(tiles.mean())))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("scoring_variants: no CUDA device visible to torch", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    inst = parse_boxqp(os.path.join(DATA, f"{INSTANCE}.in"), name=INSTANCE)
    x, X, Q = scoring_point(inst, dev)
    n = inst.n
    table_np = combinations_table(n, 3)
    table = torch.as_tensor(table_np, device=dev)
    lay = packed_layout(n, dev)
    mlp = MLPScorer(load_params(3), dev)
    weights = _weights(mlp)
    band = load_or_generate_qcqp(BAND)
    args4 = fused_args(band.Q0, clique_table(band, 5), 6, dev)
    sweeps4 = args4[-1]

    finish = start_variants({
        "producers=12": ([("score_mma.cuh", PRODUCERS, PRODUCERS.replace("20", "12"))], []),
        "producers=28": ([("score_mma.cuh", PRODUCERS, PRODUCERS.replace("20", "28"))], []),
        "fast-math": ([], ["-use_fast_math"]),
        "unguarded": ([UNGUARDED], []),
    }, ("pair_score", "pair_packed", "fused_score"))
    libs = {"as built": _build.lib(), **finish()}
    T, S, V, T4 = table.shape[0], lay.slots, lay.valid_slots.shape[0], args4[2].shape[0]
    nn3, feas3 = torch.empty(S, device=dev), torch.empty(S, device=dev)

    def k1(lib, sweeps):
        return k1_call(lib, x, X, Q, table, mlp, sweeps)[0]

    def k3(lib, sweeps):
        def run():
            err = lib.pair_packed_launch(
                S, V, n, lay.R[0], lay.R[1], sweeps,
                *(t.data_ptr() for t in (lay.valid_slots, lay.rows, lay.iu, lay.ju, x, X, Q,
                                         *weights)),
                nn3.data_ptr(), feas3.data_ptr(), torch.cuda.current_stream().cuda_stream)
            _build.check(err, "pair_packed_launch")
        return run

    def k4(lib, sweeps):
        return k4_call(lib, *args4[:-1], sweeps)[0]

    times: dict = {}
    order = list(libs) + list(libs)[::-1]
    for name in order:
        for kernel, make, sweeps_on, symbol in (
                ("K1", k1, 5, "pair_score_kernel"), ("K3", k3, 5, "pair_packed_kernel"),
                ("K4", k4, sweeps4, "fused_score_kernel")):
            for sweeps in (sweeps_on, 0):
                times.setdefault((name, kernel, sweeps), []).append(
                    device_ms(make(libs[name], sweeps), symbol))
    print(f"[variants] {INSTANCE}, n = {n}: K1 over {T} triples, K3 over {S} slots "
          f"({V} valid); K4 over the {T4} k = 5 candidates of {BAND}; device ms a launch "
          f"(profiler), in turns {order}")
    for (name, kernel, sweeps), ts in times.items():
        print(f"[variants] {name:>13} {kernel} sweeps={sweeps}: mean {sum(ts) / len(ts)!r} "
              f"ms, runs {ts!r}")
    print(f"[overflow] rotations of the 5-sweep Jacobi where tau^2 overflows, over the "
          f"{T} triples of the scoring point (share of triples; share of 32-triple tiles "
          f"with one or more):")
    for sweep, P, Q, share, tiles in overflow_counts(x, X, table_np):
        if tiles > 0:
            print(f"[overflow] sweep {sweep + 1} rotation ({P},{Q}): {share:.4f}; {tiles:.4f}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
