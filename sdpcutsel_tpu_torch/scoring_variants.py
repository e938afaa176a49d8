"""Where the k = 3 scoring kernels' time goes, on the card.

    python3 -m sdpcutsel_tpu_torch.scoring_variants

K1 (``csrc/pair_score.cu``) and K3 (``csrc/pair_packed.cu``) as built, timed
in turns with variants built from the same sources into
``build/cuda/variants/`` (ignored):
  - ``producers=N``: the warp-specialised CTA with N producer warps in place
    of 20 (``kProducers`` in ``csrc/score_mma.cuh`` is the only change);
  - ``fast-math``: the sources as they are, compiled with
    ``nvcc -use_fast_math`` (approximate division and square root, flush to
    zero).  Its feas bits differ from the port's, so it is never a kernel of
    the port: it measures what the Jacobi's IEEE semantics cost.
Each at n = 125 on spar125-100-1's scoring point (the point of
``chip_smoke.py``), with 5 Jacobi sweeps and with 0 (no Jacobi: the gathers,
the features and the MLP alone), CUDA events over 50 launches after a
warm-up, in the order as built, variants, variants reversed, as built.

It also counts, in numpy float32 on the host (IEEE arithmetic, as the card's;
the card contracts some products into FMAs, so the counts are close, not
exact), the rotations of the 4 x 4 Jacobi where tau^2 overflows to inf.  There
``sqrtf(1 + tau^2)`` and ``sgn / (|tau| + inf)`` take the slow paths of the
IEEE square root and division; the share of 32-triple tiles with at least one
such lane is the share of warps that wait on that path in that rotation.

Needs a CUDA device; exits 2 without one.
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
from .instances import parse_boxqp
from .models.scorer import MLPScorer, load_params
from .ops.pair_packed import packed_layout

INSTANCE = "spar125-100-1"
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "boxqp")
VARIANT_DIR = os.path.join(_build.BUILD_DIR, "variants")
PRODUCERS = "constexpr int kProducers = 20;"


def scoring_point(inst, dev, seed: int = 0):
    """The random (x, X) of the k = 3 kernel checks (here and in
    chip_smoke.py), with the instance's Q."""
    n = inst.n
    rng = np.random.default_rng(seed)
    x = rng.random(n)
    X = np.clip(np.outer(x, x) + 0.15 * rng.standard_normal((n, n)), 0, 1)
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                 for a in (x, 0.5 * (X + X.T), inst.Q))


def build_variants(variants: dict) -> dict:
    """{name: (header substitution or None, extra nvcc flags)} -> {name:
    ctypes library}, every variant compiled at once."""
    nvcc = _build._nvcc()
    shutil.rmtree(VARIANT_DIR, ignore_errors=True)
    procs = {}
    for name, (sub, flags) in variants.items():
        d = os.path.join(VARIANT_DIR, name)
        shutil.copytree(_build.CSRC_DIR, d)
        if sub is not None:
            path = os.path.join(d, "score_mma.cuh")
            with open(path) as f:
                src = f.read()
            assert PRODUCERS in src
            with open(path, "w") as f:
                f.write(src.replace(PRODUCERS, sub))
        procs[name] = [subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *flags, "-c", "-o", os.path.join(d, f"{k}.o"),
             os.path.join(d, f"{k}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for k in ("pair_score", "pair_packed")]
    libs = {}
    for name, ps in procs.items():
        log = "".join(p.communicate(timeout=600)[0] for p in ps)
        if any(p.returncode for p in ps):
            raise RuntimeError(f"variant {name} does not build:\n{log}")
        d = os.path.join(VARIANT_DIR, name)
        subprocess.run([nvcc, *_build.NVCC_FLAGS[:2], "-shared", "-o", os.path.join(d, "lib.so"),
                        os.path.join(d, "pair_score.o"), os.path.join(d, "pair_packed.o")],
                       check=True, capture_output=True, timeout=600)
        regs = [line.split(":", 1)[-1].strip() for line in log.splitlines()
                if "registers" in line or "spill" in line]
        print(f"[variant {name}] {'; '.join(regs)}", flush=True)
        lib = ctypes.CDLL(os.path.join(d, "lib.so"))
        for fn in ("pair_score_launch", "pair_packed_launch"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        libs[name] = lib
    return libs


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
    weights = [t.contiguous() for lin in mlp.layers for t in (lin.weight, lin.bias)]

    libs = {"as built": _build.lib(), **build_variants({
        "producers=12": ("constexpr int kProducers = 12;", []),
        "producers=28": ("constexpr int kProducers = 28;", []),
        "fast-math": (None, ["-use_fast_math"]),
    })}
    T, S, V = table.shape[0], lay.slots, lay.valid_slots.shape[0]
    nn1, feas1 = torch.empty(T, device=dev), torch.empty(T, device=dev)
    nn3, feas3 = torch.empty(S, device=dev), torch.empty(S, device=dev)

    def k1(lib, sweeps):
        def run():
            err = lib.pair_score_launch(
                T, n, sweeps, *(t.data_ptr() for t in (table, x, X, Q, *weights)),
                nn1.data_ptr(), feas1.data_ptr(), torch.cuda.current_stream().cuda_stream)
            _build.check(err, "pair_score_launch")
        return run

    def k3(lib, sweeps):
        def run():
            err = lib.pair_packed_launch(
                S, V, n, lay.R[0], lay.R[1], sweeps,
                *(t.data_ptr() for t in (lay.valid_slots, lay.rows, lay.iu, lay.ju, x, X, Q,
                                         *weights)),
                nn3.data_ptr(), feas3.data_ptr(), torch.cuda.current_stream().cuda_stream)
            _build.check(err, "pair_packed_launch")
        return run

    def ms(fn, reps=50):
        for _ in range(2):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    times: dict = {}
    order = list(libs) + list(libs)[::-1]
    for name in order:
        for kernel, make in (("K1", k1), ("K3", k3)):
            for sweeps in (5, 0):
                times.setdefault((name, kernel, sweeps), []).append(ms(make(libs[name], sweeps)))
    print(f"[variants] {INSTANCE}, n = {n}: K1 over {T} triples, K3 over {S} slots "
          f"({V} valid); ms a launch, in turns {order}")
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
