"""Where K4's nn error comes from, on the card.

    python3 -m sdpcutsel_tpu_torch.nn_precision

K4 (``csrc/fused_score.cu``) scores the clique tables of qcqpband100-5-25-1
and qcqp025-25-4-2 at k = 4 and 5, at ``chip_smoke.py``'s points
(``scoring_variants.fused_args``).  Its nn is held against:
  - the twin on the card (cuBLAS with TF32 off: ``chip_smoke.py``'s
    reference) and the twin on the CPU;
  - the same MLP in float64 on the same float32 inputs (``exact``);
  - emulations of the kernel's own arithmetic on the host, in its order:
    split TF32 (per k-step lo*hi, hi*lo, hi*hi, each an m16n8k8 product),
    the biases and relu in fp32, layer 3 in the thread's fma order and the
    quad's shuffle sums.  Every product of two TF32 operands is exact in
    fp32.  How an mma adds its products to its accumulator is the model:
    ``rn`` rounds the exact sum once to nearest; ``tc C/E`` adds as tensor
    cores are reported to (Fasi et al., 2021): C products a step with the
    accumulator, each term cut toward zero to 24 + E bits below the largest
    term's leading bit, and the sum truncated to fp32.
Every comparison prints its largest excess over the nn tolerance (rtol
2e-4, atol 2e-5; 1.0 is the limit) and the share of rows where the two give
the same bits.  The models are scanned on band100 at k = 5; the one that
gives K4's bits most often is then run on every table.  The arrays go to
``chiprun_out/nn_precision.npz``.  Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import copy
import os
import subprocess
import sys

import numpy as np
import torch

from .instances import load_or_generate_qcqp
from .models import features
from .ops.fused_score import fused_score, fused_score_plain
from .scoring_variants import clique_table, fused_args

RTOL, ATOL = 2e-4, 2e-5
TABLES = (("qcqpband100-5-25-1", 5), ("qcqpband100-5-25-1", 4),
          ("qcqp025-25-4-2", 4), ("qcqp025-25-4-2", 5))
MODELS = ("rn", *(f"tc {c}/{e}" for c in (4, 8) for e in (0, 1, 2, 3)))
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chiprun_out")
_f32, _f64 = np.float32, np.float64


def excess(got, want) -> float:
    """max |got - want| / (atol + rtol |want|) over the rows."""
    got, want = np.asarray(got, _f64), np.asarray(want, _f64)
    return float((np.abs(got - want) / (ATOL + RTOL * np.abs(want))).max())


def same_bits(a, b) -> float:
    return float((np.asarray(a, _f32).view(np.int32) == np.asarray(b, _f32).view(np.int32)).mean())


def rna_tf32(v: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: 10 mantissa bits, ties away from zero."""
    bits = np.asarray(v, _f32).view(np.int32)
    return ((bits + np.int32(0x1000)) & np.int32(~0x1FFF)).view(_f32)


def split(v: np.ndarray):
    hi = rna_tf32(v)
    return hi, rna_tf32(np.asarray(v, _f32) - hi)


def _rz_f32(s: np.ndarray) -> np.ndarray:
    """float64 -> float32, rounded toward zero."""
    f = s.astype(_f32)
    up = np.abs(f.astype(_f64)) > np.abs(s)
    f[up] = np.nextafter(f[up], _f32(0))
    return f


def mma(c: np.ndarray, a: np.ndarray, b: np.ndarray, model: str) -> np.ndarray:
    """c + a @ b.T for one k-step of 8: c (R, N) fp32, a (R, 8) and b (N, 8)
    TF32 values, under ``model``."""
    p = a[:, None, :].astype(_f64) * b[None, :, :].astype(_f64)     # exact
    if model == "rn":
        return (c.astype(_f64) + p.sum(-1)).astype(_f32)
    chunk, extra = (int(v) for v in model.split()[1].split("/"))
    acc = c.astype(_f64)
    for k in range(0, 8, chunk):
        terms = np.concatenate([acc[..., None], p[..., k:k + chunk]], axis=-1)
        _, e = np.frexp(np.abs(terms).max(-1))        # largest term < 2^e
        q = np.ldexp(1.0, e - 24 - extra)[..., None]
        acc = _rz_f32((np.trunc(terms / q) * q).sum(-1)).astype(_f64)
    return acc.astype(_f32)


def _layer(a: np.ndarray, w: np.ndarray, model: str) -> np.ndarray:
    """a @ w.T in split TF32 as score_mma.cuh::mlp_rows runs it: k padded
    to steps of 8 with zeros; per step lo*hi, hi*lo, hi*hi.  Layer 2's
    k-step s takes hidden units 8s, 8s + 2, .., 8s + 6 as k = 0..3 and
    8s + 1, .., 8s + 7 as k = 4..7 (W2's column order)."""
    pad = -a.shape[1] % 8
    a = np.pad(a, ((0, 0), (0, pad)))
    w = np.pad(w, ((0, 0), (0, pad)))
    if a.shape[1] == 64:
        order = np.array([8 * s + o for s in range(8) for o in (0, 2, 4, 6, 1, 3, 5, 7)])
        a, w = a[:, order], w[:, order]
    (ah, al), (wh, wl) = split(a), split(w)
    d = np.zeros((a.shape[0], w.shape[0]), _f32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        for p, q in ((al, wh), (ah, wl), (ah, wh)):
            d = mma(d, p[:, s], q[:, s], model)
    return d


def _fma(a, b, c):
    return (np.asarray(a, _f64) * np.asarray(b, _f64) + np.asarray(c, _f64)).astype(_f32)


def emulate_nn(feats: np.ndarray, scale: np.ndarray, weights, model: str,
               rows: int = 4096) -> np.ndarray:
    """K4's nn on the host under ``model``: feats (T, F) fp32, scale (T,),
    weights (W1, b1, W2, b2, W3, b3) in PyTorch's layout."""
    W1, b1, W2, b2, W3, b3 = (np.asarray(w, _f32) for w in weights)
    out = np.empty(feats.shape[0], _f32)
    for r in range(0, feats.shape[0], rows):
        f = feats[r:r + rows]
        h = np.maximum(_layer(f, W1, model) + b1, _f32(0))
        o = np.maximum(_layer(h, W2, model) + b2, _f32(0))
        v = []
        for t in range(4):                      # a quad's lanes, 16 columns each
            p = np.zeros(f.shape[0], _f32)
            for j in range(8):
                for u in (2 * t, 2 * t + 1):
                    p = _fma(W3[0, 8 * j + u], o[:, 8 * j + u], p)
            v.append(p)
        total = (v[0] + v[1]) + (v[2] + v[3])
        out[r:r + rows] = scale[r:r + rows] * np.maximum(total + b3[0], _f32(0))
    return out


def exact_nn(feats: np.ndarray, scale: np.ndarray, weights) -> np.ndarray:
    W1, b1, W2, b2, W3, b3 = (np.asarray(w, _f64) for w in weights)
    h = np.maximum(feats.astype(_f64) @ W1.T + b1, 0)
    h = np.maximum(h @ W2.T + b2, 0)
    return scale.astype(_f64) * np.maximum(h @ W3[0] + b3[0], 0)


def measure(name: str, k: int, dev) -> dict:
    """K4 and both twins at chip_smoke.py's point of one clique table, and
    the exact nn; host arrays."""
    q = load_or_generate_qcqp(name)
    args = fused_args(q.Q0, clique_table(q, k), 6, dev)
    x, X, table, triQ, scale, mlp, sweeps = args
    nn_k, _ = fused_score(*args)
    nn_card, _ = fused_score_plain(*args)
    xc, Xc, tc, triQc, sc = (t.cpu() for t in args[:5])
    nn_cpu, _ = fused_score_plain(xc, Xc, tc, triQc, sc, copy.deepcopy(mlp).cpu(), sweeps)
    feats = features.candidate_features(triQc, xc, Xc, tc).numpy()
    weights = [t.detach().cpu().numpy() for lin in mlp.layers for t in (lin.weight, lin.bias)]
    sc = sc.numpy()
    return {"k4": nn_k.cpu().numpy(), "twin_card": nn_card.cpu().numpy(),
            "twin_cpu": nn_cpu.detach().numpy(), "exact": exact_nn(feats, sc, weights),
            "feats": feats, "scale": sc, "weights": weights}


def main() -> int:
    if not torch.cuda.is_available():
        print("nn_precision: no CUDA device visible to torch", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    with torch.no_grad():
        runs = {(name, k): measure(name, k, dev) for name, k in TABLES}
    band = runs[TABLES[0]]
    fit = {}
    for model in MODELS:
        em = emulate_nn(band["feats"], band["scale"], band["weights"], model)
        fit[model] = (same_bits(em, band["k4"]), excess(em, band["k4"]))
        print(f"[model] {TABLES[0][0]} k={TABLES[0][1]}: {model:>7}: rows equal to K4 bit for "
              f"bit {fit[model][0]:.4f}; largest difference from K4 {fit[model][1]:.4f} of "
              f"the limit", flush=True)
    best = max(MODELS, key=lambda m: fit[m])
    saved = {}
    for (name, k), r in runs.items():
        em_rn = emulate_nn(r["feats"], r["scale"], r["weights"], "rn")
        em_best = em_rn if best == "rn" else emulate_nn(r["feats"], r["scale"], r["weights"], best)
        worst = int(np.argmax(np.abs(r["k4"].astype(_f64) - r["twin_card"])
                              / (ATOL + RTOL * np.abs(r["twin_card"].astype(_f64)))))
        print(f"[nn] {name} k={k} ({r['k4'].shape[0]} rows), excess over the nn tolerance: "
              f"K4 vs twin on the card {excess(r['k4'], r['twin_card']):.4f}, vs twin on the "
              f"CPU {excess(r['k4'], r['twin_cpu']):.4f}, vs exact {excess(r['k4'], r['exact']):.4f}; "
              f"twin on the card vs exact {excess(r['twin_card'], r['exact']):.4f}, on the CPU "
              f"{excess(r['twin_cpu'], r['exact']):.4f}; twin card vs CPU "
              f"{excess(r['twin_card'], r['twin_cpu']):.4f}", flush=True)
        print(f"[nn] {name} k={k}: emulation rn vs exact {excess(em_rn, r['exact']):.4f}, vs K4 "
              f"{excess(em_rn, r['k4']):.4f} ({same_bits(em_rn, r['k4']):.4f} of rows equal); "
              f"{best} vs exact {excess(em_best, r['exact']):.4f}, vs K4 "
              f"{excess(em_best, r['k4']):.4f} ({same_bits(em_best, r['k4']):.4f} of rows "
              f"equal); {best} vs twin on the card {excess(em_best, r['twin_card']):.4f}", flush=True)
        print(f"[nn] {name} k={k}: the row of K4's largest excess over the card's twin, {worst}: "
              f"K4 {float(r['k4'][worst])!r}, twin card {float(r['twin_card'][worst])!r}, twin "
              f"CPU {float(r['twin_cpu'][worst])!r}, exact {float(r['exact'][worst])!r}, "
              f"{best} {float(em_best[worst])!r}, scale {float(r['scale'][worst])!r}", flush=True)
        tag = f"{name}_k{k}"
        saved.update({f"{tag}_{key}": r[key] for key in ("k4", "twin_card", "twin_cpu", "exact")})
        saved[f"{tag}_{best.replace(' ', '').replace('/', '_')}"] = em_best
    os.makedirs(OUT, exist_ok=True)
    np.savez_compressed(os.path.join(OUT, "nn_precision.npz"), **saved)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
