"""Port parity: the scoring kernel's twin (features + MLP + Jacobi over the
lexicographic table) and the top-k selection against sdpcutsel_tpu on the
same numpy inputs.  Score tolerances are the reference's own
(tests/test_pair_score.py): feas atol 5e-5, nn rtol/atol 2e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpcutsel_tpu.cuts.enumerate import combinations_table as j_combinations
from sdpcutsel_tpu.models.features import candidate_features, candidate_q_features
from sdpcutsel_tpu.models.scorer import MLPScorer as FlaxMLP
from sdpcutsel_tpu.models.scorer import load_params as flax_load_params
from sdpcutsel_tpu.ops import topk as jtopk
from sdpcutsel_tpu.ops.fused_score import mlp_params_for_kernel
from sdpcutsel_tpu.ops.jacobi import min_eig_from_parts
from sdpcutsel_tpu.ops.pair_score import (
    build_pair_layout, pair_consts_static, pair_score_jnp,
)
from sdpcutsel_tpu_torch import nn_precision
from sdpcutsel_tpu_torch.cuts.enumerate import combinations_table
from sdpcutsel_tpu_torch.instances import generate_spar
from sdpcutsel_tpu_torch.models.scorer import MLPScorer, load_params
from sdpcutsel_tpu_torch.ops import topk as ttopk
from sdpcutsel_tpu_torch.models import features as tfeatures
from sdpcutsel_tpu_torch.ops.fused_score import fused_score_plain
from sdpcutsel_tpu_torch.ops.pair_score import pair_score, pair_score_plain
from test_torch_fused import NN as FUSED_NN
from test_torch_fused import _inputs as fused_inputs

FEAS = dict(rtol=0, atol=5e-5)
NN = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's CPU threads share this process; torch's intra-op pool on top of
    them oversubscribes the cores (10x slower on these small tensors)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(n=23, seed=3):
    """tests/test_pair_score.py's inputs, as numpy."""
    inst = generate_spar(n, 75, seed)
    Q = inst.Q.astype(np.float32)
    rng = np.random.default_rng(seed)
    x = rng.random(n).astype(np.float32)
    X = np.clip(np.outer(x, x) + 0.15 * rng.standard_normal((n, n)), 0, 1)
    X = (0.5 * (X + X.T)).astype(np.float32)
    return Q, x, X


def _reference_scores(Q, x, X, triples, sweeps=5):
    """tests/test_pair_score.py::_reference_scores (JAX package)."""
    params, _ = flax_load_params(3, (64, 64))
    Q, x, X, triples = (jnp.asarray(a) for a in (Q, x, X, triples))
    triQ, scale = candidate_q_features(Q, triples)
    feats = candidate_features(triQ, x, X, triples)
    nn = scale * jnp.maximum(FlaxMLP(hidden=(64, 64)).apply(params, feats), 0.0)
    xr = x[triples]
    Xr = X[triples[:, :, None], triples[:, None, :]]
    feas = -min_eig_from_parts(xr, Xr, sweeps=sweeps)
    return np.asarray(nn), np.asarray(feas)


def _port_scores(Q, x, X, table):
    mlp = MLPScorer(load_params(3), "cpu")
    nn, feas = pair_score(torch.as_tensor(x), torch.as_tensor(X),
                          torch.as_tensor(Q), torch.as_tensor(table), mlp)
    return nn.numpy(), feas.numpy()


def test_combinations_table_matches_reference():
    for n, k in [(7, 2), (12, 3), (9, 4)]:
        np.testing.assert_array_equal(combinations_table(n, k), j_combinations(n, k))


def test_pair_score_twin_matches_reference_scores():
    Q, x, X = _setup()
    table = combinations_table(23, 3)
    nn, feas = _port_scores(Q, x, X, table)
    nn_ref, feas_ref = _reference_scores(Q, x, X, table)
    np.testing.assert_allclose(feas, feas_ref, **FEAS)
    np.testing.assert_allclose(nn, nn_ref, **NN)


def test_pair_score_twin_matches_pair_layout_scores():
    """pair_score_jnp scores in the TPU pair layout; its valid slots map onto
    the port's lexicographic order through build_pair_layout's table."""
    n = 19
    Q, x, X = _setup(n=n, seed=7)
    params, _ = flax_load_params(3, (64, 64))
    W = [jnp.asarray(a) for a in mlp_params_for_kernel(params)]
    pi, pj, table_pl, valid = build_pair_layout(n)
    nn_pl, feas_pl = pair_score_jnp(jnp.asarray(x), jnp.asarray(X),
                                    pair_consts_static(jnp.asarray(Q), pi, pj), *W)
    lex = {tuple(t): r for r, t in enumerate(combinations_table(n, 3).tolist())}
    pos = np.array([lex[tuple(t)] for t in table_pl[valid].tolist()])
    assert sorted(pos.tolist()) == list(range(len(lex)))
    nn, feas = _port_scores(Q, x, X, combinations_table(n, 3))
    np.testing.assert_allclose(feas[pos], np.asarray(feas_pl)[valid], **FEAS)
    np.testing.assert_allclose(nn[pos], np.asarray(nn_pl)[valid], **NN)


def _tied_scores(rng, size):
    s = np.round(rng.random(size) * 4.0) / 4.0     # 5 distinct values, many ties
    s[rng.random(size) < 0.1] = -np.inf
    return s.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_topk_ties_match_reference(seed):
    rng = np.random.default_rng(seed)
    s = _tied_scores(rng, 300)
    mask = rng.random(300) < 0.9
    vj, ij, okj = jtopk.masked_topk(jnp.asarray(s), 40, jnp.asarray(mask))
    vt, it, okt = ttopk.masked_topk(torch.as_tensor(s), 40, torch.as_tensor(mask))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))


@pytest.mark.parametrize("alpha", [1e-4, 0.3])
def test_diverse_topk_ties_match_reference(alpha):
    n = 12
    table = combinations_table(n, 3)
    rng = np.random.default_rng(5)
    s = _tied_scores(rng, table.shape[0])
    vj, ij, okj = jtopk.diverse_topk(jnp.asarray(s), jnp.asarray(table), 20, n, alpha)
    vt, it, okt = ttopk.diverse_topk(torch.as_tensor(s), torch.as_tensor(table),
                                     20, alpha)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))


def _rna_tf32(t):
    """cvt.rna.tf32.f32 on the fp32 bit pattern: round to 10 mantissa bits,
    ties away from zero."""
    return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(a, w, passes):
    """a @ w.T as the k = 3 kernels run it on the tensor cores: K padded to
    k-steps of 8 with zeros in both operands, each operand split into hi =
    rna(v) and lo = rna(v - hi), and per k-step lo*hi, hi*lo, hi*hi (3
    passes) or hi*hi alone (1 pass) accumulated in fp32."""
    pad = -a.shape[1] % 8
    a, w = (torch.nn.functional.pad(t, (0, pad)) for t in (a, w))
    ah, wh = _rna_tf32(a), _rna_tf32(w)
    al, wl = _rna_tf32(a - ah), _rna_tf32(w - wh)
    terms = [(al, wh), (ah, wl), (ah, wh)] if passes == 3 else [(ah, wh)]
    out = torch.zeros(a.shape[0], w.shape[0])
    for k in range(0, a.shape[1], 8):
        for p, q in terms:
            out = out + p[:, k:k + 8] @ q[:, k:k + 8].T
    return out


def _tf32_nn(x, X, table, triQ, scale, mlp, passes):
    """nn with layers 1 and 2 emulated in TF32 (layer 3, the biases, relu
    and scale in fp32)."""
    l1, l2, l3 = mlp.layers
    feats = tfeatures.candidate_features(triQ, x, X, table)
    h = torch.relu(_tf32_product(feats, l1.weight, passes) + l1.bias)
    h = torch.relu(_tf32_product(h, l2.weight, passes) + l2.bias)
    return scale * torch.relu(h @ l3.weight[0] + l3.bias[0])


def _tf32_nn_excess(seed, passes):
    """The k = 3 nn scores with layers 1 and 2 emulated in TF32 against
    pair_score_plain, as a share of the nn tolerance, over all C(30, 3)
    triples of spar030-100-1."""
    n = 30
    inst = generate_spar(n, 100, 1)
    rng = np.random.default_rng(seed)
    x = rng.random(n)
    X = np.clip(np.outer(x, x) + 0.15 * rng.standard_normal((n, n)), 0, 1)
    x, X, Q = (torch.as_tensor(a, dtype=torch.float32) for a in (x, 0.5 * (X + X.T), inst.Q))
    table = torch.as_tensor(combinations_table(n, 3))
    mlp = MLPScorer(load_params(3), "cpu")
    want, _ = pair_score_plain(x, X, Q, table, mlp)
    triQ, scale = tfeatures.candidate_q_features(Q, table)
    got = _tf32_nn(x, X, table, triQ, scale, mlp, passes)
    return float(((got - want).abs() / (NN["atol"] + NN["rtol"] * want.abs())).max())


def _k4_tf32_nn_excess(k, passes):
    """K4's nn scores at width k, F = k(k+1) + k features padded to k-steps
    of 8 as csrc/score_mma.cuh pads them, with layers 1 and 2 emulated in
    TF32, against fused_score_plain on tests/test_torch_fused.py's tables,
    as a share of K4's nn tolerance (rtol 2e-4, atol 2e-5)."""
    Q, x, X, table = (torch.as_tensor(a) for a in fused_inputs(k))
    triQ, scale = tfeatures.candidate_q_features(Q, table)
    mlp = MLPScorer(load_params(k), "cpu")
    want, _ = fused_score_plain(x, X, table, triQ, scale, mlp, 6)
    got = _tf32_nn(x, X, table, triQ, scale, mlp, passes)
    return float(((got - want).abs() / (FUSED_NN["atol"] + FUSED_NN["rtol"] * want.abs())).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_tf32_mlp_keeps_the_twin_tolerance(seed):
    """The kernels' split TF32 keeps nn within a quarter of the twin
    tolerance (csrc/score_mma.cuh)."""
    assert _tf32_nn_excess(seed, passes=3) <= 0.25


def test_one_pass_tf32_mlp_breaks_the_twin_tolerance():
    """Why the split: one TF32 pass, scaled by max |Q_rho|, does not keep it."""
    assert _tf32_nn_excess(0, passes=1) > 1.0


@pytest.mark.parametrize("k", [2, 4, 5])
def test_split_tf32_mlp_keeps_the_k4_twin_tolerance(k):
    """K4's instantiations of the same body keep a quarter of its tolerance."""
    assert _k4_tf32_nn_excess(k, passes=3) <= 0.25


@pytest.mark.parametrize("k", [2, 4, 5])
def test_one_pass_tf32_mlp_breaks_the_k4_twin_tolerance(k):
    assert _k4_tf32_nn_excess(k, passes=1) > 1.0


def _k4_emulation_inputs(k):
    Q, x, X, table = (torch.as_tensor(a) for a in fused_inputs(k))
    triQ, scale = tfeatures.candidate_q_features(Q, table)
    mlp = MLPScorer(load_params(k), "cpu")
    feats = tfeatures.candidate_features(triQ, x, X, table).numpy()
    weights = [t.detach().numpy() for lin in mlp.layers for t in (lin.weight, lin.bias)]
    return (x, X, table, triQ, scale, mlp), feats, scale.numpy(), weights


@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_kernel_order_emulation_agrees_with_split_tf32(k):
    """nn_precision's emulation of K4's own order, each mma rounded to
    nearest, agrees with the split-TF32 emulation above, and both stay
    within a quarter of K4's limit of the float64 MLP."""
    args, feats, scale, weights = _k4_emulation_inputs(k)
    em = nn_precision.emulate_nn(feats, scale, weights, "rn")
    exact = nn_precision.exact_nn(feats, scale, weights)
    with torch.no_grad():
        split = _tf32_nn(*args, passes=3).numpy()
    assert nn_precision.excess(em, exact) <= 0.25
    assert nn_precision.excess(split, exact) <= 0.25
    assert nn_precision.excess(em, split) <= 0.25


def test_truncating_mma_model_rounds_toward_zero():
    """The tensor-core model "tc C/E" cuts every term and the sum toward
    zero: never above the sum rounded to nearest where all terms are
    positive, and within a few fp32 ulps of it."""
    rng = np.random.default_rng(0)
    a = nn_precision.rna_tf32(rng.random((64, 8)).astype(np.float32))
    b = nn_precision.rna_tf32(rng.random((16, 8)).astype(np.float32))
    c = rng.random((64, 16)).astype(np.float32)
    rn = nn_precision.mma(c, a, b, "rn")
    for model in ("tc 4/0", "tc 8/2"):
        tc = nn_precision.mma(c, a, b, model)
        assert (tc <= rn).all() and (tc < rn).any()
        assert (np.abs(tc - rn) <= 4 * np.spacing(rn)).all()


def test_pair_score_refuses_devices_without_kernel():
    mlp = MLPScorer(load_params(3), "meta")
    x = torch.zeros(5, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pair_score(x, torch.zeros(5, 5, device="meta"), torch.zeros(5, 5, device="meta"),
                   torch.zeros(10, 3, dtype=torch.int32, device="meta"), mlp)
