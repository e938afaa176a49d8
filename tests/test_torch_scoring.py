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
from sdpcutsel_tpu_torch.cuts.enumerate import combinations_table
from sdpcutsel_tpu_torch.instances import generate_spar
from sdpcutsel_tpu_torch.models.scorer import MLPScorer, load_params
from sdpcutsel_tpu_torch.ops import topk as ttopk
from sdpcutsel_tpu_torch.ops.pair_score import pair_score

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


def test_pair_score_refuses_devices_without_kernel():
    mlp = MLPScorer(load_params(3), "meta")
    x = torch.zeros(5, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pair_score(x, torch.zeros(5, 5, device="meta"), torch.zeros(5, 5, device="meta"),
                   torch.zeros(10, 3, dtype=torch.int32, device="meta"), mlp)
