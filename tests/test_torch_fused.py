"""Port parity of the generic scoring kernel's twin (ops/fused_score.py)
against the JAX package's fused_score Pallas kernel in interpret mode, and
of the BoxQP solver's k = 2 route through it.  Score tolerances are the
reference's own (tests/test_fused_score.py): feas atol 5e-4, nn rtol 2e-4
with atol 2e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpcutsel_tpu.cuts.eigen import feasibility_scores_from_point as j_feas
from sdpcutsel_tpu.loop import CutSolver as JaxCutSolver
from sdpcutsel_tpu.models.features import candidate_q_features as j_q_features
from sdpcutsel_tpu.models.scorer import load_params as flax_load_params
from sdpcutsel_tpu.ops.fused_score import fused_score as j_fused_score
from sdpcutsel_tpu.ops.fused_score import mlp_params_for_kernel
from sdpcutsel_tpu.parallel.sharding import pad_table
from sdpcutsel_tpu_torch.config import CutConfig, LPConfig, RunConfig
from sdpcutsel_tpu_torch.cuts.eigen import feasibility_scores_from_point
from sdpcutsel_tpu_torch.cuts.enumerate import combinations_table
from sdpcutsel_tpu_torch.instances import load_or_generate
from sdpcutsel_tpu_torch.loop import CutSolver
from sdpcutsel_tpu_torch.models.features import candidate_q_features
from sdpcutsel_tpu_torch.models.scorer import MLPScorer, load_params
from sdpcutsel_tpu_torch.ops.fused_score import fused_score
from test_torch_portmods import reference_config

FEAS = dict(rtol=0, atol=5e-4)
NN = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's CPU threads share this process; torch's intra-op pool on top of
    them oversubscribes the cores (10x slower on these small tensors)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(k, n=14):
    """tests/test_fused_score.py::test_fused_score_generic_k's inputs."""
    rng = np.random.default_rng(k)
    Q = rng.standard_normal((n, n)).astype(np.float32)
    Q = 0.5 * (Q + Q.T)
    x = rng.random(n).astype(np.float32)
    X = np.clip(np.outer(x, x) + 0.3 * rng.standard_normal((n, n)), 0, 1)
    X = (0.5 * (X + X.T)).astype(np.float32)
    table = combinations_table(n, k)[:900].copy()
    if k >= 4:
        # QCQP-style padded supports: repeat the last index in some rows
        table[::7, -1] = table[::7, -2]
    return Q, x, X, table


@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_fused_score_twin_matches_pallas_kernel(k):
    Q, x, X, table = _inputs(k)
    T = table.shape[0]
    tbl_pad, valid = pad_table(table, 1024)
    params, _ = flax_load_params(k, (64, 64))
    jQ, jx, jX, jtab = (jnp.asarray(a) for a in (Q, x, X, tbl_pad))
    triQ_j, scale_j = j_q_features(jQ, jtab)
    nn_j, feas_j = j_fused_score(jx, jX, jtab, triQ_j, scale_j,
                                 *mlp_params_for_kernel(params), block=1024,
                                 sweeps=6, interpret=True)
    assert valid[:T].all() and not valid[T:].any()

    tQ, tx, tX, ttab = (torch.as_tensor(a) for a in (Q, x, X, table))
    triQ, scale = candidate_q_features(tQ, ttab)
    nn, feas = fused_score(tx, tX, ttab, triQ, scale,
                           MLPScorer(load_params(k), "cpu"), 6)
    assert nn.shape == feas.shape == (T,)
    np.testing.assert_allclose(feas.numpy(), np.asarray(feas_j)[:T], **FEAS)
    np.testing.assert_allclose(nn.numpy(), np.asarray(nn_j)[:T], **NN)


@pytest.mark.parametrize("sweeps", [5, 6])
def test_feasibility_scores_from_point_matches_reference(sweeps):
    _, x, X, table = _inputs(5)
    got = feasibility_scores_from_point(torch.as_tensor(x), torch.as_tensor(X),
                                        torch.as_tensor(table), sweeps)
    if sweeps == 6:      # the reference fixes 6 sweeps
        want = np.asarray(j_feas(jnp.asarray(x), jnp.asarray(X), jnp.asarray(table)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5)
    else:                # fewer sweeps, the same eigenvalue to the score tolerance
        more = feasibility_scores_from_point(torch.as_tensor(x), torch.as_tensor(X),
                                             torch.as_tensor(table), 8)
        np.testing.assert_allclose(got.numpy(), more.numpy(), **FEAS)


def test_fused_score_refuses_devices_without_kernel():
    mlp = MLPScorer(load_params(4), "meta")
    x = torch.zeros(6, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_score(x, torch.zeros(6, 6, device="meta"),
                    torch.zeros(10, 4, dtype=torch.int32, device="meta"),
                    torch.zeros(10, 10, device="meta"), torch.zeros(10, device="meta"),
                    mlp, 6)


def test_cut_solver_k2_matches_reference():
    """BoxQP with k = 2 scores through the generic kernel's wrapper (5
    sweeps); on the CPU its twin must reproduce the JAX solver's rounds."""
    inst = load_or_generate("spar020-100-1", data_dir="data/boxqp")
    cfg = RunConfig(lp=LPConfig(max_iters=6000, tol=1e-5), cuts=CutConfig(k=2))
    ref = JaxCutSolver(inst, reference_config(cfg)).run(rounds=3)
    got = CutSolver(inst, cfg, device="cpu").run(rounds=3)
    assert len(got) == len(ref)
    assert got[0].lp_iters == ref[0].lp_iters
    assert got[0].cuts_added == ref[0].cuts_added > 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.bound, r.bound, rtol=2e-3)
    bounds = [s.bound for s in got]
    assert all(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:]))
