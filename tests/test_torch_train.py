"""Port parity of NN training: sdpcutsel_tpu_torch's models/train.py (and the
training side of models/scorer.py, the CLI's ``train``) against
sdpcutsel_tpu's on the CPU, on the same numpy inputs.

jax.random's bits cannot be reproduced in torch, so ``sample_subproblems``
is held by the properties of its distribution, on both packages' output,
and everything downstream of sampling by shared inputs.

Tolerances, measured on this file's inputs:
- ``make_features``, ``_spearman``, the harvests' picks (the Qhat columns
  of their features) and ``init_params``' layout: equal.
- labels (the ADMM of models/labels.py, float64 eigh, against jnp's
  float32 eigh): ``gen_dataset`` on the reference's samples within 2.4e-7
  of 1 + |label| at k = 3 and k = 4; held at test_torch_labels.py's
  1e-4 (1 + |v|).
- 20 Adam steps of batch 256 from the reference's init (torch.optim.Adam
  against optax.adam with optax.cosine_decay_schedule): per-step losses
  within 6.9e-6 relative, the final weights within 3.3e-7 (they moved by up
  to 1.0e-2); held at rtol 2e-5 and atol 1e-6.
- the harvests (the port's solvers against the reference's, 2 rounds of
  BoxQP, 1 of QCQP): the x and X columns within 5.2e-7 and the labels
  within 6.1e-7 of 1 + |v|; held at 1e-4 (1 + |v|), the labels' tolerance.
- ``cosine_lr`` (float64) against optax's float32 schedule: rtol 4e-6.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdpcutsel_tpu.instances.boxqp import generate_spar as jgenerate_spar
from sdpcutsel_tpu.models import train as jtrain
from sdpcutsel_tpu.models.scorer import MLPScorer as FlaxMLP
from sdpcutsel_tpu.models.scorer import init_params as flax_init_params
from sdpcutsel_tpu_torch import cli
from sdpcutsel_tpu_torch.config import RunConfig, ScorerConfig
from sdpcutsel_tpu_torch.instances import generate_spar
from sdpcutsel_tpu_torch.loop import CutSolver
from sdpcutsel_tpu_torch.models import train as ttrain
from sdpcutsel_tpu_torch.models.features import feature_dim
from sdpcutsel_tpu_torch.models.scorer import (MLPScorer, init_params, load_params,
                                               params_from_flax, params_of, save_params)

LABEL_TOL = 1e-4             # of 1 + |label|, as tests/test_torch_labels.py
LOSS_RTOL, WEIGHT_ATOL = 2e-5, 1e-6
METRIC_KEYS = {"holdout_mse", "holdout_r2", "holdout_spearman", "spearman_positive",
               "precision_at_top10pct", "train_time_s", "samples"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_less(np.abs(got - want), tol * (1.0 + np.abs(want)))


def _tensors(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_make_features_matches_reference(k):
    rng = np.random.default_rng(k)
    Q, x, X = (rng.standard_normal(s).astype(np.float32) for s in ((9, k, k), (9, k), (9, k, k)))
    want = np.asarray(jtrain.make_features(jnp.asarray(Q), jnp.asarray(x), jnp.asarray(X)))
    got = ttrain.make_features(*_tensors(Q, x, X)).numpy()
    assert got.shape == (9, feature_dim(k))
    np.testing.assert_array_equal(got, want)


def _samples(package: str, k: int, num: int, dup_frac: float):
    if package == "reference":
        out = jtrain.sample_subproblems(jax.random.PRNGKey(k), k, num, dup_frac=dup_frac)
        return [np.asarray(a) for a in out]
    gen = torch.Generator().manual_seed(k)
    return [a.numpy() for a in ttrain.sample_subproblems(gen, k, num, dup_frac=dup_frac)]


@pytest.mark.parametrize("package", ["reference", "port"])
@pytest.mark.parametrize("k,dup_frac", [(3, 0.0), (4, 0.25)])
def test_sample_subproblems_distribution(package, k, dup_frac):
    """The sampling contract, asserted on both packages' draws (20,000
    blocks; each frequency within 0.02 of its expectation)."""
    num = 20_000
    Q, x, X = _samples(package, k, num, dup_frac)
    assert Q.shape == (num, k, k) and x.shape == (num, k) and X.shape == (num, k, k)
    off = ~np.eye(k, dtype=bool)
    # symmetric, max-abs <= 1 (exactly 1 unless the duplication overwrote
    # the largest entry), the diagonal always kept
    np.testing.assert_array_equal(Q, Q.transpose(0, 2, 1))
    np.testing.assert_array_equal(X, X.transpose(0, 2, 1))
    peak = np.abs(Q).max(axis=(1, 2))
    assert (peak <= 1.0).all()
    assert (np.diagonal(Q, axis1=1, axis2=2) != 0).all()
    # an off-diagonal pair is dropped with probability E[(1 - p)^2], p ~ U[0.3, 1]
    assert abs((Q[:, off] == 0).mean() - 0.49 / 3) < 0.02
    # x ~ U[0, 1]^k; X in the McCormick box at x
    assert ((x >= 0) & (x <= 1)).all() and abs(x.mean() - 0.5) < 0.02
    lo = np.maximum(x[:, :, None] + x[:, None, :] - 1.0, 0.0)
    hi = np.maximum(np.minimum(x[:, :, None], x[:, None, :]), lo)
    assert (X >= lo - 1e-6).all() and (X <= hi + 1e-6).all()
    # half vertices: every entry at a bound; there the off-diagonal entries
    # are hi with probability 1/4 and the diagonal ones with 1/2
    at_hi, at_lo = X == hi, X == lo
    vertex = (at_hi | at_lo).all(axis=(1, 2))
    assert abs(vertex.mean() - 0.5) < 0.02
    assert abs(at_hi[vertex][:, off].mean() - 0.25) < 0.02
    diag_hi = np.diagonal(at_hi[vertex], axis1=1, axis2=2)
    assert abs(diag_hi.mean() - 0.5) < 0.02
    # the last coordinate duplicates the first in x, Q and X at dup_frac
    dup = x[:, -1] == x[:, 0]
    assert abs(dup.mean() - dup_frac) < 0.02
    if dup_frac > 0:
        for M in (Q, X):
            np.testing.assert_array_equal(M[dup, -1, :], M[dup, 0, :])
            np.testing.assert_array_equal(M[dup, :, -1], M[dup, :, 0])
    assert (peak[~dup] == 1.0).all()


@pytest.mark.parametrize("k,dup_frac", [(3, 0.0), (4, 0.25)])
def test_gen_dataset_labels_match_reference(k, dup_frac, monkeypatch):
    """``gen_dataset`` given the reference's own samples (in two chunks)
    gives the reference's features and, within the ADMM's tolerance, its
    labels."""
    num, chunk, key = 600, 400, jax.random.PRNGKey(7)
    want_f, want_l = jtrain.gen_dataset(key, k, num, admm_iters=400, chunk=chunk,
                                        dup_frac=dup_frac)
    chunks = []
    while sum(len(c[0]) for c in chunks) < num:
        key, sub = jax.random.split(key)
        m = min(chunk, num - sum(len(c[0]) for c in chunks))
        chunks.append(_tensors(*jtrain.sample_subproblems(sub, k, m, dup_frac=dup_frac)))
    draws = iter(chunks)

    def reference_samples(generator, kk, m, dup_frac=0.0):
        Q, x, X = next(draws)
        assert (kk, m) == (k, len(Q))
        return Q, x, X

    monkeypatch.setattr(ttrain, "sample_subproblems", reference_samples)
    got_f, got_l = ttrain.gen_dataset(torch.Generator(), k, num, admm_iters=400, chunk=chunk,
                                      dup_frac=dup_frac)
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    assert (got_l.numpy() >= 0).all() and (want_l > 1e-3).sum() >= 20
    _close(got_l.numpy(), want_l, LABEL_TOL)


def test_cosine_lr_is_optax_schedule():
    """The closed form in float64 against optax's float32 schedule."""
    sched = optax.cosine_decay_schedule(1e-3, 20)
    for t in range(25):
        np.testing.assert_allclose(ttrain.cosine_lr(1e-3, 20, t), float(sched(t)),
                                   rtol=4e-6, atol=1e-12)
    assert ttrain.cosine_lr(1e-3, 20, 0) == 1e-3 and ttrain.cosine_lr(1e-3, 20, 20) == 0.0


def test_training_steps_match_reference():
    """20 Adam steps from the reference's init on one numpy sequence of
    batch indices, against the reference's step written out with flax,
    optax.adam(optax.cosine_decay_schedule(lr, steps)) and the MSE."""
    k, steps, batch, lr = 3, 20, 256, 1e-3
    rng = np.random.default_rng(3)
    feats = rng.random((2048, feature_dim(k)), dtype=np.float32)
    labels = np.maximum(feats[:, :3].sum(1) - 1.2, 0).astype(np.float32)
    order = rng.integers(0, len(feats), (steps, batch))

    model = FlaxMLP(hidden=(64, 64))
    params = flax_init_params(k, (64, 64), 0)
    opt = optax.adam(optax.cosine_decay_schedule(lr, steps))
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, fb, lb):
        def loss_fn(p):
            return jnp.mean((model.apply(p, fb) - lb) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    mlp = MLPScorer(params_from_flax(params), "cpu", trainable=True)
    optimizer = ttrain.adam(mlp)
    ftr, ltr = _tensors(feats, labels)
    want_loss, got_loss = [], []
    for t in range(steps):
        params, opt_state, loss = step(params, opt_state, feats[order[t]], labels[order[t]])
        want_loss.append(float(loss))
        got = ttrain.train_step(mlp, optimizer, ttrain.cosine_lr(lr, steps, t), ftr, ltr,
                                torch.as_tensor(order[t]))
        got_loss.append(float(got))
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    assert got_loss[-1] < got_loss[0]
    want = params_from_flax(params)
    got = params_of(mlp)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=WEIGHT_ATOL)
    assert all(p.device.type == "cpu" for s in optimizer.state.values() for p in s.values())


def test_init_params_layout_and_truncation():
    params = init_params(3, (64, 64), seed=0)
    ref = params_from_flax(flax_init_params(3, (64, 64), 0))
    assert sorted(params) == sorted(ref)
    for name, value in params.items():
        assert value.shape == ref[name].shape and value.dtype == np.float32
    for i, fan_in in enumerate((15, 64, 64)):
        W = params[f"Dense_{i}.kernel"]
        assert not params[f"Dense_{i}.bias"].any()
        std = 1.0 / np.sqrt(fan_in) / 0.87962566103423978
        assert np.abs(W).max() <= 2.0 * std
        # the cut normal's std is 1 / sqrt(fan_in)
        assert abs(W.std() * np.sqrt(fan_in) - 1.0) < 0.1
    again = init_params(3, (64, 64), seed=0)
    other = init_params(3, (64, 64), generator=torch.Generator().manual_seed(1))
    assert all(np.array_equal(params[n], again[n]) for n in params)
    assert not np.array_equal(params["Dense_1.kernel"], other["Dense_1.kernel"])


def _assert_harvest_matches(got, want):
    (gf, gl), (wf, wl) = [(np.asarray(f), np.asarray(l)) for f, l in (got, want)]
    assert gf.shape == wf.shape and gl.shape == wl.shape
    k = int(round((np.sqrt(4 * gf.shape[1] + 1) - 2) / 2))
    tri = k * (k + 1) // 2
    # the same picks in the same order: the Qhat columns are equal
    np.testing.assert_array_equal(gf[:, :tri], wf[:, :tri])
    _close(gf[:, tri:], wf[:, tri:], LABEL_TOL)
    assert (gl >= 0).all() and (wl > 1e-3).any()
    _close(gl, wl, LABEL_TOL)


def test_harvest_dataset_matches_reference():
    kw = dict(rounds=2, per_round=64, admm_iters=40, lp_max_iters=2000, seed=3)
    want = jtrain.harvest_dataset(3, instances=[jgenerate_spar(15, 100, 1)], **kw)
    got = ttrain.harvest_dataset(3, instances=[generate_spar(15, 100, 1)], device="cpu", **kw)
    assert got[0].shape == (128, 15)
    _assert_harvest_matches(got, want)


def test_harvest_dataset_qcqp_matches_reference():
    """At tests/test_models.py::test_harvest_dataset_qcqp_shapes' settings."""
    kw = dict(specs=[(12, 30, 2, 1)], rounds=1, per_round=32, admm_iters=40, lp_max_iters=800)
    want = jtrain.harvest_dataset_qcqp(4, **kw)
    got = ttrain.harvest_dataset_qcqp(4, device="cpu", **kw)
    assert got[0].shape == (32, feature_dim(4))
    _assert_harvest_matches(got, want)


def test_spearman_matches_reference():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(500)
    b = a + rng.standard_normal(500)
    b[:50] = b[0]                                     # ties
    assert ttrain._spearman(a, b) == jtrain._spearman(a, b)
    assert ttrain._spearman(a, a) == pytest.approx(1.0)


def test_trained_weights_round_trip_into_the_solver(tmp_path):
    """save_params -> ScorerConfig.weights_path -> CutSolver: the solver's
    MLP holds the saved weights, and its scores are the reference's MLP on
    the same weights."""
    params = init_params(3, (64, 64), seed=5)
    path = str(tmp_path / "w" / "mlp_k3.npz")
    save_params(params, path)
    loaded = load_params(3, path)
    assert all(np.array_equal(loaded[n], params[n]) for n in params)
    solver = CutSolver(generate_spar(12, 100, 3),
                       RunConfig(scorer=ScorerConfig(strategy="neural", weights_path=path)),
                       device="cpu")
    assert all(np.array_equal(v, params[n]) for n, v in params_of(solver.mlp).items())
    assert not any(p.requires_grad for p in solver.mlp.parameters())
    feats = np.random.default_rng(1).random((64, 15), dtype=np.float32)
    flax_params = {"params": {f"Dense_{i}": {"kernel": params[f"Dense_{i}.kernel"],
                                             "bias": params[f"Dense_{i}.bias"]}
                              for i in range(3)}}
    want = np.asarray(FlaxMLP(hidden=(64, 64)).apply(flax_params, jnp.asarray(feats)))
    got = solver.mlp(torch.as_tensor(feats)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert solver.do_round().cuts_added > 0


def test_train_scorer_small_run_on_cpu(tmp_path):
    """A small train_scorer run (no harvest): the reference's metric keys,
    weights written where asked and loadable, trainable MLP, and a second run
    from the same seed repeating the weights bit for bit."""
    kw = dict(k=3, samples=1024, steps=30, batch=128, harvest=False, verbose=False,
              device="cpu")
    p1, m1 = ttrain.train_scorer(out_path=str(tmp_path / "a.npz"), **kw)
    p2, m2 = ttrain.train_scorer(out_path=str(tmp_path / "b.npz"), **kw)
    assert set(m1) == METRIC_KEYS and m1["samples"] == 1024
    assert all(np.array_equal(p1[n], p2[n]) for n in p1)
    assert {n: m for n, m in m1.items() if n != "train_time_s"} == \
           {n: m for n, m in m2.items() if n != "train_time_s"}
    saved = load_params(3, str(tmp_path / "a.npz"))
    assert all(np.array_equal(saved[n], p1[n]) for n in p1)
    assert not all(np.array_equal(p1[n], v) for n, v in init_params(3).items())


def test_cli_train_passes_its_flags(monkeypatch, capsys):
    calls = []

    def fake_train_scorer(**kw):
        calls.append(kw)
        return {}, {"holdout_spearman": 0.5, "spearman_positive": None}

    monkeypatch.setattr(ttrain, "train_scorer", fake_train_scorer)
    assert cli.main(["train", "--k", "4", "--samples", "123", "--steps", "7", "--seed", "3",
                     "--out", "w.npz", "--cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        {"holdout_spearman": 0.5, "spearman_positive": None}
    assert cli.main(["train"]) == 0
    # the module's own entry point is cli train
    assert ttrain.main(["--k", "5", "--cpu"]) == 0
    assert calls == [
        dict(k=4, samples=123, steps=7, seed=3, out_path="w.npz", device=torch.device("cpu")),
        dict(k=3, samples=200_000, steps=4000, seed=0, out_path=None,
             device=torch.device("cuda")),
        dict(k=5, samples=200_000, steps=4000, seed=0, out_path=None,
             device=torch.device("cpu"))]


@pytest.mark.parametrize("kernel", ["pair_score", "pair_packed", "fused_score"])
def test_kernels_refuse_other_hidden_widths(kernel):
    """A trained MLP of another hidden width reaches no scoring kernel: each
    wrapper's launch refuses it before touching the card."""
    module = importlib.import_module(f"sdpcutsel_tpu_torch.ops.{kernel}")
    k = 4 if kernel == "fused_score" else 3
    mlp = MLPScorer(init_params(k, (32, 32)), "cpu", trainable=True)
    n = 8
    x, X, Q = torch.rand(n), torch.rand(n, n), torch.rand(n, n)
    table = torch.tensor([[0, 1, 2, 3][:k]], dtype=torch.int32)
    with pytest.raises(ValueError, match="64-64-1 MLP"):
        if kernel == "pair_score":
            module._launch(x, X, Q, table, mlp, 5)
        elif kernel == "pair_packed":
            module._launch(x, X, Q, None, mlp)
        else:
            module._launch(x, X, table, torch.zeros(1, 10), torch.ones(1), mlp, 6)
