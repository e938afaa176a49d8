"""Port parity of the optimality oracle: sdpcutsel_tpu_torch's
models/labels.py (batched ADMM on the k x k subproblem, torch.linalg.eigh)
against sdpcutsel_tpu's (jnp.linalg.eigh), on the same numpy blocks.

Tolerance, measured: over 300 ADMM iterations the two eigh libraries round
differently; at k = 3..5 on 64 blocks (|Q| entries ~10) the values differ by
at most 5.1e-5 (2.6e-5 of 1 + |value|), the solutions X by 4.3e-6 and the
improvements by 2.6e-5.  Held here at 1e-4 (1 + |value|) for values and
improvements, and 1e-5 for X."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpcutsel_tpu.models import labels as jlab
from sdpcutsel_tpu_torch.cuts.enumerate import combinations_table
from sdpcutsel_tpu_torch.models import labels as tlab

VAL_TOL = 1e-4
X_TOL = 1e-5


def _close(got, want, tol):
    np.testing.assert_array_less(np.abs(got - want), tol * (1.0 + np.abs(want)))


def _blocks(k: int, seed: int, B: int = 64):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((B, k, k))
    Q = 5.0 * (Q + Q.transpose(0, 2, 1))
    x = rng.random((B, k))
    X = np.clip(x[:, :, None] * x[:, None, :] + 0.2 * rng.standard_normal((B, k, k)), 0, 1)
    X = 0.5 * (X + X.transpose(0, 2, 1))
    return [a.astype(np.float32) for a in (Q, x, X)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("k", [3, 4])
def test_admm_and_improvement_match_reference(k):
    Q, x, X = _blocks(k, k)
    jv, jX = jlab.solve_subproblem_admm(jnp.asarray(Q), jnp.asarray(x))
    tv, tX = tlab.solve_subproblem_admm(torch.as_tensor(Q), torch.as_tensor(x))
    _close(tv.numpy(), np.asarray(jv), VAL_TOL)
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=0, atol=X_TOL)
    want = np.asarray(jlab.exact_improvement(jnp.asarray(Q), jnp.asarray(x), jnp.asarray(X)))
    got = tlab.exact_improvement(*(torch.as_tensor(a) for a in (Q, x, X))).numpy()
    assert (got >= 0).all() and (want > 0).sum() >= 8
    _close(got, want, VAL_TOL)


def test_box_and_psd_projection_match_reference():
    Q, x, _ = _blocks(4, 9)
    for g, w in zip(tlab._mccormick_box(torch.as_tensor(x)),
                    jlab._mccormick_box(jnp.asarray(x))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _close(tlab._proj_psd(torch.as_tensor(Q)).numpy(),
           np.asarray(jlab._proj_psd(jnp.asarray(Q))), X_TOL)
    assert float(torch.linalg.eigvalsh(tlab._proj_psd(torch.as_tensor(Q))).min()) > -1e-4


def test_exact_score_fn_matches_reference_over_all_triples():
    n = 12
    rng = np.random.default_rng(5)
    Q = rng.standard_normal((n, n))
    Q = (10.0 * (Q + Q.T)).astype(np.float32)
    x = rng.random(n).astype(np.float32)
    X = np.clip(np.outer(x, x) + 0.2 * rng.standard_normal((n, n)), 0, 1)
    X = (0.5 * (X + X.T)).astype(np.float32)
    table = combinations_table(n, 3)
    want = np.asarray(jlab.exact_score_fn(jnp.asarray(Q), jnp.asarray(table))(
        jnp.asarray(x), jnp.asarray(X), None))
    got = tlab.exact_score_fn(torch.as_tensor(Q), torch.as_tensor(table))(
        torch.as_tensor(x), torch.as_tensor(X), torch.Generator())
    assert got.shape == (220,)
    _close(got.numpy(), want, VAL_TOL)


def test_chunked_eigh_gives_the_bits_of_one_call(monkeypatch):
    """EIGH_CHUNK splits large batches (the card's batched eigh refuses
    317,750 blocks in one call); each block is decomposed alone, so the
    chunks change no bit."""
    Q, x, _ = _blocks(3, 11, B=50)
    Qt, xt = torch.as_tensor(Q), torch.as_tensor(x)
    whole = tlab.solve_subproblem_admm(Qt, xt, iters=20)
    monkeypatch.setattr(tlab, "EIGH_CHUNK", 7)
    chunked = tlab.solve_subproblem_admm(Qt, xt, iters=20)
    assert all(torch.equal(a, b) for a, b in zip(whole, chunked))
