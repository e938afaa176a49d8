"""Port parity of the tiered packed pair layout and its scoring twin
(sdpcutsel_tpu_torch/ops/pair_packed.py) against sdpcutsel_tpu on the same
numpy inputs.  Layout arrays are equal element for element; scores agree at
the reference's own packed tolerances (tests/test_pair_packed.py): feas
atol 2e-5, nn 2e-4 (here rtol and atol, since the trained weights give
scores of order 10)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpcutsel_tpu.models.scorer import load_params as flax_load_params
from sdpcutsel_tpu.ops import pair_packed as jpacked
from sdpcutsel_tpu.ops.fused_score import mlp_params_for_kernel
from sdpcutsel_tpu.ops.pair_score import build_pair_layout
from sdpcutsel_tpu_torch.cuts.enumerate import combinations_table
from sdpcutsel_tpu_torch.models.scorer import MLPScorer, load_params
from sdpcutsel_tpu_torch.ops.pair_packed import (
    build_packed_pair_layout, packed_layout, packed_score, packed_score_plain,
    slot_triples,
)
from sdpcutsel_tpu_torch.ops.pair_score import pair_score_plain

FEAS = dict(rtol=0, atol=2e-5)
NN = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's CPU threads share this process; torch's intra-op pool on top of
    them oversubscribes the cores (10x slower on these small tensors)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(n, seed=0):
    """tests/test_pair_packed.py::_rand_problem's Q, x, X, as float32 numpy."""
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n))
    x = rng.random(n)
    X = np.clip(np.outer(x, x) + 0.2 * rng.standard_normal((n, n)), 0, 1)
    return tuple(a.astype(np.float32) for a in (0.5 * (Q + Q.T), x, 0.5 * (X + X.T)))


def _reference(Q, x, X, **kw):
    params, _ = flax_load_params(3, (64, 64))
    W = [jnp.asarray(a) for a in mlp_params_for_kernel(params)]
    lay = jpacked.build_packed_pair_layout(Q.shape[0])
    consts = jpacked.packed_consts_static(jnp.asarray(Q), lay)
    nn, feas = jpacked.packed_score(jnp.asarray(x), jnp.asarray(X), consts, *W, **kw)
    return np.asarray(nn), np.asarray(feas)


def _port(Q, x, X):
    lay = packed_layout(Q.shape[0], "cpu")
    nn, feas = packed_score(*(torch.as_tensor(a) for a in (x, X, Q)), lay,
                            MLPScorer(load_params(3), "cpu"))
    return nn.numpy(), feas.numpy(), lay.valid.numpy()


@pytest.mark.parametrize("n", [66, 70, 125, 128])
def test_packed_layout_equals_reference(n):
    got, want = build_packed_pair_layout(n), jpacked.build_packed_pair_layout(n)
    for key in ("iu", "ju", "table", "valid"):
        np.testing.assert_array_equal(got[key], want[key])
    for a, b in zip([*got["tiers"], *got["lmaps"]], [*want["tiers"], *want["lmaps"]]):
        np.testing.assert_array_equal(a, b)
    # the kernel's slot decode (tier, row, lane -> pair id, lane map) gives the table
    i, j, l, valid = slot_triples(packed_layout(n, "cpu"))
    np.testing.assert_array_equal(valid.numpy(), want["valid"])
    np.testing.assert_array_equal(torch.stack([i, j, l], 1)[valid].numpy(),
                                  want["table"][want["valid"]])


@pytest.mark.parametrize("n", [66, 70, 125, 128])
def test_valid_slots_list_the_valid_triples_in_order(n):
    """The kernel's dense tiles: the valid slots in slot order, whose decoded
    triples are the layout's valid triples."""
    lay = packed_layout(n, "cpu")
    np.testing.assert_array_equal(lay.valid_slots.numpy(),
                                  torch.nonzero(lay.valid).flatten().numpy())
    i, j, l, valid = slot_triples(lay)
    s = lay.valid_slots.long()
    assert bool(valid[s].all()) and lay.valid_slots.shape[0] == n * (n - 1) * (n - 2) // 6
    np.testing.assert_array_equal(torch.stack([i, j, l], 1)[s].numpy(),
                                  lay.table[s].numpy())


@pytest.mark.parametrize("n", [3, 20, 70, 125])
def test_pair_layout_equals_reference(n):
    """The reference's pair layout (``pair_layout="on"``) in the port: its
    valid slots are the lexicographic table, row for row, so the port
    scores and selects in that table."""
    _, _, table, valid = build_pair_layout(n)
    np.testing.assert_array_equal(table[valid], combinations_table(n, 3))


@pytest.mark.parametrize("n", [70, 125])
def test_packed_twin_matches_reference(n):
    Q, x, X = _problem(n)
    nn, feas, valid = _port(Q, x, X)
    nn_r, feas_r = _reference(Q, x, X, use_kernel=False)
    assert valid.sum() == n * (n - 1) * (n - 2) // 6
    np.testing.assert_allclose(feas[valid], feas_r[valid], **FEAS)
    np.testing.assert_allclose(nn[valid], nn_r[valid], **NN)
    assert np.all(nn[~valid] == -np.inf) and np.all(feas[~valid] == -np.inf)


def test_packed_twin_matches_pallas_interpret():
    """The Pallas kernel itself, in interpret mode on the CPU."""
    Q, x, X = _problem(70, seed=1)
    nn, feas, valid = _port(Q, x, X)
    nn_r, feas_r = _reference(Q, x, X, use_kernel=True, interpret=True)
    np.testing.assert_allclose(feas[valid], feas_r[valid], **FEAS)
    np.testing.assert_allclose(nn[valid], nn_r[valid], **NN)


def test_packed_twin_equals_pair_score_plain():
    n = 70
    Q, x, X = (torch.as_tensor(a) for a in _problem(n, seed=2))
    lay = packed_layout(n, "cpu")
    mlp = MLPScorer(load_params(3), "cpu")
    nn, feas = packed_score_plain(x, X, Q, lay, mlp)
    nn_p, feas_p = pair_score_plain(x, X, Q, lay.table[lay.valid], mlp)
    assert torch.equal(nn[lay.valid], nn_p) and torch.equal(feas[lay.valid], feas_p)
    assert bool((nn[~lay.valid] == -torch.inf).all())


def test_packed_score_refuses_devices_without_kernel():
    mlp = MLPScorer(load_params(3), "meta")
    lay = packed_layout(70, "meta")
    x = torch.zeros(70, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        packed_score(x, torch.zeros(70, 70, device="meta"),
                     torch.zeros(70, 70, device="meta"), lay, mlp)


def test_packed_layout_refuses_small_n():
    with pytest.raises(AssertionError, match="n >= 66"):
        packed_layout(65, "cpu")
    Q, x, X = (torch.as_tensor(a) for a in _problem(60))
    with pytest.raises(ValueError, match="n = 60"):
        packed_score(x, X, Q, packed_layout(66, "cpu"), MLPScorer(load_params(3), "cpu"))
