"""Port parity of the candidate sharding (sdpcutsel_tpu_torch.parallel.mesh,
.sharding) against sdpcutsel_tpu.parallel on its 8 virtual CPU devices:
padded tables, shards, the pair layout's sharded table, and the sharded
score -> local top-k -> gather -> global top-k step for cand = 1, 2, 4, 8
(rows equal, values within rtol 1e-5, tests/test_sharding.py's tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpcutsel_tpu.cuts import assemble_Z as j_assemble_Z
from sdpcutsel_tpu.cuts import feasibility_scores as j_feasibility_scores
from sdpcutsel_tpu.parallel import make_mesh as j_make_mesh
from sdpcutsel_tpu.parallel import pad_table as j_pad_table
from sdpcutsel_tpu.parallel import shard_candidates as j_shard_candidates
from sdpcutsel_tpu.parallel import sharded_score_and_select as j_sharded
from sdpcutsel_tpu.parallel.sharding import shard_pair_candidates as j_shard_pairs
from sdpcutsel_tpu_torch.cuts.eigen import feasibility_scores_from_point
from sdpcutsel_tpu_torch.cuts.enumerate import combinations_table
from sdpcutsel_tpu_torch.parallel import (gather_cand, make_mesh, pad_table, shard_candidates,
                                          shard_pair_candidates, sharded_score_and_select)
from sdpcutsel_tpu_torch.parallel.sharding import local_topk, shards

N, K, SEL = 12, 3, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def point():
    """tests/test_sharding.py's scoring point."""
    rng = np.random.default_rng(3)
    x = rng.random(N).astype(np.float32)
    X = np.clip(np.outer(x, x) + 0.2 * rng.standard_normal((N, N)), 0, 1)
    return x, (0.5 * (X + X.T)).astype(np.float32)


@pytest.mark.parametrize("T,parts", [(20, 8), (220, 3), (64, 8)])
def test_pad_table_matches_reference(T, parts):
    table = combinations_table(N, K)[:T]
    got, want = pad_table(table, parts), j_pad_table(table, parts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape[0] % parts == 0 and got[1].sum() == T


@pytest.mark.parametrize("cand", [1, 2, 4, 8])
def test_shard_candidates_match_reference(cand):
    table = combinations_table(13, K)
    t, v = shard_candidates(table, make_mesh(1, cand), device="cpu")
    jt, jv = j_shard_candidates(table, j_make_mesh(data=1, cand=cand))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert t.dtype == torch.int32
    parts = shards(t, make_mesh(1, cand))
    assert len(parts) == cand and all(p.shape[0] == t.shape[0] // cand for p in parts)
    assert torch.equal(torch.cat(parts), t)


@pytest.mark.parametrize("cand", [1, 2, 4])
def test_shard_pair_candidates_match_reference(cand):
    t, v = shard_pair_candidates(N, make_mesh(1, cand), block=128, device="cpu")
    jt, jv = j_shard_pairs(N, j_make_mesh(data=1, cand=cand), block=128)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    # every shard holds whole 128-slot pair runs
    for part in shards(t, make_mesh(1, cand)):
        runs = part.view(-1, 128, 3)
        assert (runs[:, :, :2] == runs[:, :1, :2]).all()


@pytest.mark.parametrize("cand", [1, 2, 4, 8])
def test_sharded_score_and_select_matches_reference(point, cand):
    x, X = point
    table = combinations_table(N, K)
    t, v = shard_candidates(table, make_mesh(1, cand), device="cpu")
    step = sharded_score_and_select(
        lambda x_, X_, ts, vs: feasibility_scores_from_point(x_, X_, ts),
        make_mesh(1, cand), SEL)
    vals, rows, ok = step(torch.as_tensor(x), torch.as_tensor(X), t, v)

    jmesh = j_make_mesh(data=1, cand=cand)
    jt, jv = j_shard_candidates(table, jmesh)
    jstep = j_sharded(lambda x_, X_, ts, vs: j_feasibility_scores(j_assemble_Z(x_, X_, ts)),
                      jmesh, SEL)
    jvals, jrows, jok = jstep(jnp.asarray(x), jnp.asarray(X), jt, jv)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-5)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


def test_local_topk_breaks_ties_to_the_lower_row():
    scores = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0, 2.0]])
    valid = torch.tensor([True, True, True, True, False, True])
    table = torch.arange(6, dtype=torch.int32)[:, None].expand(6, 3)
    vals, rows = local_topk(scores, valid, table, 3)
    assert vals.tolist() == [[3.0, 3.0, 2.0]]
    assert rows[0, :, 0].tolist() == [1, 2, 5]
    with pytest.raises(ValueError):
        local_topk(scores, valid, table, 7)


def test_gather_cand_concatenates_in_shard_order():
    parts = [torch.full((2, 3), float(s)) for s in range(4)]
    got = gather_cand(parts, 1)
    assert got.shape == (2, 12)
    assert got[0].tolist() == [0.0] * 3 + [1.0] * 3 + [2.0] * 3 + [3.0] * 3


def test_mesh_checks_its_axes():
    assert (make_mesh(2, 4).data, make_mesh(2, 4).cand) == (2, 4)
    with pytest.raises(ValueError):
        make_mesh(0, 1)
    with pytest.raises(ValueError):
        shards(torch.zeros(10), make_mesh(1, 4))
