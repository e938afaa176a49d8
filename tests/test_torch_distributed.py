"""The port's multi-process parallel/ on the CPU over gloo: ranks are local
subprocesses joined through a file store under tmp_path (no TCP port, so
parallel test workers cannot collide), each with one torch thread, each
waited on with a time limit (a hung collective fails the test).

  * run_multihost at 2 x 2 (4 ranks: 'data' across the pairs, 'cand' within
    a pair), n = 10, batch 4, 1 round, lp-iters 200, feasibility, equals bit
    for bit the in-process run of each 'data' shard's instances at the
    logical Mesh(1, 2), and matches the JAX package's batched round at a
    (1, 1) mesh on the same inputs (tests/test_multihost.py runs the
    reference so): the same pools, f64 certificates within rtol 2e-3
    (tests/test_torch_batched.py's tolerance);
  * the dry run at 2 ranks, at 2 x 1 and 1 x 2 (its own checks: within 1e-5
    of Mesh(1, 1), bit for bit against the per-shard batches), its round
    steps and its BoxQP and QCQP scans held to the JAX package's at a (1, 1)
    mesh in the same way (the QCQP pools as sets: two picks that tie within
    the packages' f32 difference may enter in either order);
  * put_global, fetch_tree, gather_cand, the idempotent initialize, the
    rank layout and default_mesh, from one 4-rank process group."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpcutsel_tpu.parallel.mesh import make_mesh as j_make_mesh
from sdpcutsel_tpu.parallel.round import certify_batched_f64 as j_certify
from sdpcutsel_tpu.parallel.round import certify_scan_f64 as j_certify_scan
from sdpcutsel_tpu.parallel.round import init_batched_state as j_init
from sdpcutsel_tpu.parallel.round import make_sharded_round_step as j_step
from sdpcutsel_tpu.parallel.round import make_sharded_scan_step as j_scan
from sdpcutsel_tpu.parallel.sharding import shard_candidates as j_shard
from sdpcutsel_tpu.relax.denserows import batched_dense_from_qcqp as j_batched_dense
from sdpcutsel_tpu_torch.cuts.enumerate import combinations_table
from sdpcutsel_tpu_torch.instances import generate_qcqp_family, generate_spar
from sdpcutsel_tpu_torch.multichip_dryrun import dryrun_multichip
from sdpcutsel_tpu_torch.parallel import distributed
from sdpcutsel_tpu_torch.parallel import round as R
from sdpcutsel_tpu_torch.parallel.mesh import Mesh, default_mesh, make_mesh
from sdpcutsel_tpu_torch.parallel.sharding import shard_candidates
from sdpcutsel_tpu_torch.qcqp.chordal import chordal_decomposition, clique_candidates

TIMEOUT = 120

_UNIT = r"""
import argparse, json
import numpy as np, torch, torch.distributed as tdist
from sdpcutsel_tpu_torch.parallel import distributed as D
from sdpcutsel_tpu_torch.parallel.mesh import default_mesh, make_mesh
from sdpcutsel_tpu_torch.parallel.sharding import gather_cand
ap = argparse.ArgumentParser()
for a in ("--coordinator", "--num-processes", "--process-id"):
    ap.add_argument(a)
a = ap.parse_args()
torch.set_num_threads(1)
dev = D.initialize(a.coordinator, int(a.num_processes), int(a.process_id), device="cpu")
rep = {"rank": tdist.get_rank(), "device": str(dev), "backend": tdist.get_backend(),
       "local": D.local_layout(tdist.get_rank()),
       "again": str(D.initialize("file:///absent", 99, 7, "nccl"))}
mesh = make_mesh(2, 2)
rep["layout"] = [mesh.data_index, mesh.cand_index, tdist.get_process_group_ranks(mesh.group)]
try:
    make_mesh(3, 1)
    rep["bad_shape"] = "accepted"
except ValueError as e:
    rep["bad_shape"] = str(e)
dm = default_mesh()
rep["default"] = [dm.data, dm.cand, dm.cand_index, tdist.get_process_group_ranks(dm.group)]
arr = np.arange(24).reshape(8, 3)
rep["put"] = {ax: D.put_global(arr, mesh, ax).tolist() for ax in ("data", "cand")}
rep["put_none"] = D.put_global(arr, mesh, None).tolist()
local = D.put_global_tree({"a": arr, "b": (arr[:, 0],), "g": torch.Generator()}, mesh, "data")
full = D.fetch_tree(local, mesh)
rep["fetch"] = [full["a"].tolist(), full["b"][0].tolist(), full["g"]]
rep["fetch_axis1"] = D.fetch_tree(local["a"].T.contiguous(), mesh, axis=1).tolist()
rep["gather"] = gather_cand([torch.full((1, 2), tdist.get_rank())], 1, mesh).tolist()
D.sync("unit")
print(json.dumps(rep), flush=True)
tdist.destroy_process_group()
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The in-process comparisons run with one torch thread, as the ranks."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def unit_reports():
    """One 4-rank process group running the unit checks; each rank's report."""
    outs = distributed.spawn(["-c", _UNIT], 4, TIMEOUT)
    return [json.loads(out.strip().splitlines()[-1]) for out in outs]


def test_initialize_is_idempotent(unit_reports):
    for rep in unit_reports:
        assert rep["device"] == "cpu" and rep["backend"] == "gloo"
        assert rep["again"] == "cpu"      # the second call joined nothing new


def test_rank_layout_is_data_major(unit_reports):
    for r, rep in enumerate(unit_reports):
        d, c = divmod(r, 2)
        assert rep["layout"] == [d, c, [2 * d, 2 * d + 1]]
        assert "needs 3 ranks" in rep["bad_shape"]


def test_default_mesh_puts_every_rank_on_cand(unit_reports):
    for r, rep in enumerate(unit_reports):
        assert rep["default"] == [1, 4, r, [0, 1, 2, 3]]
    assert default_mesh() == Mesh(1, 1)        # no process group here


def test_put_global_slices(unit_reports):
    arr = np.arange(24).reshape(8, 3)
    for r, rep in enumerate(unit_reports):
        d, c = divmod(r, 2)
        assert rep["put"]["data"] == arr[4 * d:4 * d + 4].tolist()
        assert rep["put"]["cand"] == arr[4 * c:4 * c + 4].tolist()
        assert rep["put_none"] == arr.tolist()


def test_fetch_tree_gathers_data_shards_in_order(unit_reports):
    arr = np.arange(24).reshape(8, 3)
    for rep in unit_reports:
        assert rep["fetch"] == [arr.tolist(), arr[:, 0].tolist(), None]
        assert rep["fetch_axis1"] == arr.T.tolist()


def test_gather_cand_over_the_cand_group(unit_reports):
    for r, rep in enumerate(unit_reports):
        d = r // 2
        assert rep["gather"] == [[2 * d, 2 * d, 2 * d + 1, 2 * d + 1]]


def test_spawn_tells_its_ranks_they_share_the_host(unit_reports, monkeypatch):
    for r, rep in enumerate(unit_reports):
        assert rep["local"] == [r, 4]
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert distributed.local_layout(3) == (3, 1)     # by hand: alone on its host
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert distributed.local_layout(3) == (1, 2)


def test_backend_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert distributed.choose_backend(torch.device("cuda", 0), 1) == "nccl"
    assert distributed.choose_backend(torch.device("cuda", 0), 2) == "gloo"   # a shared card
    assert distributed.choose_backend(torch.device("cpu"), 1) == "gloo"
    assert make_mesh(2, 3) == Mesh(2, 3)       # no process group: a logical mesh


def _spar_batch(n, b):
    insts = [generate_spar(n, 100, s + 1) for s in range(b)]
    return (jnp.asarray(np.stack([i.Q for i in insts]), jnp.float32),
            jnp.asarray(np.stack([i.c for i in insts]), jnp.float32))


def _pools(got_idx, got_count, want_idx, want_count, as_sets=False):
    np.testing.assert_array_equal(got_count, np.asarray(want_count))
    if not as_sets:
        np.testing.assert_array_equal(got_idx, np.asarray(want_idx))
        return
    for got, want in zip(got_idx, np.asarray(want_idx)):
        assert sorted(map(tuple, got)) == sorted(map(tuple, want))


def test_run_multihost_matches_per_shard_batches(tmp_path):
    save = tmp_path / "mh.npz"
    outs = distributed.spawn(
        ["-m", "sdpcutsel_tpu_torch.run_multihost", "--cpu", "--data", "2", "--cand", "2",
         "--n", "10", "--batch", "4", "--rounds", "1", "--lp-iters", "200",
         "--strategy", "feasibility", "--save", str(save)], 4, TIMEOUT)
    result = [json.loads(line) for line in outs[0].splitlines() if line.startswith("{")][-1]
    assert result["mesh"] == "2x2" and result["processes"] == 4
    assert result["backend"] == "gloo" and result["device"] == "cpu"
    assert len(result["bounds_certified_f64"]) == 4
    assert np.isfinite(result["bounds_certified_f64"]).all()
    for r, out in enumerate(outs):
        assert f"[launches rank {r}] " in out
    got = np.load(save)
    # the JAX package's batched round on the same batch, as scripts/run_multihost.py runs it
    mesh = j_make_mesh(data=1, cand=1)
    table, valid = j_shard(combinations_table(10, 3), mesh)
    ref, _ = j_step(mesh, lp_iters=200, sel_size=4, strategy="feasibility", use_fused=False)(
        j_init(*_spar_batch(10, 4), capacity=128, kmax=3), table, valid)
    _pools(got["idx"], got["count"], ref.pool.idx, ref.pool.count)
    np.testing.assert_allclose(got["cert"], j_certify(ref), rtol=2e-3)
    assert (got["count"] > 0).all()
    insts = [generate_spar(10, 100, s + 1) for s in range(4)]
    start = R.init_batched_state(np.stack([i.Q for i in insts]), np.stack([i.c for i in insts]),
                                 128, 3, device="cpu")
    logical = Mesh(1, 2)
    table, valid = shard_candidates(combinations_table(10, 3), logical, device="cpu")
    step = R.make_sharded_round_step(logical, lp_iters=200, sel_size=4, strategy="feasibility")
    for d in range(2):
        st, info = step(R.instances_of(start, 2 * d, 2 * d + 2), table, valid)
        part = slice(2 * d, 2 * d + 2)
        np.testing.assert_array_equal(st.pool.idx.numpy(), got["idx"][part])
        np.testing.assert_array_equal(st.pool.count.numpy(), got["count"][part])
        np.testing.assert_array_equal(st.best_bound.numpy(), got["best_bound"][part])
        np.testing.assert_array_equal(R.certify_batched_f64(st), got["cert"][part])
        np.testing.assert_array_equal(info["lp_iters"], got["lp_iters"][part])


def _jax_dryrun(B):
    """The dry run's round steps and scans on the JAX package at a (1, 1)
    mesh (__graft_entry__.py::dryrun_multichip's settings): the steps'
    (pool idx, count, certificates), each scan's (certificates (2, B),
    final pool idx, count)."""
    mesh = j_make_mesh(data=1, cand=1)
    Qb, cb = _spar_batch(12, B)
    table, valid = j_shard(combinations_table(12, 3), mesh)
    knobs = dict(lp_iters=300, sel_size=4, strategy="neural")
    step = j_step(mesh, **knobs)
    st = j_init(Qb, cb, capacity=64, kmax=3)
    for _ in range(2):
        st, _ = step(st, table, valid)
    steps = (st.pool.idx, st.pool.count, j_certify(st))
    st, outs = j_scan(mesh, rounds=2, **knobs)(j_init(Qb, cb, capacity=64, kmax=3), table, valid)
    box = (j_certify_scan(st.Q, st.c, outs), st.pool.idx, st.pool.count)
    fam = generate_qcqp_family(12, 30, 2, 1, B)
    cliques, _ = chordal_decomposition(12, fam[0].sparsity_graph())
    qtable, qvalid = j_shard(clique_candidates(cliques, 4), mesh)
    dense = j_batched_dense(fam)
    st = j_init(jnp.asarray(np.stack([i.Q0 for i in fam]), jnp.float32),
                jnp.asarray(np.stack([i.c0 for i in fam]), jnp.float32),
                capacity=64, kmax=4, m_dense=2)
    st, outs = j_scan(mesh, rounds=2, kmax=4, m_dense=2, **knobs)(st, qtable, qvalid, dense)
    return steps, box, (j_certify_scan(st.Q, st.c, outs, dense=dense), st.pool.idx,
                        st.pool.count)


@pytest.mark.parametrize("data", [2, 1], ids=["2x1", "1x2"])
def test_dryrun_two_ranks(data, tmp_path):
    save = str(tmp_path / "dry.npz")
    outs = dryrun_multichip(2, data, device="cpu", timeout=TIMEOUT, save=save)
    line = [ln for ln in outs[0].splitlines() if ln.startswith("dryrun_multichip ok")]
    assert line, outs[0][-3000:]
    for r, out in enumerate(outs):
        assert f"[launches rank {r}] " in out
    assert f"mesh=({data}x{2 // data})" in line[0]
    assert "bit_equal_to_per_shard_batches=True" in line[0]
    got = np.load(save)
    steps, box, qcqp = _jax_dryrun(2 * data)
    _pools(got["idx"], got["count"], *steps[:2])
    np.testing.assert_allclose(got["cert"], steps[2], rtol=2e-3)
    for key, (cert, idx, count), as_sets in (("boxqp", box, False), ("qcqp", qcqp, True)):
        _pools(got[f"{key}_idx"], got[f"{key}_count"], idx, count, as_sets)
        np.testing.assert_allclose(got[f"{key}_cert"], cert, rtol=2e-3)
