"""Port parity of the instance-batched QCQP round (scripts/bench_batched.py
--qcqp's configuration at n = 12: generate_qcqp_family, the chordal clique
table at k = 4, the constraints as a batched dense block) against
sdpcutsel_tpu.parallel.round on the CPU: the same cuts in every pool and f64
certificates within rtol 2e-3 (tests/test_round_sharded.py's tolerance) for
2 rounds;
the batched dense block; the scan and its certificate with dense rows; the
batched PDHG block's twin with dense rows and a frozen instance."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpcutsel_tpu.parallel.mesh import make_mesh as j_make_mesh
from sdpcutsel_tpu.parallel.round import certify_batched_f64 as j_certify
from sdpcutsel_tpu.parallel.round import certify_scan_f64 as j_certify_scan
from sdpcutsel_tpu.parallel.round import init_batched_state as j_init
from sdpcutsel_tpu.parallel.round import make_sharded_round_step as j_step
from sdpcutsel_tpu.parallel.sharding import shard_candidates as j_shard
from sdpcutsel_tpu.relax.cutbuffer import CutPool as JCutPool
from sdpcutsel_tpu.relax.denserows import DenseRows as JDenseRows
from sdpcutsel_tpu.relax.denserows import batched_dense_from_qcqp as j_batched_dense
from sdpcutsel_tpu_torch.instances import generate_qcqp_family
from sdpcutsel_tpu_torch.instances.qcqp import generate_qcqp
from sdpcutsel_tpu_torch.lp.pdhg_kernel import pdhg_block_batched, pdhg_block_plain
from sdpcutsel_tpu_torch.parallel import make_mesh, shard_candidates
from sdpcutsel_tpu_torch.parallel import round as R
from sdpcutsel_tpu_torch.qcqp.chordal import chordal_decomposition, clique_candidates
from sdpcutsel_tpu_torch.relax import batched as rb
from sdpcutsel_tpu_torch.relax.denserows import batched_dense_from_qcqp

N, M_DENSE, B, K, CAP, ITERS, SEL = 12, 2, 3, 4, 64, 300, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _family():
    fam = generate_qcqp_family(N, 30, M_DENSE, 1, B)
    cliques, _ = chordal_decomposition(N, fam[0].sparsity_graph())
    table = clique_candidates(cliques, K)
    return (fam, table, np.stack([i.Q0 for i in fam]).astype(np.float32),
            np.stack([i.c0 for i in fam]).astype(np.float32))


def _port_steps(strategy, rounds, scan=False):
    fam, table_np, Qb, cb = _family()
    mesh = make_mesh(1, 2)
    dense = batched_dense_from_qcqp(fam, "cpu")
    state = R.init_batched_state(Qb, cb, CAP, K, m_dense=M_DENSE, device="cpu")
    table, valid = shard_candidates(table_np, mesh, device="cpu")
    knobs = dict(lp_iters=ITERS, sel_size=SEL, strategy=strategy, kmax=K, m_dense=M_DENSE)
    if scan:
        return R.make_sharded_scan_step(mesh, rounds=rounds, **knobs)(state, table, valid,
                                                                       dense), dense
    step = R.make_sharded_round_step(mesh, **knobs)
    out = []
    for _ in range(rounds):
        state, _ = step(state, table, valid, dense)
        out.append(state)
    return out, dense


def test_batched_dense_matches_reference():
    fam = generate_qcqp_family(N, 30, M_DENSE, 1, B)
    mixed = [generate_qcqp(N, 30, 2, 1), generate_qcqp(N, 30, 3, 2),
             generate_qcqp(N, 30, 0, 3)]
    for insts in (fam, mixed):
        got, want = batched_dense_from_qcqp(insts, "cpu"), j_batched_dense(insts)
        for f in ("G", "g", "h"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert (batched_dense_from_qcqp(mixed, "cpu").h[2] == 0).all()


@pytest.mark.parametrize("strategy", ["neural", "feasibility"])
def test_qcqp_family_rounds_match_reference(strategy):
    fam, table_np, Qb, cb = _family()
    mesh = j_make_mesh(data=1, cand=2)
    dense = j_batched_dense(fam)
    state = j_init(jnp.asarray(Qb), jnp.asarray(cb), capacity=CAP, kmax=K, m_dense=M_DENSE)
    table, valid = j_shard(table_np, mesh)
    step = j_step(mesh, lp_iters=ITERS, sel_size=SEL, strategy=strategy, kmax=K,
                  m_dense=M_DENSE)
    ours, tdense = _port_steps(strategy, 2)
    for r in range(2):
        state, _ = step(state, table, valid, dense)
        st = ours[r]
        np.testing.assert_array_equal(st.pool.count.numpy(), np.asarray(state.pool.count))
        # the same cuts; two picks whose feasibility scores tie within the
        # packages' f32 difference may enter in either order
        for got, want in zip(st.pool.idx.numpy(), np.asarray(state.pool.idx)):
            assert sorted(map(tuple, got)) == sorted(map(tuple, want))
        np.testing.assert_allclose(R.certify_batched_f64(st, tdense), j_certify(state, dense),
                                   rtol=2e-3)
    assert ours[-1].pool.count.min() > 0


def test_qcqp_scan_equals_per_round_and_certifies_as_the_reference():
    per, _ = _port_steps("neural", 2)
    (final, outs), dense = _port_steps("neural", 2, scan=True)
    for f in dataclasses.fields(final.pool):
        assert torch.equal(getattr(final.pool, f.name), getattr(per[-1].pool, f.name))
    for a, b in zip(final.pdhg.fields(), per[-1].pdhg.fields()):
        assert torch.equal(a, b)
    bounds = R.certify_scan_f64(final.Q, final.c, outs, dense)
    np_outs = {k: v.numpy() for k, v in outs.items() if k != "pool"}
    np_outs["pool"] = JCutPool(**{f.name: getattr(outs["pool"], f.name).numpy()
                                  for f in dataclasses.fields(outs["pool"])})
    jd = JDenseRows(*(t.numpy() for t in (dense.G, dense.g, dense.h)))
    np.testing.assert_array_equal(bounds, j_certify_scan(final.Q.numpy(), final.c.numpy(),
                                                         np_outs, dense=jd))
    assert (bounds[-1] < bounds[0]).all()         # the cuts tighten every bound


def test_inert_dense_rows_change_nothing():
    """m_dense rows of zeros (no dense block given) bind nowhere: the BoxQP
    batch picks the same cuts with and without them."""
    from sdpcutsel_tpu_torch.cuts.enumerate import combinations_table
    from sdpcutsel_tpu_torch.instances import generate_spar

    insts = [generate_spar(N, 100, s + 1) for s in range(2)]
    Qb, cb = np.stack([i.Q for i in insts]), np.stack([i.c for i in insts])
    mesh = make_mesh(1, 1)
    table, valid = shard_candidates(combinations_table(N, 3), mesh, device="cpu")
    runs = []
    for m in (0, M_DENSE):
        state = R.init_batched_state(Qb, cb, CAP, 3, m_dense=m, device="cpu")
        step = R.make_sharded_round_step(mesh, lp_iters=ITERS, sel_size=SEL, m_dense=m)
        for _ in range(2):
            state, _ = step(state, table, valid)
        runs.append(state)
    assert torch.equal(runs[0].pool.idx, runs[1].pool.idx)
    np.testing.assert_allclose(R.certify_batched_f64(runs[1]), R.certify_batched_f64(runs[0]),
                               rtol=2e-3)


def test_batched_block_twin_with_dense_rows():
    per, dense = _port_steps("neural", 1)
    state = per[0]
    P = state.pool
    index = rb.build_cut_index(P, N)
    st, acc = state.pdhg, state.pdhg.map(torch.zeros_like)
    cx, cX = -state.c, -0.5 * state.Q
    tau = np.array([0.01, 0.02, 0.03], np.float32)
    got = pdhg_block_batched(cx, cX, P, index, st, acc, tau, tau, 7, [1, 2], dense)
    for b in (1, 2):
        want = pdhg_block_plain(cx[b], cX[b], rb.instance(P, b), rb.instance(index, b),
                                rb.instance(st, b), rb.instance(acc, b), float(tau[b]),
                                float(tau[b]), 7, rb.instance(dense, b))
        for g, w in zip([*got[0].fields(), *got[1].fields()],
                        [*want[0].fields(), *want[1].fields()]):
            assert torch.equal(g[b], w)
    for g, w in zip([*got[0].fields(), *got[1].fields()], [*st.fields(), *acc.fields()]):
        assert torch.equal(g[0], w[0])
    assert got[0].yD.shape == (B, M_DENSE) and not torch.equal(got[0].yD[1], st.yD[1])
