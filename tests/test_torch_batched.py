"""Port parity of the instance-batched BoxQP round
(sdpcutsel_tpu_torch.parallel.round) against sdpcutsel_tpu.parallel.round on
the CPU, n = 12, B = 3, lp_iters 300: after one and three rounds the pools
are equal and the f64 certificates agree at rtol 2e-3, the on-device f32
bound within 1e-2 of the f64 one (tests/test_round_sharded.py's
tolerances).  Also the port's own invariants: layout invariance over cand,
scan = per-round bit for bit, a batch = its instances run one by one,
random by its properties, the pair layout against the generic table,
diverse selection, and the batched PDHG block's twin freezing an instance."""

import dataclasses

import jax
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
from sdpcutsel_tpu_torch.config import CutConfig, LPConfig, RunConfig
from sdpcutsel_tpu_torch.cuts.enumerate import combinations_table
from sdpcutsel_tpu_torch.instances import generate_spar
from sdpcutsel_tpu_torch.lp import pdhg
from sdpcutsel_tpu_torch.lp.pdhg_kernel import pdhg_block_batched, pdhg_block_plain
from sdpcutsel_tpu_torch.parallel import make_mesh, shard_candidates, shard_pair_candidates
from sdpcutsel_tpu_torch.parallel import round as R
from sdpcutsel_tpu_torch.relax import batched as rb

N, B, CAP, ITERS, SEL = 12, 3, 64, 300, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's CPU threads share this process; torch's intra-op pool on top of
    them oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(n=N, b=B):
    insts = [generate_spar(n, 100, s + 1) for s in range(b)]
    return (np.stack([i.Q for i in insts]).astype(np.float32),
            np.stack([i.c for i in insts]).astype(np.float32))


def _port_run(strategy="neural", rounds=3, cand=1, Qc=None, cfg=None, seed=0, **kw):
    """The port's per-round run; returns the states after each round."""
    Qb, cb = Qc if Qc is not None else _batch()
    mesh = make_mesh(1, cand)
    state = R.init_batched_state(Qb, cb, CAP, 3, seed=seed, device="cpu")
    table, valid = kw.pop("tables", None) or shard_candidates(
        combinations_table(Qb.shape[1], 3), mesh, device="cpu")
    step = R.make_sharded_round_step(mesh, cfg, lp_iters=ITERS, sel_size=SEL,
                                     strategy=strategy, **kw)
    out = []
    for _ in range(rounds):
        state, _ = step(state, table, valid)
        out.append(state)
    return out


_REF = {}


def _reference(strategy):
    """The reference's 3 rounds on a (1, 1) mesh: per round (pool idx, pool
    count, f64 certificates, f32 best bound), and round 0's state as numpy."""
    if strategy not in _REF:
        Qb, cb = _batch()
        mesh = j_make_mesh(data=1, cand=1)
        state = j_init(jnp.asarray(Qb), jnp.asarray(cb), capacity=CAP, kmax=3)
        table, valid = j_shard(combinations_table(N, 3), mesh)
        step = j_step(mesh, lp_iters=ITERS, sel_size=SEL, strategy=strategy)
        rounds, first = [], None
        for r in range(3):
            state, _ = step(state, table, valid)
            if r == 0:
                first = jax.tree.map(np.asarray, state)
            rounds.append((np.asarray(state.pool.idx), np.asarray(state.pool.count),
                           j_certify(state), np.asarray(state.best_bound)))
        _REF[strategy] = (rounds, first)
    return _REF[strategy]


_PORT = {}


def _port(strategy):
    if strategy not in _PORT:
        _PORT[strategy] = _port_run(strategy)
    return _PORT[strategy]


@pytest.mark.parametrize("rounds", [1, 3])
@pytest.mark.parametrize("strategy", ["neural", "feasibility", "combined"])
def test_batched_rounds_match_reference(strategy, rounds):
    ref = _reference(strategy)[0][rounds - 1]
    st = _port(strategy)[rounds - 1]
    np.testing.assert_array_equal(st.pool.count.numpy(), ref[1])
    np.testing.assert_array_equal(st.pool.idx.numpy(), ref[0])
    cert = R.certify_batched_f64(st)
    np.testing.assert_allclose(cert, ref[2], rtol=2e-3)
    assert (np.abs(st.best_bound.numpy() - cert) <= 1e-2 * (1 + np.abs(cert))).all()
    assert st.pool.count.min() > 0


def test_round_from_the_references_state():
    """batched_state_from_numpy: the port continues the reference's round 0
    into round 1 as the reference does."""
    (rounds, first) = _reference("neural")
    state = R.batched_state_from_numpy(first, device="cpu")
    mesh = make_mesh(1, 1)
    table, valid = shard_candidates(combinations_table(N, 3), mesh, device="cpu")
    step = R.make_sharded_round_step(mesh, lp_iters=ITERS, sel_size=SEL)
    state, _ = step(state, table, valid)
    np.testing.assert_array_equal(state.pool.idx.numpy(), rounds[1][0])
    np.testing.assert_allclose(R.certify_batched_f64(state), rounds[1][2], rtol=2e-3)


@pytest.mark.parametrize("cand", [2, 4, 8])
def test_layout_invariance_over_cand(cand):
    one, many = _port("neural")[-1], _port_run("neural", cand=cand)[-1]
    assert torch.equal(many.pool.idx, one.pool.idx)
    assert torch.equal(many.pool.count, one.pool.count)
    np.testing.assert_allclose(many.best_bound.numpy(), one.best_bound.numpy(), rtol=2e-5)


def test_scan_equals_per_round_and_certifies_as_the_reference():
    Qb, cb = _batch()
    mesh = make_mesh(1, 2)
    table, valid = shard_candidates(combinations_table(N, 3), mesh, device="cpu")
    per = _port_run("neural", cand=2)
    start = R.init_batched_state(Qb, cb, CAP, 3, device="cpu")
    scan = R.make_sharded_scan_step(mesh, rounds=3, lp_iters=ITERS, sel_size=SEL)
    final, outs = scan(start, table, valid)
    for f in dataclasses.fields(final.pool):
        assert torch.equal(getattr(final.pool, f.name), getattr(per[-1].pool, f.name))
    for a, b in zip(final.pdhg.fields(), per[-1].pdhg.fields()):
        assert torch.equal(a, b)
    assert torch.equal(final.best_bound, per[-1].best_bound)
    for r in (1, 2):    # round r was solved on the pool round r - 1 left
        assert torch.equal(outs["pool"].idx[r], per[r - 1].pool.idx)
    assert torch.equal(outs["count"][-1], final.pool.count)
    bounds = R.certify_scan_f64(final.Q, final.c, outs)
    assert bounds.shape == (3, B) and np.isfinite(bounds).all()
    assert (np.diff(bounds, axis=0) <= 0).all()
    # the reference's certificate of the same numpy outs
    np_outs = {k: v.numpy() for k, v in outs.items() if k != "pool"}
    np_outs["pool"] = JCutPool(**{f.name: getattr(outs["pool"], f.name).numpy()
                                  for f in dataclasses.fields(outs["pool"])})
    np.testing.assert_array_equal(bounds, j_certify_scan(Qb, cb, np_outs))


def test_batch_equals_its_instances_run_alone():
    Qb, cb = _batch()
    batch = _port("neural")[-1]
    cert = R.certify_batched_f64(batch)
    for b in range(B):
        alone = _port_run("neural", Qc=(Qb[b:b + 1], cb[b:b + 1]))[-1]
        assert torch.equal(alone.pool.idx[0], batch.pool.idx[b])
        np.testing.assert_allclose(R.certify_batched_f64(alone)[0], cert[b], rtol=2e-3)


def test_random_properties():
    """random draws from each instance's own CPU generator (not jax.random's
    stream): finite certificates, monotone best bounds, one seed repeats."""
    first = _port_run("random", seed=1)
    again = _port_run("random", seed=1)
    other = _port_run("random", seed=2)[-1]
    certs = np.stack([R.certify_batched_f64(s) for s in first])
    assert np.isfinite(certs).all()
    best = np.stack([s.best_bound.numpy() for s in first])
    assert (np.diff(best, axis=0) <= 0).all()
    assert all(torch.equal(a.pool.idx, b.pool.idx) for a, b in zip(first, again))
    assert not torch.equal(first[-1].pool.idx, other.pool.idx)
    assert first[-1].pool.count.min() > 0


def test_pair_layout_matches_generic_table():
    mesh = make_mesh(1, 4)
    tables = shard_pair_candidates(N, mesh, block=128, device="cpu")
    pair = _port_run("neural", cand=4, tables=tables, pair_layout=True)[-1]
    generic = _port("neural")[-1]
    np.testing.assert_allclose(R.certify_batched_f64(pair), R.certify_batched_f64(generic),
                               rtol=2e-3, atol=2e-3)
    with pytest.raises(ValueError):
        R.make_sharded_round_step(mesh, strategy="random", pair_layout=True)


def test_diverse_selection():
    """Untied scores: the diverse merge picks what top-k picks; the merge is
    layout invariant; the reference's default alpha is the one tested
    against it above."""
    def cfg(alpha):
        return RunConfig(cuts=CutConfig(sel_size=6, capacity=CAP, diversity_alpha=alpha))

    div = _port_run("feasibility", rounds=2, cand=4, cfg=cfg(1e-4))[-1]
    plain = _port_run("feasibility", rounds=2, cand=4, cfg=cfg(0.0))[-1]
    div8 = _port_run("feasibility", rounds=2, cand=8, cfg=cfg(1e-4))[-1]
    assert (div.best_bound <= div.bound + 1e-5).all() and (div.pool.count > 0).all()
    assert torch.equal(div.pool.idx, plain.pool.idx)
    assert torch.equal(div.pool.idx, div8.pool.idx)


def test_batched_block_twin_freezes_the_instances_left_out():
    state = _port("neural")[0]
    P = state.pool
    n = N
    index = rb.build_cut_index(P, n)
    st, acc = state.pdhg, state.pdhg.map(torch.zeros_like)
    cx, cX = -state.c, -0.5 * state.Q
    tau = np.array([0.01, 0.02, 0.03], np.float32)
    got_st, got_acc = pdhg_block_batched(cx, cX, P, index, st, acc, tau, 2 * tau, 7, [0, 2])
    for b in (0, 2):
        want = pdhg_block_plain(cx[b], cX[b], rb.instance(P, b), rb.instance(index, b),
                                rb.instance(st, b), rb.instance(acc, b), float(tau[b]),
                                float(2 * tau[b]), 7)
        for g, w in zip([*got_st.fields(), *got_acc.fields()],
                        [*want[0].fields(), *want[1].fields()]):
            assert torch.equal(g[b], w)
    for g, w in zip([*got_st.fields(), *got_acc.fields()], [*st.fields(), *acc.fields()]):
        assert torch.equal(g[1], w[1])


def test_batched_solve_matches_single_solves():
    """Each instance of a batched solve stops where its own solve stops."""
    state = _port("neural")[0]
    cfg = LPConfig(max_iters=1500, tol=1e-4)
    setup = pdhg.solve_setup_batched(state.c, state.pool, cfg)
    st, info = pdhg._solve_batched(-state.c, -0.5 * state.Q, state.pool, setup.index,
                                   state.pdhg, setup.normK, cfg.omega0, cfg.tol,
                                   cfg.step_scale, cfg.max_iters, cfg.check_every,
                                   cfg.restart_period)
    for b in range(B):
        one, one_info = pdhg.solve_lp(state.Q[b], state.c[b], rb.instance(state.pool, b),
                                      rb.instance(state.pdhg, b), cfg)
        assert one_info["iters"] == info["iters"][b]
        np.testing.assert_allclose(info["kkt_error"][b], one_info["kkt_error"], rtol=1e-3)
        np.testing.assert_allclose(st.X[b].numpy(), one.X.numpy(), atol=1e-4)


def test_use_fused_false_scores_with_the_twins():
    """use_fused=False asks for the scoring twins: on the CPU, where the
    wrappers take them anyway, the same bits, and nothing counted (the
    counters count twin calls on CUDA tensors only)."""
    from sdpcutsel_tpu_torch.ops.pair_score import pair_score

    before = pair_score.plain_launches
    twin = _port_run("neural", rounds=1, use_fused=False)[-1]
    default = _port("neural")[0]
    assert torch.equal(twin.pool.idx, default.pool.idx)
    assert torch.equal(twin.best_bound, default.best_bound)
    assert pair_score.plain_launches == before


def test_bucket_instances_and_batched_state_layout():
    from sdpcutsel_tpu.parallel.round import bucket_instances as j_bucket

    insts = [generate_spar(n, d, 1) for n in (14, 12, 14, 13) for d in (50, 100)]
    got, want = R.bucket_instances(insts), j_bucket(insts)
    assert list(got) == list(want) == [12, 13, 14]
    assert all([i.name for i in got[n]] == [i.name for i in want[n]] for n in got)
    state = R.init_batched_state(*_batch(), CAP, 3, device="cpu")
    assert R.shard_batched_state(state, make_mesh(3, 1)) is state
    with pytest.raises(ValueError):
        R.shard_batched_state(state, make_mesh(2, 1))
