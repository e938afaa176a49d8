"""Port parity of the LP solve's control (lp/pdhg.py, lp/pdhg_check.py,
lp/pdhg_norm.py): the checked block's twin (what K5 computes) against the
JAX package's ``_kkt_error``, ``_dist2`` and omega update, the solve's first
checked blocks against the JAX ``_solve_impl``, the grouped loop against a
loop that reads after every block, and the power iteration's twin (what K6
computes) against the body it replaced and the reference.  Seeded numpy
inputs at small n, torch on one thread."""

import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpcutsel_tpu.lp import pdhg as jpdhg
from sdpcutsel_tpu.relax import cutbuffer as jcb
from sdpcutsel_tpu.relax import denserows as jdr
from sdpcutsel_tpu_torch.instances import generate_spar
from sdpcutsel_tpu_torch.instances.qcqp import generate_qcqp
from sdpcutsel_tpu_torch.lp import pdhg as tpdhg
from sdpcutsel_tpu_torch.lp.pdhg import (REC_D, REC_DD, REC_DP, REC_ERR, REC_IT, REC_OMEGA,
                                         REC_P, REC_RESTART, REC_SIGMA, REC_STOP, REC_TAU,
                                         REC_USE_AVG, REC_WLEN, record_floats)
from sdpcutsel_tpu_torch.lp.pdhg_check import pdhg_block_checked, pdhg_block_checked_batched
from sdpcutsel_tpu_torch.lp.pdhg_kernel import (pdhg_block_steps, pdhg_block_steps_batched,
                                                pdhg_block_steps_plain)
from sdpcutsel_tpu_torch.lp.pdhg_norm import pdhg_norm, pdhg_norm_batched
from sdpcutsel_tpu_torch.relax import batched as rb
from sdpcutsel_tpu_torch.relax import cutbuffer as tcb
from sdpcutsel_tpu_torch.relax import denserows as tdr
from sdpcutsel_tpu_torch.relax.cutbuffer import build_cut_index
from sdpcutsel_tpu_torch.relax.mccormick import apply_K, apply_KT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("x", "X", "yA", "yB", "yC", "yD")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's CPU threads share this process; torch's intra-op pool on top of
    them oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(kind: str, seed: int = 0, M: int = 40):
    """A small BoxQP (m = 0) or QCQP (the dense rows of generate_qcqp(12, 40,
    3, 2), or of generate_qcqp(12, 40, 25, 2) for "qcqp25") with a random pool and three random points (state, sums of a
    window of 300 iterates, anchor), in both packages."""
    rng = np.random.default_rng(seed)
    if kind in ("qcqp", "qcqp25"):
        inst = generate_qcqp(12, 40, 3 if kind == "qcqp" else 25, 2)
        n, m, k, Q, c = inst.n, inst.m, 4, inst.Q0, inst.c0
        jd = jdr.dense_from_qcqp(inst.Qs, inst.cs, inst.bs)
        td = tdr.dense_from_qcqp(inst.Qs, inst.cs, inst.bs, "cpu")
    else:
        inst = generate_spar(13, 100, 2)
        n, m, k, Q, c = inst.n, 0, 3, inst.Q, inst.c
        jd, td = jdr.empty_dense(n, jnp.float32), None
    live = M - 8
    idx = rng.integers(0, n, (live, k)).astype(np.int32)
    lin = rng.standard_normal((live, k)).astype(np.float32)
    quad = rng.standard_normal((live, k, k)).astype(np.float32)
    quad = 0.5 * (quad + np.transpose(quad, (0, 2, 1)))
    rhs = (0.1 * rng.standard_normal(live)).astype(np.float32)
    cuts = (idx, lin, quad, rhs, np.ones(live, np.float32))
    jpool = jcb.append_cuts(jcb.empty_pool(M, k), *(jnp.asarray(a) for a in cuts))
    tpool = tcb.append_cuts(tcb.empty_pool(M, k, "cpu"), *(torch.as_tensor(a) for a in cuts))
    act = np.asarray(jpool.active)

    def point(scale):
        X = rng.random((n, n))
        p = dict(x=rng.random(n), X=0.5 * (X + X.T), yA=0.1 * rng.random((n, n)),
                 yB=0.1 * rng.random((n, n)), yC=0.05 * rng.random(M) * act,
                 yD=0.2 * rng.random(m))
        return {f: (scale * a).astype(np.float32) for f, a in p.items()}

    pts = [point(1.0), point(300.0), point(1.0)]
    Q32, c32 = Q.astype(np.float32), c.astype(np.float32)
    jax_side = (jnp.asarray(-c32), jnp.asarray(-0.5 * Q32), jpool, jd,
                [jpdhg.PDHGState(**{f: jnp.asarray(a) for f, a in p.items()}) for p in pts])
    torch_side = (torch.as_tensor(-c32), torch.as_tensor(-0.5 * Q32), tpool, td,
                  [tpdhg.PDHGState(**{f: torch.as_tensor(a) for f, a in p.items()})
                   for p in pts])
    return n, jax_side, torch_side


def _record(normK=7.0, omega0=1.3, max_iters=10 ** 6, tol=1e-9, wlen=200):
    rec = tpdhg.new_record(normK, omega0, 0.95, max_iters, tol, "cpu")
    rec[REC_WLEN] = wlen
    return rec


CHECK_SEEDS = (3, 4)      # seed 3: the iterate wins; seed 4: the average wins


@pytest.mark.parametrize("seed", CHECK_SEEDS)
@pytest.mark.parametrize("restart_period", [10 ** 6, 300])
@pytest.mark.parametrize("kind", ["boxqp", "qcqp"])
def test_check_twin_matches_reference_kkt_restart_and_omega(kind, restart_period, seed):
    """The checked block's twin on (state, sums of 300 iterates, anchor)
    against the reference's _kkt_error of the iterate and of the average,
    its choice, _dist2 and the omega formula (sdpcutsel_tpu/lp/pdhg.py
    checked_block): err, p, d, omega at rtol 1e-5, the same restart
    choice; on a restart the state and anchor are the candidate."""
    n, (jcx, jcX, jpool, jd, (jst, jacc, janc)), (tcx, tcX, tpool, td, (tst, tacc, tanc)) = \
        _case(kind, seed=seed)
    omega0, wlen = np.float32(1.3), 300
    avg = jax.tree.map(lambda u: u * (np.float32(1.0) / np.float32(wlen)), jacc)
    e_c, p_c, d_c = (float(v) for v in jpdhg._kkt_error(jcx, jcX, jpool, jd, jst, n))
    e_a, p_a, d_a = (float(v) for v in jpdhg._kkt_error(jcx, jcX, jpool, jd, avg, n))
    use_avg = e_a < e_c
    cand = avg if use_avg else jst
    restart = use_avg or wlen >= restart_period
    dp = jnp.sqrt(jpdhg._dist2(cand, janc, True)) + 1e-12
    dd = jnp.sqrt(jpdhg._dist2(cand, janc, False)) + 1e-12
    omega = float(jnp.clip(jnp.exp(0.5 * jnp.log(dd / dp) + 0.5 * jnp.log(omega0)), 1e-4, 1e4)
                  ) if restart else float(omega0)

    rec = _record(omega0=omega0, wlen=wlen - 100)
    tpdhg.pdhg_check_plain(tcx, tcX, tpool, build_cut_index(tpool, n), tst, tacc, tanc, rec,
                           100, restart_period, 10 ** 6, 1e-9, td)
    r = rec.numpy()
    f = record_floats(r)
    assert bool(r[REC_RESTART]) == restart and bool(r[REC_USE_AVG]) == use_avg
    want = (e_a, p_a, d_a) if use_avg else (e_c, p_c, d_c)
    np.testing.assert_allclose([f[REC_ERR], f[REC_P], f[REC_D], f[REC_OMEGA]],
                               [*want, omega], rtol=1e-5)
    assert r[REC_IT] == 100 and r[REC_WLEN] == (0 if restart else wlen)
    assert f[REC_TAU] == np.float32(f[tpdhg.REC_ETA] / f[REC_OMEGA])
    assert f[REC_SIGMA] == np.float32(f[tpdhg.REC_ETA] * f[REC_OMEGA])
    if restart:
        np.testing.assert_allclose([f[REC_DP], f[REC_DD]], [float(dp), float(dd)], rtol=1e-5)
        for got_st, got_anc, w in zip(tst.fields(), tanc.fields(), cand):
            np.testing.assert_allclose(got_st.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
            assert torch.equal(got_st, got_anc)
        assert all(float(t.abs().sum()) == 0.0 for t in tacc.fields())


def test_both_restart_choices_are_exercised():
    """The cases above reach all three branches: no restart, a restart by
    the period with the iterate, a restart to the average."""
    seen = set()
    for seed in CHECK_SEEDS:
        for kind in ("boxqp", "qcqp"):
            for rp in (10 ** 6, 300):
                n, _, (tcx, tcX, tpool, td, (tst, tacc, tanc)) = _case(kind, seed=seed)
                rec = _record(wlen=200)
                tpdhg.pdhg_check_plain(tcx, tcX, tpool, build_cut_index(tpool, n), tst, tacc,
                                       tanc, rec, 100, rp, 10 ** 6, 1e-9, td)
                seen.add((int(rec[REC_RESTART]), int(rec[REC_USE_AVG])))
    assert seen == {(0, 0), (1, 0), (1, 1)}


@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("kind", ["boxqp", "qcqp"])
def test_solve_blocks_match_reference(kind, blocks):
    """One and three checked blocks of the port's solve (the twins on the
    CPU, grouped) against the JAX ``_solve_impl`` from the same state at the
    same normK, restart_period 100 so that every block restarts: equal
    iters, the states at rtol/atol 2e-5."""
    n, (jcx, jcX, jpool, jd, (jst, _, _)), (tcx, tcX, tpool, td, (tst, _, _)) = \
        _case(kind, seed=5)
    normK = float(jpdhg.estimate_norm(jpool, n, 30, jnp.float32, jd))
    args = dict(omega0=1.0, tol=1e-12, step_scale=0.95, max_iters=100 * blocks,
                check_every=100, restart_period=100)
    st_j, info_j = jpdhg._solve_impl(
        jcx, jcX, jpool, jd, jst, normK, args["omega0"], args["tol"], 1e-6, args["step_scale"],
        args["max_iters"], args["check_every"], args["restart_period"])
    st_t, info_t = tpdhg._solve_impl(tcx, tcX, tpool, build_cut_index(tpool, n), tst, normK,
                                     **args, dense=td)
    assert info_t["iters"] == int(info_j["iters"]) == 100 * blocks
    np.testing.assert_allclose(info_t["omega"], float(info_j["omega"]), rtol=1e-4)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(st_t, f).numpy(), np.asarray(getattr(st_j, f)),
                                   rtol=2e-5, atol=2e-5)


def _stop_mid_group(solve, group: int = 8):
    """A tol at which ``solve(tol, 1)`` (groups of one block) stops by
    tolerance after its first group of ``group`` and inside a later one (a
    number of blocks that is not a multiple of ``group``), the instances of
    a batch at different blocks; returns (tol, its result)."""
    for tol in (3e-2, 2e-2, 1e-2, 7e-3, 5e-3, 3e-3, 2e-3, 1e-3, 7e-4, 5e-4, 3e-4, 2e-4, 1e-4):
        out = solve(tol, 1)
        blocks = np.atleast_1d(np.asarray(out[1]["iters"]) // 100)
        mid = (blocks % group != 0) & (blocks > group) & (blocks < 30)
        if mid.any() and (blocks.size == 1 or len(set(blocks.tolist())) > 1):
            return tol, out
    raise AssertionError("no tolerance stops the solve inside a later group")


def _same_state(a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a.fields(), b.fields()))


def test_grouped_loop_repeats_the_per_block_loop_single(monkeypatch):
    """Groups of 8 blocks between two reads of the record give the bits of a
    loop that reads after every block, for a solve that stops inside a
    group; the reads are one a group."""
    n, _, (tcx, tcX, tpool, td, (tst, _, _)) = _case("qcqp", seed=7)
    index = build_cut_index(tpool, n)
    normK = tpdhg.estimate_norm_plain(tpool, n, 30, torch.Generator().manual_seed(0), index, td)

    def solve(tol, group):
        monkeypatch.setattr(tpdhg, "GROUP_BLOCKS", group)
        return tpdhg._solve_impl(tcx, tcX, tpool, index, tst, normK, 1.0, tol, 0.95, 3000, 100,
                                 300, td)

    tol, (st1, info1) = _stop_mid_group(solve)
    before = tpdhg.SOLVE_COUNTS["reads"]
    st8, info8 = solve(tol, 8)
    assert tpdhg.SOLVE_COUNTS["reads"] - before == math.ceil(info8["iters"] / 100 / 8)
    assert info1 == info8 and _same_state(st1, st8)
    assert 0 < info8["iters"] < 3000


def test_grouped_loop_repeats_the_per_block_loop_batched(monkeypatch):
    """The batched solve with groups of 8 against groups of 1, bit for bit,
    where the instances stop at different blocks, one inside a group; an
    instance that stopped stays frozen: its state is that of a solve that
    ends at its own iteration count."""
    insts = [generate_spar(13, 100, s + 1) for s in range(3)]
    n, M, k = 13, 40, 3
    pools, states = [], []
    for s, inst in enumerate(insts):
        _, _, (tcx, tcX, tpool, _, (tst, _, _)) = _case("boxqp", seed=20 + s, M=M)
        pools.append(tpool)
        states.append(tst)
    P, st0 = rb.stack(pools), rb.stack(states)
    cx = torch.as_tensor(np.stack([-i.c for i in insts]).astype(np.float32))
    cX = torch.as_tensor(np.stack([-0.5 * i.Q for i in insts]).astype(np.float32))
    index = rb.build_cut_index(P, n)
    normK = tpdhg.estimate_norm_batched_plain(P, n, 30, torch.Generator().manual_seed(0), index)

    def solve(tol, group, max_iters=3000):
        monkeypatch.setattr(tpdhg, "GROUP_BLOCKS", group)
        return tpdhg._solve_batched(cx, cX, P, index, st0, normK, 1.0, tol, 0.95, max_iters,
                                    100, 300)

    tol, (st1, info1) = _stop_mid_group(solve)
    st8, info8 = solve(tol, 8)
    assert _same_state(st1, st8)
    for key in info1:
        assert np.array_equal(info1[key], info8[key]), key
    iters = info8["iters"]
    assert len(set(iters.tolist())) > 1
    b = int(np.argmin(iters))
    short, _ = solve(tol, 8, max_iters=int(iters[b]))
    assert _same_state(rb.instance(short, b), rb.instance(st8, b))


@pytest.mark.parametrize("kind", ["boxqp", "qcqp"])
def test_stopped_record_leaves_everything(kind):
    """A block and a checked block enqueued after the stop do nothing: the
    wrappers on a stopped record leave the state, sums, anchor and record as
    they are, single and batched."""
    n, _, (tcx, tcX, tpool, td, (tst, tacc, tanc)) = _case(kind, seed=9)
    index = build_cut_index(tpool, n)
    rec = _record()
    rec[REC_STOP] = 1
    before = [t.clone() for t in (*tst.fields(), *tacc.fields(), *tanc.fields(), rec)]
    pdhg_block_steps(tcx, tcX, tpool, index, tst, tacc, rec, 100, td)
    pdhg_block_checked(tcx, tcX, tpool, index, tst, tacc, tanc, rec, 100, 300, 10 ** 6, 1e-9,
                       td)
    after = (*tst.fields(), *tacc.fields(), *tanc.fields(), rec)
    assert all(torch.equal(a, b) for a, b in zip(before, after))

    one = lambda o: rb.batch_of_one(o)      # noqa: E731
    bst, bacc, banc, bindex = one(tst), one(tacc), one(tanc), rb.build_cut_index(one(tpool), n)
    brec, bdense = rec[None].clone(), None if td is None else one(td)
    pdhg_block_steps_batched(tcx[None], tcX[None], one(tpool), bindex, bst, bacc, brec, 100,
                             bdense)
    pdhg_block_checked_batched(tcx[None], tcX[None], one(tpool), bindex, bst, bacc, banc, brec,
                               100, 300, 10 ** 6, 1e-9, bdense)
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def _old_estimate_norm(pool, n, iters, generator, index, dense=None):
    """The body of estimate_norm before the power iteration moved into a
    kernel (it returned a float)."""
    x = torch.randn((n,), generator=generator)
    X = torch.randn((n, n), generator=generator)
    X = 0.5 * (X + X.T)
    for _ in range(iters):
        kA, kB, kC, *kD = apply_K(x, X, pool, dense)
        gx, gX = apply_KT(kA, kB, kC * pool.active, pool, n, index, kD[0] if kD else None,
                          dense)
        gX = 0.5 * (gX + gX.T)
        nrm = torch.sqrt((gx * gx).sum() + (gX * gX).sum()) + 1e-30
        x, X = gx / nrm, gX / nrm
    kA, kB, kC, *kD = apply_K(x, X, pool, dense)
    lam2 = (kA * kA).sum() + (kB * kB).sum() + ((kC * pool.active) ** 2).sum()
    if dense is not None:
        lam2 = lam2 + (kD[0] * kD[0]).sum()
    return float(torch.sqrt(lam2) * 1.02 + 1e-12)


@pytest.mark.parametrize("kind", ["boxqp", "qcqp"])
def test_norm_twin_repeats_the_old_body_and_the_reference(kind):
    """K6's twin (and the wrapper on the CPU) gives the old estimate_norm's
    bits, and stays within the existing 2% of the reference's (different
    start vectors); the batched twin gives each instance the same bits as
    its batch of one's."""
    n, (_, _, jpool, jd, _), (_, _, tpool, td, _) = _case(kind, seed=11)
    index = build_cut_index(tpool, n)
    gen = lambda: torch.Generator().manual_seed(0)      # noqa: E731
    old = _old_estimate_norm(tpool, n, 30, gen(), index, td)
    twin = tpdhg.estimate_norm_plain(tpool, n, 30, gen(), index, td)
    assert twin.dim() == 0 and float(twin) == old
    assert float(pdhg_norm(tpool, n, 30, gen(), index, td)) == old
    ref = float(jpdhg.estimate_norm(jpool, n, 30, jnp.float32, jd))
    np.testing.assert_allclose(old, ref, rtol=2e-2)
    one = lambda o: rb.batch_of_one(o)      # noqa: E731
    batched = pdhg_norm_batched(one(tpool), n, 30, gen(), rb.build_cut_index(one(tpool), n),
                                None if td is None else one(td))
    np.testing.assert_allclose(float(batched[0]), old, rtol=1e-6)


def test_record_layout_matches_the_kernels_header():
    """lp/pdhg.py's record offsets are csrc/pdhg_common.cuh's kRec*."""
    with open(os.path.join(REPO, "sdpcutsel_tpu_torch", "csrc", "pdhg_common.cuh")) as f:
        header = dict(re.findall(r"constexpr int kRec(\w+) = (\d+);", f.read()))
    names = {"It": "IT", "Wlen": "WLEN", "Stop": "STOP", "Restart": "RESTART",
             "UseAvg": "USE_AVG", "Omega": "OMEGA", "Err": "ERR", "P": "P", "D": "D",
             "Tau": "TAU", "Sigma": "SIGMA", "Eta": "ETA", "Dp": "DP", "Dd": "DD",
             "Words": "WORDS"}
    assert set(header) == set(names)
    for c_name, py in names.items():
        assert int(header[c_name]) == getattr(tpdhg, f"REC_{py}"), c_name


def test_new_record_starts_the_reference_loop():
    """The record of a fresh solve: omega0, err inf, eta = step_scale / normK
    and the first steps in float32; stopped only when no block is to run."""
    rec = tpdhg.new_record(torch.tensor(7.5), 1.3, 0.95, 2000, 2e-6, "cpu")
    r = rec.numpy()
    f = record_floats(r)
    eta = np.float32(0.95) / np.float32(7.5)
    assert f[tpdhg.REC_ETA] == eta and f[REC_OMEGA] == np.float32(1.3)
    assert f[REC_TAU] == eta / np.float32(1.3) and f[REC_SIGMA] == eta * np.float32(1.3)
    assert np.isinf(f[REC_ERR]) and r[REC_IT] == r[REC_WLEN] == r[REC_STOP] == 0
    assert tpdhg.new_record(7.5, 1.3, 0.95, 0, 2e-6, "cpu")[REC_STOP] == 1
    batch = tpdhg.new_record(torch.tensor([7.5, 2.0]), 1.0, 0.95, 10, 1e-3, "cpu", batch=2)
    assert batch.shape == (2, tpdhg.REC_WORDS)
    assert record_floats(batch.numpy())[1, tpdhg.REC_ETA] == np.float32(0.95) / np.float32(2.0)


def test_wrappers_refuse_other_devices():
    n, _, (tcx, tcX, tpool, td, (tst, tacc, tanc)) = _case("boxqp", seed=1)
    index = build_cut_index(tpool, n)
    meta = lambda t: t.to("meta")      # noqa: E731
    with pytest.raises(ValueError, match="no kernel"):
        pdhg_block_checked(meta(tcx), tcX, tpool, index, tst, tacc, tanc, _record(), 100, 300,
                           10, 1e-6)
    pool_meta = tcb.CutPool(*(meta(t) for t in (tpool.idx, tpool.lin, tpool.quad, tpool.rhs,
                                                 tpool.active, tpool.count)))
    with pytest.raises(ValueError, match="no kernel"):
        pdhg_norm(pool_meta, n, 30, torch.Generator().manual_seed(0), index)


# ---- the checked block: K2's launch with K5 as its epilogue (lp/pdhg_check.py)

def _buffers(tst, tacc, tanc, rec):
    return [tst.map(torch.clone), tacc.map(torch.clone), tanc.map(torch.clone), rec.clone()]


@pytest.mark.parametrize("restart_period", [10 ** 6, 300])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("kind", ["boxqp", "qcqp25"])
def test_checked_block_on_the_cpu_is_the_block_then_the_check(kind, batched, restart_period):
    """On the CPU the checked block is K2's twin (pdhg_block_steps_plain)
    followed by K5's (pdhg_check_plain), bit for bit, single and batched, at
    m = 0 and m = 25: the state, sums, anchor and record."""
    n, _, (tcx, tcX, tpool, td, (tst, tacc, tanc)) = _case(kind, seed=12)
    index = build_cut_index(tpool, n)
    assert td is None or td.m == 25
    rec = _record(wlen=100)
    mine, theirs = _buffers(tst, tacc, tanc, rec), _buffers(tst, tacc, tanc, rec)
    if batched:
        one = rb.batch_of_one
        bdense = None if td is None else one(td)
        bmine = [one(s) for s in mine[:3]] + [mine[3][None]]
        pdhg_block_checked_batched(tcx[None], tcX[None], one(tpool),
                                   rb.build_cut_index(one(tpool), n), *bmine, 100,
                                   restart_period, 10 ** 6, 1e-9, bdense)
    else:
        pdhg_block_checked(tcx, tcX, tpool, index, *mine, 100, restart_period, 10 ** 6, 1e-9,
                           td)
    pdhg_block_steps_plain(tcx, tcX, tpool, index, theirs[0], theirs[1], theirs[3], 100, td)
    tpdhg.pdhg_check_plain(tcx, tcX, tpool, index, *theirs, 100, restart_period, 10 ** 6, 1e-9,
                           td)
    assert all(_same_state(a, b) for a, b in zip(mine[:3], theirs[:3]))
    assert torch.equal(mine[3], theirs[3])
    assert mine[3][REC_IT] == rec[REC_IT] + 100


@pytest.mark.parametrize("kind", ["boxqp", "qcqp25"])
def test_checked_block_matches_reference_checked_block(kind):
    """One checked block through the wrapper on the CPU against the JAX
    package's ``checked_block`` (its ``_solve_impl`` run for one block) from
    the same state at the same normK, restart_period 100 (the block
    restarts): the states at rtol/atol 2e-5, omega at rtol 1e-4, the
    iteration count equal."""
    n, (jcx, jcX, jpool, jd, (jst, _, _)), (tcx, tcX, tpool, td, (tst, _, _)) = \
        _case(kind, seed=13)
    normK = float(jpdhg.estimate_norm(jpool, n, 30, jnp.float32, jd))
    st_j, info_j = jpdhg._solve_impl(jcx, jcX, jpool, jd, jst, normK, 1.0, 1e-12, 1e-6, 0.95,
                                     100, 100, 100)
    st, anc, acc = tpdhg._buffers(tst)
    rec = tpdhg.new_record(normK, 1.0, 0.95, 100, 1e-12, "cpu")
    pdhg_block_checked(tcx, tcX, tpool, build_cut_index(tpool, n), st, acc, anc, rec, 100, 100,
                       100, 1e-12, td)
    f = record_floats(rec.numpy())
    assert int(rec[REC_IT]) == int(info_j["iters"]) == 100 and int(rec[REC_STOP]) == 1
    np.testing.assert_allclose(f[REC_OMEGA], float(info_j["omega"]), rtol=1e-4)
    for name in FIELDS:
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(st_j, name)),
                                   rtol=2e-5, atol=2e-5)


def test_solves_step_through_the_checked_form_and_steering_does_not(monkeypatch):
    """On K2's route every solve builds its step with ``checked_step`` once
    and runs it once a block; the plain route does not; steering's block is
    K2's unchecked ``pdhg_block`` and never the checked form."""
    from sdpcutsel_tpu_torch.lp import pdhg_check as tcheck
    from sdpcutsel_tpu_torch.lp import pdhg_kernel as tkernel

    n, _, (tcx, tcX, tpool, td, (tst, _, _)) = _case("qcqp", seed=14)
    index = build_cut_index(tpool, n)
    normK = tpdhg.estimate_norm_plain(tpool, n, 30, torch.Generator().manual_seed(0), index, td)
    made, ran = [], []
    real = tcheck.checked_step

    def counted(*args, **kw):
        step = real(*args, **kw)
        made.append(1)

        def run():
            ran.append(1)
            step()
        return run

    monkeypatch.setattr(tcheck, "checked_step", counted)
    _, info = tpdhg._solve_impl(tcx, tcX, tpool, index, tst, normK, 1.0, 1e-12, 0.95, 500, 100,
                                300, td, route="k2")
    assert made == [1] and len(ran) == info["iters"] // 100 == 5
    tpdhg._solve_impl(tcx, tcX, tpool, index, tst, normK, 1.0, 1e-12, 0.95, 500, 100, 300, td,
                      route="plain")
    assert made == [1] and len(ran) == 5

    blocks = []
    real_block = tkernel.pdhg_block

    def block(*args, **kw):
        blocks.append(args[8])                 # iters
        return real_block(*args, **kw)

    def refuse(*args, **kw):
        raise AssertionError("steering took the checked form")

    monkeypatch.setattr(tkernel, "pdhg_block", block)
    monkeypatch.setattr(tcheck, "checked_step", refuse)
    setup = tpdhg.SolveSetup("k2", index, normK)
    sx, SX = tpdhg.rademacher_signs(n, torch.Generator().manual_seed(1), "cpu")
    tpdhg._steer_impl(tcx, tcX, tpool, td, tst, setup, 1.0, 0.95, 1e-3, sx, SX, 40)
    assert blocks == [40]


@pytest.mark.parametrize("n,M,k,m", [(125, 1024, 3, 0), (100, 1024, 5, 25), (13, 40, 3, 0)])
def test_checked_plan_holds_the_block_and_the_check(n, M, k, m):
    """The checked form's shared memory is the unchecked plan's, plus the
    check's sums (csrc/pdhg_check.cuh check_layout, summed from the source)
    where K2's Xb band does not hold them; both fit the card, and the
    route's rule (plan_refusal) is the checked form's."""
    from sdpcutsel_tpu_torch.lp import pdhg_kernel as tkernel

    plain, checked = tkernel.launch_plan(n, M, k, m), tkernel.launch_plan(n, M, k, m,
                                                                          checked=True)
    assert checked.checked and not plain.checked
    extra = tkernel._check_words(tkernel.CLUSTER)
    band = -(-n // tkernel.CLUSTER) * n         # the Xb band holds the sums where it can
    assert (tkernel._smem_words(n, M, k, m, tkernel.CLUSTER, checked=True)
            == tkernel._smem_words(n, M, k, m, tkernel.CLUSTER) + (extra if band < extra else 0))
    assert plain.smem_bytes <= tkernel.SMEM_MAX and checked.smem_bytes <= tkernel.SMEM_MAX
    assert checked.term_cap > 0 and checked.max_capacity == plain.max_capacity >= M
    assert extra < 1024                   # the check adds its sums, not a second set of bands
    with open(os.path.join(REPO, "sdpcutsel_tpu_torch", "csrc", "pdhg_check.cuh")) as f:
        text = f.read()
    body = text[text.index(" check_layout("):]
    body = body[:body.index("#undef TAKE")]
    C, R = tkernel.CLUSTER, -(-n // tkernel.CLUSTER)
    names = dict(n=n, M=M, m=m, C=C, R=R, kCols=128, kWarpsPerRow=4, kGroups=4, kNV=8, kND=6,
                 kThreads=512)
    assert extra == sum(eval(e, {}, names)                   # noqa: S307 (the repository's source)
                        for e in re.findall(r"TAKE\(\w+, ([^;]*?)\);", body))
    over = checked.max_capacity + 1
    assert tkernel.plan_refusal(n, over, k, m) is not None
