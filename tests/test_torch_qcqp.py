"""Port parity of the sparse-QCQP path: the dense constraint rows, the PDHG
pieces that carry them (operators, block twin, solve, f64 certificate), the
re-selection gate, and CutSolverQCQP against sdpcutsel_tpu on the CPU, on
the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpcutsel_tpu.lp import pdhg as jpdhg
from sdpcutsel_tpu.qcqp.solver import CutSolverQCQP as JaxCutSolverQCQP
from sdpcutsel_tpu.relax import cutbuffer as jcb
from sdpcutsel_tpu.relax import denserows as jdr
from sdpcutsel_tpu.relax import mccormick as jmc
from sdpcutsel_tpu_torch.config import CutConfig, LoopConfig, LPConfig, RunConfig, ScorerConfig
from sdpcutsel_tpu_torch.instances.qcqp import generate_qcqp, load_or_generate_qcqp
from sdpcutsel_tpu_torch.lp import pdhg as tpdhg
from sdpcutsel_tpu_torch.lp.pdhg_kernel import pdhg_block
from sdpcutsel_tpu_torch.qcqp import CutSolverQCQP
from sdpcutsel_tpu_torch.relax import cutbuffer as tcb
from sdpcutsel_tpu_torch.relax import denserows as tdr
from sdpcutsel_tpu_torch.relax import mccormick as tmc
from sdpcutsel_tpu_torch.relax.cutbuffer import build_cut_index
from test_torch_portmods import reference_config

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's CPU threads share this process; torch's intra-op pool on top of
    them oversubscribes the cores (10x slower on these small tensors)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(seed=0, M=48, k=4):
    """A small QCQP's dense rows, a random pool of k-cuts with some repeated
    support indices, and a random state, in both packages."""
    inst = generate_qcqp(12, 40, 3, 2)
    n, m = inst.n, inst.m
    rng = np.random.default_rng(seed)
    live = M - 8                                    # leave some rows empty
    idx = rng.integers(0, n, (live, k)).astype(np.int32)
    idx[::5, -1] = idx[::5, -2]
    lin = rng.standard_normal((live, k)).astype(np.float32)
    quad = rng.standard_normal((live, k, k)).astype(np.float32)
    quad = 0.5 * (quad + np.transpose(quad, (0, 2, 1)))
    rhs = (0.1 * rng.standard_normal(live)).astype(np.float32)
    cuts = (idx, lin, quad, rhs, np.ones(live, np.float32))
    st = dict(x=rng.random(n), X=rng.random((n, n)), yA=0.1 * rng.random((n, n)),
              yB=0.1 * rng.random((n, n)), yC=0.05 * rng.random(M),
              yD=0.2 * rng.random(m))
    st["X"] = 0.5 * (st["X"] + st["X"].T)
    st = {f: a.astype(np.float32) for f, a in st.items()}

    jdense = jdr.dense_from_qcqp(inst.Qs, inst.cs, inst.bs)
    jpool = jcb.append_cuts(jcb.empty_pool(M, k), *(jnp.asarray(a) for a in cuts))
    jst = jpdhg.PDHGState(**{f: jnp.asarray(a) for f, a in st.items()})
    tdense = tdr.dense_from_qcqp(inst.Qs, inst.cs, inst.bs, "cpu")
    tpool = tcb.append_cuts(tcb.empty_pool(M, k, "cpu"),
                            *(torch.as_tensor(a) for a in cuts))
    tst = tpdhg.PDHGState(**{f: torch.as_tensor(a) for f, a in st.items()})
    Q, c = inst.Q0.astype(np.float32), inst.c0.astype(np.float32)
    return inst, (jnp.asarray(-c), jnp.asarray(-0.5 * Q), jpool, jdense, jst), \
        (torch.as_tensor(-c), torch.as_tensor(-0.5 * Q), tpool, tdense, tst)


def _np(st):
    return [np.asarray(a) for a in (st.x, st.X, st.yA, st.yB, st.yC, st.yD)]


def test_dense_rows_match_reference():
    inst, (_, _, _, jd, jst), (_, _, _, td, tst) = _setup()
    for got, want in zip((td.G, td.g, td.h), jd):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(
        tdr.dense_residuals(tst.x, tst.X, td).numpy(),
        np.asarray(jdr.dense_residuals(jst.x, jst.X, jd)), rtol=1e-5, atol=1e-6)
    for got, want in zip(tdr.dense_adjoint(tst.yD, td), jdr.dense_adjoint(jst.yD, jd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert tdr.empty_dense(inst.n, "cpu").m == 0
    with pytest.raises(ValueError):
        tdr.dense_from_qcqp([], [], [], "cpu")


def test_operators_with_dense_rows_match_reference():
    inst, (_, _, jpool, jd, jst), (_, _, tpool, td, tst) = _setup(seed=1)
    n = inst.n
    for got, want in zip(tmc.apply_K(tst.x, tst.X, tpool, td),
                         jmc.apply_K(jst.x, jst.X, jpool, jd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    got = tmc.apply_KT(tst.yA, tst.yB, tst.yC, tpool, n, build_cut_index(tpool, n),
                       tst.yD, td)
    want = jmc.apply_KT(jst.yA, jst.yB, jst.yC, jpool, n, jst.yD, jd)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_pdhg_block_twin_with_dense_rows_matches_one_iter_loop():
    inst, (jcx, jcX, jpool, jd, jst), (tcx, tcX, tpool, td, tst) = _setup(seed=2)
    n, iters, tau, sigma = inst.n, 7, 0.013, 0.07
    ref, acc = jst, jax.tree.map(jnp.zeros_like, jst)
    for _ in range(iters):
        ref = jpdhg._one_iter(jcx, jcX, jpool, jd, n, ref, tau, sigma)
        acc = jax.tree.map(lambda a, b: a + b, acc, ref)
    st, sacc = pdhg_block(tcx, tcX, tpool, build_cut_index(tpool, n), tst,
                          tst.map(torch.zeros_like), tau, sigma, iters, td)
    assert float(st.yD.abs().sum()) > 0.0
    for got, want in zip([*st.fields(), *sacc.fields()], [*_np(ref), *_np(acc)]):
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_solve_with_dense_rows_matches_reference_with_same_normK():
    inst, (jcx, jcX, jpool, jd, jst), (tcx, tcX, tpool, td, tst) = _setup(seed=3)
    n = inst.n
    normK = float(jpdhg.estimate_norm(jpool, n, 30, jnp.float32, jd))
    nt = tpdhg.estimate_norm(tpool, n, 30, torch.Generator().manual_seed(0),
                             build_cut_index(tpool, n), td)
    np.testing.assert_allclose(nt, normK, rtol=2e-2)   # unrelated start vectors
    args = dict(omega0=1.0, tol=1e-7, step_scale=0.95, max_iters=600,
                check_every=100, restart_period=500)
    st_j, info_j = jpdhg._solve_impl(
        jcx, jcX, jpool, jd, jst, normK, args["omega0"], args["tol"], 1e-6,
        args["step_scale"], args["max_iters"], args["check_every"],
        args["restart_period"], use_kernel=False)
    st_t, info_t = tpdhg._solve_impl(tcx, tcX, tpool, build_cut_index(tpool, n), tst,
                                     normK, **args, dense=td)
    assert info_t["iters"] == int(info_j["iters"])
    np.testing.assert_allclose(info_t["dual_obj"], float(info_j["dual_obj"]),
                               rtol=1e-4, atol=1e-4)
    for got, want in zip(st_t.fields(), _np(st_j)):
        np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)


def test_dual_bound_f64_with_dense_rows_identical_duals():
    inst, (_, _, jpool, jd, jst), (_, _, tpool, td, tst) = _setup(seed=4)
    want = jpdhg.dual_bound_f64(inst.Q0, inst.c0, jpool, jst, dense=jd)
    got = tpdhg.dual_bound_f64(inst.Q0, inst.c0, tpool, tst,
                               dense_np=tuple(t.numpy() for t in (td.G, td.g, td.h)))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # the dense block's duals move the certificate
    assert got != tpdhg.dual_bound_f64(inst.Q0, inst.c0, tpool, tst)


def _solvers(cfg, name="qcqp012-40-3-2"):
    inst = load_or_generate_qcqp(name)
    return JaxCutSolverQCQP(inst, reference_config(cfg)), CutSolverQCQP(inst, cfg, "cpu")


@pytest.mark.parametrize("gate", ["residual", "cooldown", "none"])
def test_gated_scores_and_gate_update_match_reference(gate):
    """The neural score gated at viol_tol, the re-selection gate's mask and
    its state update, on one LP point and a gate state shared by both."""
    cfg = RunConfig(lp=LPConfig(max_iters=1500, tol=1e-5),
                    cuts=CutConfig(k=4, sel_size=8, capacity=128, sel_gate=gate))
    js, ts = _solvers(cfg)
    T = ts.table.shape[0]
    np.testing.assert_array_equal(ts.table.numpy(), np.asarray(js.table))
    ts.do_round()                                      # an LP point with cuts
    x, X = ts.state.x, ts.state.X
    jx, jX = jnp.asarray(x.numpy()), jnp.asarray(X.numpy())
    rng = np.random.default_rng(0)
    last = np.where(rng.random(T) < 0.5, np.inf, rng.random(T)).astype(np.float32)
    cool = rng.integers(0, 3, T).astype(np.int32)
    ts._last_viol, ts._cooldown = torch.as_tensor(last), torch.as_tensor(cool)

    scores, feas = ts._scores(x, X)
    ref = np.asarray(js._score_fn(jx, jX, jax.random.PRNGKey(0)))
    np.testing.assert_array_equal(np.isfinite(scores.numpy()), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(scores.numpy()[fin], ref[fin], rtol=2e-4, atol=2e-5)

    kkt = 1.0                        # above cooldown_kkt_tol: the cooldown mask applies
    gated = ts._gate_scores(scores, feas, kkt)
    jgated, jfeas = js._gate_scores(jnp.asarray(scores.numpy()), jx, jX, kkt,
                                    jnp.asarray(cool), jnp.asarray(last))
    np.testing.assert_array_equal(np.isfinite(gated.numpy()), np.isfinite(np.asarray(jgated)))
    assert np.isfinite(gated.numpy()).sum() < np.isfinite(scores.numpy()).sum() or gate == "none"

    sel = torch.as_tensor(np.flatnonzero(np.isfinite(gated.numpy()))[:8])
    valid = torch.ones_like(sel, dtype=torch.bool)
    valid[-1] = False
    ts._gate_update(sel, valid, feas)
    jcool, jlast = js._gate_update(jnp.asarray(sel.numpy()), jnp.asarray(valid.numpy()),
                                   jfeas, jnp.asarray(cool), jnp.asarray(last))
    np.testing.assert_array_equal(ts._cooldown.numpy(), np.asarray(jcool))
    np.testing.assert_allclose(ts._last_viol.numpy(), np.asarray(jlast), rtol=0, atol=5e-5)


@pytest.mark.parametrize("name,k", [("qcqp012-40-3-2", 4), ("qcqp015-30-3-1", 5)])
def test_cut_solver_qcqp_matches_reference(name, k):
    cfg = RunConfig(lp=LPConfig(max_iters=6000, tol=1e-5),
                    cuts=CutConfig(k=k, sel_size=8, capacity=128))
    js, ts = _solvers(cfg, name)
    ref, got = js.run(rounds=3), ts.run(rounds=3)
    assert len(got) == len(ref) == 3
    # round 0 precedes any selection: same solve, same candidates picked
    assert got[0].lp_iters == ref[0].lp_iters
    assert got[0].cuts_added == ref[0].cuts_added > 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.bound, r.bound, rtol=2e-3)
    bounds = [s.bound for s in got]
    assert all(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:]))
    assert bounds == list(np.minimum.accumulate([s.certificate for s in got]))


def test_polish_lowers_only_the_last_bound():
    cfg = RunConfig(lp=LPConfig(max_iters=1000, tol=1e-5),
                    cuts=CutConfig(k=4, sel_size=8, capacity=128),
                    loop=LoopConfig(polish_iters=1000))
    inst = load_or_generate_qcqp("qcqp012-40-3-2")
    solver = CutSolverQCQP(inst, cfg, "cpu")
    hist = solver.run(rounds=2)
    certs = np.minimum.accumulate([h.certificate for h in hist])
    assert hist[0].bound == certs[0]
    assert hist[-1].bound == min(certs[-1], solver.polish_certificate)


# the three options the port refused before the round controllers' options
# were ported; each now builds and runs one CPU round
OPTIONS = {
    "feasibility": RunConfig(scorer=ScorerConfig(strategy="feasibility")),
    "scan": RunConfig(loop=LoopConfig(use_scan=True)),
    "steering": RunConfig(loop=LoopConfig(steer_eps=1e-3)),
}


@pytest.mark.parametrize("option", OPTIONS)
def test_options_run_one_round(option):
    hist = CutSolverQCQP(generate_qcqp(8, 40, 2, 1), OPTIONS[option], "cpu").run(rounds=1)
    assert len(hist) == 1 and np.isfinite(hist[0].bound)
    assert hist[0].bound == hist[0].certificate


@pytest.mark.parametrize("cfg", [
    RunConfig(scorer=ScorerConfig(strategy="nope")),
    RunConfig(cuts=CutConfig(k=4), scorer=ScorerConfig(strategy="triangle")),
])
def test_reference_value_errors(cfg):
    """The reference's two ValueErrors: an unknown strategy, and triangle
    with k != 3."""
    with pytest.raises(ValueError, match="unknown strategy|requires k=3"):
        CutSolverQCQP(generate_qcqp(8, 40, 2, 1), cfg, "cpu")
