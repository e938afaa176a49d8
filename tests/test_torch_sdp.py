"""The port's SDP certifiers (sdpcutsel_tpu_torch/loop/sdp_bound.py,
sdp_primal.py, sdp_dual.py) against the JAX package's.

The host functions are float64 numpy copies of the reference's, so they
must give its bits on the reference tests' own inputs.  The eigencut loop
solves its LP in float32 over the first ``count`` dense rows, where the
reference sums over every row of the buffer; its bounds agree per round at
rtol 2e-3 (the tolerance of the LP parity tests, tests/test_loop.py).  The
purge is held bit for bit to the reference's on one buffer and one state.
Torch runs on one thread (see tests/test_torch_resume.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpcutsel_tpu.config import LPConfig as JLPConfig
from sdpcutsel_tpu.instances import generate_spar as jgenerate_spar
from sdpcutsel_tpu.instances import load_or_generate as jload_or_generate
from sdpcutsel_tpu.instances.qcqp import generate_qcqp as jgenerate_qcqp
from sdpcutsel_tpu.loop import sdp_bound as jsb
from sdpcutsel_tpu.loop import sdp_dual as jsd
from sdpcutsel_tpu.loop import sdp_primal as jsp
from sdpcutsel_tpu.lp.pdhg import init_state as jinit_state
from sdpcutsel_tpu_torch.config import LPConfig
from sdpcutsel_tpu_torch.instances import generate_spar
from sdpcutsel_tpu_torch.instances.qcqp import generate_qcqp
from sdpcutsel_tpu_torch.loop import sdp_bound as tsb
from sdpcutsel_tpu_torch.loop import sdp_dual as tsd
from sdpcutsel_tpu_torch.loop import sdp_primal as tsp
from sdpcutsel_tpu_torch.lp.pdhg_kernel import kernel_route, plan_refusal
from sdpcutsel_tpu_torch.relax.denserows import dense_from_qcqp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def bm12():
    """The reference's Burer-Monteiro point and bound on spar012-100-3."""
    inst = jgenerate_spar(12, 100, 3)
    return inst, jsp.bm_feasible_point(inst.Q, inst.c)


def _lower_bound_cases():
    """The inputs of tests/test_sdp_bound.py's lower-bound tests."""
    inst = jgenerate_spar(8, 100, 1)
    x = np.full(8, 0.3)
    psd = (inst.Q, inst.c, x, np.outer(x, x), {})
    inst = jload_or_generate("spar020-100-1", data_dir="data/boxqp")
    rng = np.random.default_rng(0)
    x = rng.uniform(0.3, 0.7, inst.n)
    X = np.maximum(0.0, x[:, None] + x[None, :] - 1.0)
    np.fill_diagonal(X, x)
    raw = (inst.Q, inst.c, x, X, {"repair_iters": 0})
    repaired = (inst.Q, inst.c, x, X, {})
    q = jgenerate_qcqp(8, 50, 2, 3)
    rng = np.random.default_rng(0)
    x = rng.uniform(0.4, 0.9, q.n)
    rows = (q.Q0, q.c0, x, np.minimum(x[:, None], x[None, :]),
            {"repair_iters": 0, "rows": jsb.qcqp_rows(q),
             "anchor": jsb.qcqp_interior_anchor(q)})
    return {"psd point": psd, "antitone face raw": raw,
            "antitone face repaired": repaired, "qcqp rows": rows}


@pytest.mark.parametrize("case", ["psd point", "antitone face raw",
                                  "antitone face repaired", "qcqp rows"])
def test_sdp_lower_bound_matches(case):
    Q, c, x, X, kw = _lower_bound_cases()[case]
    assert tsb.sdp_lower_bound(Q, c, x, X, **kw) == jsb.sdp_lower_bound(Q, c, x, X, **kw)


def test_sdp_lower_bound_rows_need_an_anchor():
    Q, c, x, X, kw = _lower_bound_cases()["qcqp rows"]
    with pytest.raises(ValueError, match="row-feasible anchor"):
        tsb.sdp_lower_bound(Q, c, x, X, rows=kw["rows"])


def test_bm_feasible_point_boxqp_matches(bm12):
    inst, (x, X, lb) = bm12
    tx, tX, tlb, mults = tsp.bm_feasible_point(inst.Q, inst.c, return_multipliers=True)
    np.testing.assert_array_equal(tx, x)
    np.testing.assert_array_equal(tX, X)
    assert tlb == lb
    jmults = jsp.bm_feasible_point(inst.Q, inst.c, return_multipliers=True)[3]
    assert mults.keys() == jmults.keys()
    for key in mults:
        np.testing.assert_array_equal(mults[key], jmults[key])


def test_bm_feasible_point_qcqp_matches():
    inst = jgenerate_qcqp(10, 40, 2, 1)
    rows, anchor = jsb.qcqp_rows(inst), jsb.qcqp_interior_anchor(inst)
    want = jsp.bm_feasible_point(inst.Q0, inst.c0, rows=rows, anchor=anchor)
    got = tsp.bm_feasible_point(inst.Q0, inst.c0, rows=rows, anchor=anchor)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert tsp.bm_lower_bound(inst.Q0, inst.c0, rows=rows, anchor=anchor) == want[2]


def test_dual_upper_bound_matches(bm12):
    """Cold, then the garbage warm start of tests/test_sdp_bound.py::
    test_dual_upper_bound_validity: the same bound and multipliers."""
    inst, (_, _, lb) = bm12
    ub, lams = tsd.dual_upper_bound(inst.Q, inst.c, maxiter=60)
    jub, jlams = jsd.dual_upper_bound(inst.Q, inst.c, maxiter=60)
    assert ub == jub and np.isfinite(ub) and ub >= lb - 1e-6
    rng = np.random.default_rng(0)
    bad = {k: np.abs(rng.standard_normal(v.shape)) for k, v in jlams.items()}
    got = tsd.dual_upper_bound(inst.Q, inst.c, lams=bad, barrier_ts=(1e2,), maxiter=5)
    want = jsd.dual_upper_bound(inst.Q, inst.c, lams=bad, barrier_ts=(1e2,), maxiter=5)
    assert got[0] == want[0] and got[0] >= lb - 1e-6
    for (k, a), (kw, b) in zip([*lams.items(), *got[1].items()],
                               [*jlams.items(), *want[1].items()]):
        assert k == kw
        np.testing.assert_array_equal(a, b)


def test_bm_null_directions_matches(bm12):
    _, (x, X, _) = bm12
    got = tsb.bm_null_directions(x, X)
    np.testing.assert_array_equal(got, jsb.bm_null_directions(x, X))
    np.testing.assert_array_equal(tsb.bm_null_directions(x, X, max_dirs=7, tol_frac=0.5),
                                  jsb.bm_null_directions(x, X, max_dirs=7, tol_frac=0.5))


@pytest.mark.parametrize("args", [(10, 40, 2, 1), (8, 50, 2, 3)])
def test_qcqp_rows_and_anchor_match(args):
    inst = generate_qcqp(*args)
    for g, w in zip(tsb.qcqp_rows(inst), jsb.qcqp_rows(jgenerate_qcqp(*args))):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(tsb.qcqp_interior_anchor(inst),
                    jsb.qcqp_interior_anchor(jgenerate_qcqp(*args))):
        np.testing.assert_array_equal(g, w)


def test_gap_closed_matches():
    bounds = [300.0, 250.5, 180.25, 120.0, 99.0]
    np.testing.assert_array_equal(tsb.gap_closed(300.0, 100.0, bounds),
                                  jsb.gap_closed(300.0, 100.0, bounds))
    np.testing.assert_array_equal(tsb.gap_closed(5.0, 5.0, [5.0, 4.0]),
                                  jsb.gap_closed(5.0, 5.0, [5.0, 4.0]))


def test_tight_instance_stops_immediately():
    """tests/test_utils.py::test_sdp_bound_tight_instance_stops_immediately:
    n = 10 generator instances have integral McCormick optima."""
    sdp, mc, hist = tsb.sdp_relaxation_bound(
        generate_spar(10, 100, 1), LPConfig(max_iters=6000, tol=2e-6), max_rounds=5,
        capacity=64, device="cpu")
    assert len(hist) == 1
    assert abs(sdp - mc) < 1e-6


def _anchored(inst):
    x, X, _ = tsp.bm_feasible_point(inst.Q, inst.c)
    return dict(anchor=(x, X), seed_dirs=tsb.bm_null_directions(x, X),
                max_cuts_per_round=48, capacity=2048)


RUNS = {
    # name: (instance args, LP (max_iters, tol), rounds, keywords)
    "spar012-100-3 plain": ("spar", (12, 100, 3), (3000, 2e-6), 8, dict(capacity=64)),
    "spar012-100-3 anchored, seeded": ("spar", (12, 100, 3), (3000, 2e-6), 8, "anchored"),
    # purges in rounds 3 and 4; the purge ranks rows by their f32 duals, so
    # later rounds may keep other rows than the reference and drift apart
    "spar012-100-3 purged": ("spar", (12, 100, 3), (3000, 2e-6), 5,
                             dict(capacity=64, purge_at=12)),
    # purges in rounds 3 and 4 past the 2 constraint rows (and the same drift)
    "qcqp010-40-2-1 purged": ("qcqp", (10, 40, 2, 1), (3000, 2e-6), 6,
                              dict(capacity=64, purge_at=8)),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_sdp_relaxation_bound_matches_reference(name):
    family, args, (iters, tol), rounds, kw = RUNS[name]
    gen, jgen = (generate_spar, jgenerate_spar) if family == "spar" else \
        (generate_qcqp, jgenerate_qcqp)
    inst = gen(*args)
    if kw == "anchored":
        kw = _anchored(inst)
    best, b0, hist = tsb.sdp_relaxation_bound(inst, LPConfig(max_iters=iters, tol=tol),
                                              max_rounds=rounds, device="cpu", **kw)
    jbest, jb0, jhist = jsb.sdp_relaxation_bound(jgen(*args), JLPConfig(max_iters=iters, tol=tol),
                                                 max_rounds=rounds, **kw)
    got = np.array([h["bound"] for h in hist])
    want = np.array([h["bound"] for h in jhist])
    r = min(len(got), len(want))
    assert r >= 1
    np.testing.assert_allclose(got[:r], want[:r], rtol=2e-3)
    np.testing.assert_allclose([best, b0], [jbest, jb0], rtol=2e-3)
    assert best == got.min() and b0 == got[0]
    if "purge_at" in kw:
        counts = [h["cuts"] for h in hist]
        assert any(b < a for a, b in zip(counts, counts[1:])), counts   # a purge ran
    if family == "qcqp":
        assert all(h["cuts"] >= inst.m for h in hist)


def test_purge_matches_reference_and_keeps_the_prefix():
    """The purge on one buffer and one LP state: the reference's kept rows,
    order and permuted duals bit for bit, rows [0, m0) untouched, the tail
    zero on the host and in the device buffer."""
    inst = generate_qcqp(10, 40, 2, 1)
    n, cap = inst.n, 64
    rng = np.random.default_rng(3)
    buf = tsb._DenseBuffer(n, cap, "cpu")
    qrows = dense_from_qcqp(inst.Qs, inst.cs, inst.bs, "cpu")
    buf.append(*(t.numpy() for t in (qrows.G, qrows.g, qrows.h)))
    m0 = buf.count
    for _ in range(3):
        x = rng.uniform(0, 1, n)
        X = np.outer(x, x) + 0.01 * rng.standard_normal((n, n))
        rows, _ = tsb._gen_dense_cuts_host(x, 0.5 * (X + X.T), 1e-4, 12)
        buf.append(*rows)
    count = buf.count
    buf.yD[:count] = torch.as_tensor(rng.uniform(0, 0.3, count).astype(np.float32))
    x = rng.uniform(0, 1, n).astype(np.float32)
    X = np.minimum(x[:, None], x[None, :])
    before = [a.copy() for a in buf.mirror]
    jstate = jinit_state(n, 1, cap)._replace(x=jnp.asarray(x), X=jnp.asarray(X),
                                             yD=jnp.asarray(buf.yD.numpy()))
    (jG, jg, jh), _, jst, jk = jsb._purge_dense_rows(
        tuple(a.copy() for a in buf.mirror), jstate, count, m0, jnp.float32)
    tsb._purge_dense_rows(buf, x.astype(np.float64), X.astype(np.float64), m0)
    assert buf.count == int(jk) < count
    for got, want in zip(buf.mirror, (jG, jg, jh)):
        np.testing.assert_array_equal(got, want)
    for got, host in zip((buf.rows.G, buf.rows.g, buf.rows.h), buf.mirror):
        np.testing.assert_array_equal(got.numpy(), host)
    np.testing.assert_array_equal(buf.yD.numpy(), np.asarray(jst.yD))
    for a, b in zip(buf.mirror, before):
        np.testing.assert_array_equal(a[:m0], b[:m0])


def test_certifier_route():
    """The certifier's LP takes the dense route: its pool (capacity 1, width
    1) is outside K2's plan, and "auto" on CUDA and "on" anywhere choose the
    dense-row kernels for it; on the CPU "auto" is the plain loop and "on"
    the dense wrappers' twins, with the same bits as "off"."""
    inst = generate_spar(10, 100, 1)
    why = plan_refusal(inst.n, 1, 1, 64)
    assert why is not None and "got 1" in why
    assert kernel_route("auto", torch.device("cuda"), inst.n, 1, 1, 64) == "dense"
    assert kernel_route("on", torch.device("cpu"), inst.n, 1, 1, 64) == "dense"
    runs = [tsb.sdp_relaxation_bound(inst, LPConfig(max_iters=200, use_kernel=uk),
                                     max_rounds=1, capacity=64, device="cpu")
            for uk in ("auto", "on", "off")]
    assert runs[0][:2] == runs[1][:2] == runs[2][:2]


def test_history_keeps_the_reference_keys_and_times():
    inst = generate_spar(12, 100, 3)
    _, _, hist = tsb.sdp_relaxation_bound(inst, LPConfig(max_iters=500, tol=2e-6),
                                          max_rounds=2, capacity=64, device="cpu",
                                          final_polish=True)
    _, _, jhist = jsb.sdp_relaxation_bound(jgenerate_spar(12, 100, 3),
                                           JLPConfig(max_iters=500, tol=2e-6),
                                           max_rounds=2, capacity=64, final_polish=True)
    assert [set(h) - {"seconds"} for h in hist] == [set(h) for h in jhist]
    assert set(hist[0]["seconds"]) == {"lp", "certificate", "purge", "host_cuts", "upload"}
    assert hist[-1]["polish"] and all(v >= 0 for h in hist for v in h["seconds"].values())


def test_validate_sdp_bound_sandwich_small():
    """tests/test_sdp_bound.py::test_sdp_bound_sandwich_small on the port."""
    ub, lb, rel = tsb.validate_sdp_bound(generate_spar(12, 100, 3),
                                         LPConfig(max_iters=8000, tol=2e-6),
                                         max_rounds=40, device="cpu")
    assert lb <= ub + 1e-9
    assert rel <= 1e-3, f"ub={ub} lb={lb} rel={rel}"


def test_with_point_returns_the_lp_point():
    inst = generate_spar(12, 100, 3)
    best, _, hist, (x, X) = tsb.sdp_relaxation_bound(
        inst, LPConfig(max_iters=1000, tol=2e-6), max_rounds=2, capacity=64,
        device="cpu", with_point=True)
    assert x.dtype == np.float64 and x.shape == (12,) and X.shape == (12, 12)
    lb = tsb.sdp_lower_bound(inst.Q, inst.c, x, X)
    assert lb <= best + 1e-9


def test_stop_below_and_stall():
    inst = generate_spar(12, 100, 3)
    kw = dict(max_rounds=8, capacity=64, device="cpu")
    lp = LPConfig(max_iters=1000, tol=2e-6)
    _, b0, hist = tsb.sdp_relaxation_bound(inst, lp, stop_below=1e9, **kw)
    assert len(hist) == 1
    _, _, hist = tsb.sdp_relaxation_bound(inst, lp, stall_rounds=1, stall_tol=1.0, **kw)
    assert len(hist) == 2
