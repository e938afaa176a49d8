"""The kernels' 256-column form (n <= 256 on the card) on the CPU: the launch
plans at 128 < n <= 256 (lp/pdhg_kernel.py, lp/pdhg_norm.py,
lp/pdhg_dense.py), the refusal past n = 256, the narrow layouts held word
for word to the formulas they had before the wide form (copied here), the
route a solve takes at n = 150 and 256, and the port's plain PDHG block,
power iteration and two rounds of CutSolver at n > 128 against the JAX
package, whose accelerator path runs its plain loop there.  The kernels
themselves run only on the card (chip_smoke.py phase 18 holds them to
their twins there); torch runs on one thread here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpcutsel_tpu.loop import CutSolver as JaxCutSolver
from sdpcutsel_tpu.lp import pdhg as jpdhg
from sdpcutsel_tpu.relax import cutbuffer as jcb
from sdpcutsel_tpu.relax.denserows import empty_dense
from sdpcutsel_tpu_torch.config import LPConfig, RunConfig
from sdpcutsel_tpu_torch.instances import generate_spar
from sdpcutsel_tpu_torch.loop import CutSolver
from sdpcutsel_tpu_torch.lp import pdhg as tpdhg
from sdpcutsel_tpu_torch.lp import pdhg_dense as tdense
from sdpcutsel_tpu_torch.lp import pdhg_kernel as tkernel
from sdpcutsel_tpu_torch.lp import pdhg_norm as tnorm
from sdpcutsel_tpu_torch.lp.pdhg_kernel import (SMEM_MAX, kernel_route, launch_plan,
                                                pdhg_block_plain, plan_refusal, route_refusal)
from sdpcutsel_tpu_torch.relax import cutbuffer as tcb
from sdpcutsel_tpu_torch.relax.cutbuffer import build_cut_index
from test_torch_portmods import reference_config
from test_torch_solver_k4 import EDGE, _record_checks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's CPU threads share this process; torch's intra-op pool on top of
    them oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CUDA = torch.device("cuda")


# ---- the launch plans past n = 128 -------------------------------------------

@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("n", [129, 150, 200, 256])
def test_wide_launch_plan_takes_256_columns(n, k):
    """Past n = 128 K2's plan (both forms) takes the 256-column width, fits
    a CTA's shared memory with room for cut-index terms, covers every row
    once, and holds the main paths' pool of 1024; K6's layout fits beside it."""
    for checked in (False, True):
        plan = launch_plan(n, 1024, k, 0, checked=checked)
        assert plan.cols == 256 and plan.cluster == 16
        assert plan.smem_bytes <= SMEM_MAX and plan.term_cap > 0
        assert plan.max_capacity >= 1024
        rows = [i for start, stop in plan.bands(n) for i in range(start, stop)]
        assert rows == list(range(n))
    words, _, staged = tnorm.smem_words(n, 1024, k, 0)
    assert 4 * words <= SMEM_MAX and staged


def test_wide_plan_at_n256_holds_the_issues_figures():
    """n = 256, M = 1024, k = 3, m = 0: bands of R = 16 rows (4,096 floats),
    ~48,400 words before the cut-index terms, room for ~4,900 of them."""
    plan = launch_plan(256, 1024, 3, 0, checked=True)
    assert plan.rows == 16
    words = tkernel._smem_words(256, 1024, 3, 0, 16, checked=True)
    assert 48_000 <= words <= 48_800
    assert 4_700 <= plan.term_cap <= 5_000
    assert launch_plan(256, 2048, 5, 0).smem_bytes <= SMEM_MAX


@pytest.mark.parametrize("n,most", [(150, 25), (200, 10), (256, 2)])
def test_wide_plan_takes_few_dense_rows(n, most):
    """Dense rows fit only thinly past n = 128 (their bands take R n words a
    row): the plan's max_dense at M = 1024, k = 3, and one more is refused
    with the shared-memory reason."""
    plan = launch_plan(n, 1024, 3, 0)
    assert plan.max_dense == most
    assert "shared memory" in plan_refusal(n, 1024, 3, plan.max_dense + 1)


def test_n257_is_refused():
    """K2's cluster refuses n = 257 (the grid route takes it, and the dense
    route its certifier's pool); past n = 46,340 the dense route refuses
    too, and n = 1025 and 2049 are taken."""
    why = plan_refusal(257, 1024, 3, 0)
    assert "n <= 256" in why
    with pytest.raises(ValueError, match="n <= 256"):
        launch_plan(257, 1024, 3, 0)
    assert tdense.dense_refusal(257, 1, 1, 368) is None
    assert tdense.dense_refusal(513, 1, 1, 368) is None
    assert tdense.dense_refusal(1025, 1, 1, 368) is None
    assert "n <= 46340" in tdense.dense_refusal(46341, 1, 1, 368)
    assert tdense.dense_refusal(2049, 1, 1, 368) is None


@pytest.mark.parametrize("n", [150, 256])
def test_wide_routes_on_cuda(n):
    """At n = 150 and 256 "auto" on CUDA takes K2 for a pool of cuts and the
    dense route for the certifier's pool (up to the full 2048-row buffer);
    "off" stays plain."""
    assert route_refusal(n, 1024, 3, 0) == ("k2", None)
    assert kernel_route("auto", CUDA, n, 1024, 3, 0) == "k2"
    for m in (368, 2048):
        assert route_refusal(n, 1, 1, m) == ("dense", None)
        assert kernel_route("auto", CUDA, n, 1, 1, m) == "dense"
    assert kernel_route("off", CUDA, n, 1024, 3, 0) == "plain"
    assert tdense.block_plan(n, 2048) == "grid"
    assert tdense.max_dense_rows(n) >= 4 * 2048
    assert tdense.max_entries(n) == tdense._MAX_E_WIDE


def test_dense_grid_owns_every_entry_at_n256():
    """At n = 256 on the H100's 132 CTAs a CTA owns at most 497 + 2 entries
    of X and x: within the wide form's kMaxE, and its rows' spans within 128
    chunks of 4 floats; the narrow form's kMaxE would not take them."""
    P, n = 132, 256
    worst = max(((n * n * (b + 1)) // P - (n * n * b) // P) + ((n * (b + 1)) // P - (n * b) // P)
                for b in range(P))
    assert worst <= tdense._MAX_E_WIDE and worst > tdense._MAX_E
    assert tdense._MAX_E_WIDE + 12 <= 4 * 128


# ---- the narrow layouts, word for word ------------------------------------------

def _parent_k2_words(n, M, k, m, C, checked):
    """lp/pdhg_kernel.py::_smem_words as it was before the wide form."""
    R, Mc = -(-n // C), -(-M // C)
    RN = R * n
    check = C * 2 * 8 + C * 6 + (512 // 32) * 2 * 8 + 2 * 8 + 6 + 8
    return (10 * RN + 2 * R * 4 + C * 4 * R + 3 * R + 128 + M + Mc * (4 + 2 * k + k * k)
            + m * RN + m * R + 3 * m + C * m + RN + 1 + R + 1
            + (check if checked and RN < check else 0))


def _parent_norm_words(n, M, k, m, C):
    """lp/pdhg_norm.py::smem_words as it was before the wide form."""
    R, Mc = -(-n // C), -(-M // C)
    RN = R * n
    base = 4 * RN + 2 * R * 4 + C * 4 * R + 128 + R + M + C * m + m + C * 4 + 32 + 4
    words = SMEM_MAX // 4
    resident = m > 0 and base + m * (RN + R) <= words
    o = base + (m * (RN + R) if resident else 0)
    staged = o + Mc * (1 + 2 * k + 2 * k * k) + (RN + 1) + (R + 1) <= words
    if staged:
        o += Mc * (1 + 2 * k + 2 * k * k) + (RN + 1) + (R + 1)
        o += 2 * ((words - o) // 2)
    return o, resident, staged


def _parent_dense_words(plan, n, m):
    """lp/pdhg_dense.py::_block_words as it was before the wide form."""
    V4 = (n * n + n + 3) & ~3
    if plan == "cta":
        return m * V4 + 8 * n * n + 2 * V4 + 3 * n + 4 * m + 4 * 512
    rest = 2048 + m + 496
    return max((SMEM_MAX // 4 - rest) & ~3, 4 * 8192) + rest


def _parent_max_dense_rows(n):
    def words(m):
        cta = n <= 32 and 4 * _parent_dense_words("cta", n, m) <= SMEM_MAX
        return _parent_dense_words("cta" if cta else "grid", n, m)

    lo, hi = 0, 1 << 20
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if 4 * words(mid) <= SMEM_MAX else (lo, mid - 1)
    return lo


# the pools, widths and dense rows the existing tests take
NARROW_MS = (40, 64, 1024, 2048, 13808, 40000)
NARROW_DENSE = (0, 1, 3, 25, 200)


@pytest.mark.parametrize("checked", [False, True])
def test_narrow_k2_layout_is_the_parents(checked):
    for n in range(1, 129):
        assert tkernel.columns(n) == 128
        for M in NARROW_MS:
            for k in (2, 3, 4, 5):
                for m in NARROW_DENSE:
                    for C in (8, 16):
                        assert (tkernel._smem_words(n, M, k, m, C, checked)
                                == _parent_k2_words(n, M, k, m, C, checked)), (n, M, k, m, C)


def test_narrow_norm_layout_is_the_parents():
    for n in range(1, 129):
        for M in NARROW_MS:
            for k in (2, 3, 4, 5):
                for m in NARROW_DENSE:
                    assert tnorm.smem_words(n, M, k, m) == _parent_norm_words(n, M, k, m, 16)


def test_narrow_dense_layout_is_the_parents():
    for n in range(1, 129):
        assert tdense.max_entries(n) == tdense._MAX_E == 496
        for m in (0, 1, 40, 368, 2048):
            for plan in ("cta", "grid"):
                assert tdense._block_words(plan, n, m) == _parent_dense_words(plan, n, m)
        assert tdense.max_dense_rows(n) == _parent_max_dense_rows(n), n


# ---- the port's plain loop at n > 128 against the JAX package -----------------

def _wide_setup(n=130, M=64, k=3, seed=7):
    """A pool of k = 3 unit cuts on distinct random supports (some rows
    inactive) and a random state, in both packages."""
    rng = np.random.default_rng(seed)
    inst = generate_spar(n, 100, 1)
    cX, cx = (-0.5 * inst.Q).astype(np.float32), (-inst.c).astype(np.float32)
    live = M - 8
    idx = np.stack([np.sort(rng.choice(n, k, replace=False)) for _ in range(live)])
    lin = rng.standard_normal((live, k))
    quad = rng.standard_normal((live, k, k))
    quad = 0.5 * (quad + quad.transpose(0, 2, 1))
    nrm = np.sqrt((lin ** 2).sum(1) + (quad ** 2).sum((1, 2)))
    cuts = (idx.astype(np.int32), (lin / nrm[:, None]).astype(np.float32),
            (quad / nrm[:, None, None]).astype(np.float32),
            (-0.1 * rng.random(live) / nrm).astype(np.float32), np.ones(live, np.float32))
    x = rng.random(n).astype(np.float32)
    X = rng.random((n, n)).astype(np.float32)
    X = 0.5 * (X + X.T)
    yA = 0.1 * rng.random((n, n)).astype(np.float32)
    yB = 0.1 * rng.random((n, n)).astype(np.float32)
    yC = (0.05 * rng.random(M)).astype(np.float32)
    yC[live:] = 0.0
    jpool = jcb.append_cuts(jcb.empty_pool(M, k), *(jnp.asarray(a) for a in cuts))
    jst = jpdhg.init_state(n, M, 0)._replace(x=jnp.asarray(x), X=jnp.asarray(X),
                                             yA=jnp.asarray(yA), yB=jnp.asarray(yB),
                                             yC=jnp.asarray(yC))
    tpool = tcb.append_cuts(tcb.empty_pool(M, k, "cpu"), *(torch.as_tensor(a) for a in cuts))
    tst = tpdhg.init_state(n, M, "cpu")
    tst.x, tst.X, tst.yA, tst.yB, tst.yC = (torch.as_tensor(a) for a in (x, X, yA, yB, yC))
    return (jnp.asarray(cx), jnp.asarray(cX), jpool, jst,
            torch.as_tensor(cx), torch.as_tensor(cX), tpool, tst)


def test_plain_block_at_n130_matches_the_reference():
    """50 iterations of the port's pdhg_block_plain at n = 130 with a pool
    of k = 3 cuts against the JAX package's _one_iter loop (the XLA loop its
    solve runs past its kernel's n <= 128), state and ergodic sums at
    rtol = atol = 2e-5."""
    n, iters = 130, 50
    jcx, jcX, jpool, jst, tcx, tcX, tpool, tst = _wide_setup(n)
    eta = 0.95 / float(jpdhg.estimate_norm(jpool, n, 30))
    dense = empty_dense(n, jnp.float32)

    def body(_, carry):
        s, a = carry
        s = jpdhg._one_iter(jcx, jcX, jpool, dense, n, s, eta, eta)
        return s, jax.tree.map(lambda u, v: u + v, a, s)

    ref, racc = jax.jit(lambda s: jax.lax.fori_loop(
        0, iters, body, (s, jax.tree.map(jnp.zeros_like, s))))(jst)
    st, acc = pdhg_block_plain(tcx, tcX, tpool, build_cut_index(tpool, n), tst,
                               tst.map(torch.zeros_like), eta, eta, iters)
    for got, want in zip((*st.fields()[:5], *acc.fields()[:5]),
                         (ref.x, ref.X, ref.yA, ref.yB, ref.yC,
                          racc.x, racc.X, racc.yA, racc.yB, racc.yC)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_power_iteration_at_n130_close_to_the_reference():
    """The port's estimate_norm_plain at n = 130 against the JAX package's
    estimate_norm: different start vectors (jax.random against a seeded
    torch.Generator), both approaching ||K|| from below, so 2% as at n = 21
    (tests/test_torch_pdhg.py)."""
    n = 130
    *_, jpool, _, _, _, tpool, _ = _wide_setup(n)
    nj = float(jpdhg.estimate_norm(jpool, n, 30))
    nt = float(tpdhg.estimate_norm_plain(tpool, n, 30, None, build_cut_index(tpool, n)))
    np.testing.assert_allclose(nt, nj, rtol=2e-2)


# LPConfig of the parity run at n = 129: every LP of both rounds stops on its
# stop test, inside EDGE (tests/test_torch_solver_k4.py), before its cap (the
# port's stopping checks at 0.18 and 0.62 of tol, the checks before them at
# 583 and 773 times tol; at tol 1e-4 round 1 stops at 0.97 of tol, on the edge)
WIDE_LP = LPConfig(max_iters=20000, tol=3e-5)


def test_cut_solver_n129_matches_reference(monkeypatch):
    """Two rounds of the port's CutSolver on generate_spar(129, 100, 1), past
    the narrow width, against the JAX package's at rtol 2e-3 per round;
    round 0 with the same LP iterations and cuts; every LP of the port
    stops on its stop test before the cap, inside EDGE."""
    inst = generate_spar(129, 100, 1)
    cfg = RunConfig(lp=WIDE_LP)
    ref = JaxCutSolver(inst, reference_config(cfg)).run(rounds=2)
    solves = _record_checks(monkeypatch)
    got = CutSolver(inst, cfg, device="cpu").run(rounds=2)
    assert len(got) == len(ref) == 2
    assert got[0].lp_iters == ref[0].lp_iters
    assert got[0].cuts_added == ref[0].cuts_added > 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.bound, r.bound, rtol=2e-3)
        assert g.lp_iters < WIDE_LP.max_iters and r.lp_iters < WIDE_LP.max_iters
    solves = [s for s in solves if s]
    assert len(solves) == 2
    for checks in solves:
        assert checks[-1] <= EDGE[0] * WIDE_LP.tol
        assert len(checks) == 1 or checks[-2] >= EDGE[1] * WIDE_LP.tol
