"""Any pool and any number of dense rows on the grid route (lp/pdhg_grid.py,
csrc/pdhg_grid.cuh): its far form, which keeps no replica of the cut
weights or of the dense rows' duals in shared memory and lets a CTA own
more than 512 pool slots, on the CPU.  The far form's layout and scratch
summed from the kernel source; a Python mirror of the slots a CTA's threads
walk past 512 a CTA; the routes that take every pool and every count of
dense rows up to n = 1024, and what is still refused; the wrappers'
launches in the far form, recorded by a stand-in library; the port's plain
block, checked block and norm through the grid wrappers at two past-limit
shapes against the JAX package; and CutSolver on spar020-100-1 at a pool
of 60,000 slots against the JAX package.  The kernels run only on the card
(chip_smoke.py phase 22 holds the far form to its twins and to the shared
form's bits there); torch runs on one thread here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpcutsel_tpu.loop import CutSolver as JaxCutSolver
from sdpcutsel_tpu.lp import pdhg as jpdhg
from sdpcutsel_tpu.relax import cutbuffer as jcb
from sdpcutsel_tpu.relax import denserows as jdr
from sdpcutsel_tpu_torch.config import CutConfig, LPConfig, RunConfig, ScorerConfig
from sdpcutsel_tpu_torch.instances import generate_spar, load_or_generate
from sdpcutsel_tpu_torch.loop import CutSolver
from sdpcutsel_tpu_torch.loop.sdp_bound import _seed_rows
from sdpcutsel_tpu_torch.lp import pdhg as tpdhg
from sdpcutsel_tpu_torch.lp import pdhg_dense as tdense
from sdpcutsel_tpu_torch.lp import pdhg_grid as tgrid
from sdpcutsel_tpu_torch.lp import pdhg_kernel as tkernel
from sdpcutsel_tpu_torch.lp.pdhg_kernel import (SMEM_MAX, kernel_route, plan_refusal,
                                                route_refusal, steps_record)
from sdpcutsel_tpu_torch.relax import cutbuffer as tcb
from sdpcutsel_tpu_torch.relax import denserows as tdr
from sdpcutsel_tpu_torch.relax.cutbuffer import build_cut_index
from test_torch_grid import (FIELDS, _checks_recorded, _fake_card, _grid_layout_words, _plain,
                             _pool_index, _slices, _work_expr)
from test_torch_portmods import reference_config
from test_torch_solver_k4 import EDGE

CUDA = torch.device("cuda")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's CPU threads share this process; torch's intra-op pool on top of
    them oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the far form's layout and scratch, summed from the kernel source -----------

@pytest.mark.parametrize("n", [12, 125, 150, 300, 512, 600, 1024])
@pytest.mark.parametrize("M,m", [(81920, 0), (1024, 6000), (32768, 25), (1, 23000), (60000, 0)])
def test_far_layout_matches_the_kernel_source(n, M, m):
    """block_words(..., far=True) is csrc/pdhg_grid.cuh's grid_layout in the
    far form: no replica of yD or of the weights, whatever M and m, so the
    slab takes their room and the layout fits a CTA; without dense rows it
    is the Slices, the scratch and the owned entries alone."""
    for cuts in (True, False):
        words = tgrid.block_words(n, M, m, cuts, True)
        assert words == _grid_layout_words(n, M, m, cuts, far=True)
        assert 4 * words <= SMEM_MAX
        assert words == tgrid.block_words(n, 1, m, cuts, True)      # M takes no room
    kmax, _, scratch, _, state = tgrid.FORMS[tkernel.columns(n)]
    if m == 0:
        assert tgrid.block_words(n, M, 0, True, True) == (tgrid._META + scratch
                                                           + (1 + state) * kmax)
    else:
        assert 4 * tgrid.block_words(n, M, m, True, True) == 4 * (SMEM_MAX // 4)


@pytest.mark.parametrize("n,m,M,P", [(125, 0, 81920, 132), (300, 6000, 1024, 132),
                                     (300, 7000, 1, 132), (600, 0, 49152, 130),
                                     (64, 23000, 1, 264)])
def test_far_work_matches_the_kernel_source(n, m, M, P):
    """work_words(..., far=True) is csrc/pdhg_grid.cuh's work_words in the far
    form, evaluated from the source: the checked form with cuts adds the
    average's weights (M), nothing else changes."""
    for cuts in (True, False):
        for checked in (True, False):
            names = dict(n=n, m=m, M=M, P=P, NN=n * n, Pm=P * m, cuts=cuts, far=True,
                         checked=checked, kNS=10, kND=6)
            far = tgrid.work_words(n, m, M, P, cuts, checked, True)
            assert far == eval(_work_expr("work_words"), {}, names)       # noqa: S307
            assert far - tgrid.work_words(n, m, M, P, cuts, checked) == (
                M if cuts and checked else 0)


@pytest.mark.parametrize("P", [132, 130, 264])
@pytest.mark.parametrize("n,M", [(125, 81920), (300, 32768), (600, 49152), (20, 60000)])
def test_every_slot_has_one_owner_past_512_a_cta(n, M, P):
    """In the far form thread t of CTA b walks slots s0 + t + 512 j of its
    slice [s0, s1): every pool slot has exactly one (CTA, thread, j), though
    a CTA owns more than 512 of them; every term of the cut index of 2,000
    active cuts has one owner (the segments of the owned entries)."""
    owner = np.zeros(M, int)
    most = 0
    for s0, s1 in _slices(M, P):
        for t in range(512):
            owner[s0 + t:s1:512] += 1
        most = max(most, s1 - s0)
    assert (owner == 1).all()
    assert most > 512 or M <= 512 * P
    index = _pool_index(n, M=M, live=2000)
    Xoff, xoff = index.Xoff.numpy(), index.xoff.numpy()
    terms_X, terms_x = np.zeros(int(Xoff[-1]), int), np.zeros(int(xoff[-1]), int)
    for (e0, e1), (i0, i1) in zip(_slices(n * n, P), _slices(n, P)):
        terms_X[Xoff[e0]:Xoff[e1]] += 1
        terms_x[xoff[i0]:xoff[i1]] += 1
    assert (terms_X == 1).all() and (terms_x == 1).all()


# ---- the routes: every pool and every count of dense rows up to n = 1024 ---------

@pytest.mark.parametrize("n,M,k,m", [(125, 81920, 3, 0), (300, 32768, 3, 0),
                                     (300, 1024, 5, 6000), (600, 49152, 3, 0),
                                     (150, 81920, 3, 0), (1024, 1 << 17, 5, 30000)])
def test_every_pool_and_row_count_takes_the_grid_route(n, M, k, m):
    """Pools and dense rows past the shared layout take the grid route, in
    its far form, under "auto" and "on" on CUDA; "off" stays plain, and
    "auto" on the CPU too."""
    assert plan_refusal(n, M, k, m) is not None
    assert 4 * tgrid.block_words(n, M, m, True) > SMEM_MAX
    assert tgrid.grid_refusal(n, M, k, m) is None and tgrid.grid_form(n, M, m, True)
    assert route_refusal(n, M, k, m) == ("grid", None)
    assert kernel_route("auto", CUDA, n, M, k, m) == "grid"
    assert kernel_route("on", CUDA, n, M, k, m) == "grid"
    assert kernel_route("off", CUDA, n, M, k, m) == "plain"
    assert kernel_route("auto", torch.device("cpu"), n, M, k, m) == "plain"


@pytest.mark.parametrize("n,m", [(300, 7000), (64, 23000), (12, 23000), (600, 20000)])
def test_the_certifier_past_its_shared_rows_takes_the_far_form(n, m):
    """The certifier's pool past K7's rows (n <= 256) and past the grid
    route's shared layout (n > 256) stays on the dense route, whose wrappers
    launch the grid route's far form without cuts."""
    assert m > tdense.max_dense_rows(n)
    assert route_refusal(n, 1, 1, m) == ("dense", None)
    assert kernel_route("auto", CUDA, n, 1, 1, m) == "dense"
    assert not tdense.k7_takes(n, m) and tgrid.grid_form(n, 1, m, False)
    assert tdense.smem_words(n, m) == tgrid.block_words(n, 1, m, False, True)
    assert "shared memory" in tdense.dense_refusal(n, 1, 1, m)
    assert tdense.dense_route_refusal(n, 1, 1, m) is None


@pytest.mark.parametrize("M,k,m", [(1024, 3, 0), (81920, 5, 6000), (1, 1, 23000)])
def test_only_n_and_k_are_refused(M, k, m):
    """n = 46,341 (and 0) is refused by every route, naming n <= 46340; cuts
    of width 6 by the grid route's k = 2..5; nothing else (n = 1025 and
    n = 2049 are taken)."""
    for n in (0, 46341):
        route, why = route_refusal(n, M, k, m)
        assert "n <= 46340" in why
        with pytest.raises(ValueError, match="n <= 46340"):
            kernel_route("auto", CUDA, n, M, k, m)
    assert route_refusal(1025, M, k, m)[1] is None
    assert route_refusal(2049, M, k, m)[1] is None
    if (M, k) != (1, 1):
        route, why = route_refusal(300, M, 6, m)
        assert route == "grid" and "k = 2..5" in why
        with pytest.raises(ValueError, match="k = 2..5"):
            kernel_route("on", CUDA, 300, M, 6, m)


# ---- the wrappers' launches in the far form, recorded by a stand-in library ------

def _problem(n, M, k, m, live=10, seed=0):
    rng = np.random.default_rng(seed)
    idx = np.sort(np.stack([rng.choice(n, k, replace=False) for _ in range(live)]), axis=1)
    pool = tcb.append_cuts(tcb.empty_pool(M, k, "cpu"), torch.as_tensor(idx),
                           torch.rand(live, k), torch.rand(live, k, k), torch.rand(live),
                           torch.ones(live))
    dense = None if m == 0 else tdr.DenseRows(torch.rand(m, n, n), torch.rand(m, n),
                                              torch.rand(m))
    return torch.rand(n), torch.rand(n, n), pool, tpdhg.init_state(n, M, "cpu", m), dense


@pytest.mark.parametrize("n,M,k,m", [(20, 60000, 3, 0), (12, 1024, 5, 18000)])
def test_far_launches_match_the_library(n, M, k, m, monkeypatch):
    """Past the shared layout the block, the checked launch and the norm
    marshal far = 1 last, the far layout's shared bytes and the far form's
    scratch; each counts its launch; forcing the form (``_far``) launches
    it at a shape the shared form takes."""
    lib = _fake_card(monkeypatch)
    cx, cX, pool, st, dense = _problem(n, M, k, m)
    index = build_cut_index(pool, n)
    acc, anc = st.map(torch.zeros_like), st.map(torch.clone)
    rec = steps_record([0.1], [0.1], "cpu")[0]
    smem = 4 * tgrid.block_words(n, M, m, True, True)
    tgrid._launch_block(cx, cX, pool, index, [st, acc], [st, acc], rec, 3, dense)
    tgrid._checked_launcher(cx, cX, pool, index, st, acc, anc, rec, 100, 500, 1000, 1e-6,
                            dense)()
    names = [c[0] for c in lib.calls]
    assert names == ["pdhg_grid_ctas", "pdhg_grid_block_launch", "pdhg_grid_ctas",
                     "pdhg_grid_block_checked_launch"]
    assert lib.calls[0][1][:8] == (n, M, k, m, tkernel.columns(n), 1, smem, 1)
    assert lib.calls[1][1][:8] == (n, M, k, m, 3, tkernel.columns(n), 1, smem)
    assert lib.calls[1][1][-1] == 1 and lib.calls[3][1][-1] == 1
    lib.calls.clear()
    small = _problem(n, 64, k, 5)
    sidx = build_cut_index(small[2], n)
    sacc = small[3].map(torch.zeros_like)
    tgrid._launch_block(small[0], small[1], small[2], sidx, [small[3], sacc], [small[3], sacc],
                        rec, 3, small[4], far=True)
    tgrid._launch_block(small[0], small[1], small[2], sidx, [small[3], sacc], [small[3], sacc],
                        rec, 3, small[4])
    assert [c[1][-1] for c in lib.calls if c[0] == "pdhg_grid_block_launch"] == [1, 0]
    assert lib.calls[1][1][7] == 4 * tgrid.block_words(n, 64, 5, True, True)
    assert lib.calls[3][1][7] == 4 * tgrid.block_words(n, 64, 5, True)


def test_far_form_where_a_cta_would_own_more_than_512_slots(monkeypatch):
    """On a grid of few CTAs a pool the shared layout holds still takes the
    far form once a CTA would own more than 512 slots (the kernel's own
    limit of the shared form), and the launch says so."""
    lib = _fake_card(monkeypatch)
    lib.P = 40
    n, M = 20, 30000
    assert not tgrid.grid_form(n, M, 0, True) and M > 512 * lib.P
    assert tgrid._form(n, M, 3, 0)[0] is True
    assert [c[1][7] for c in lib.calls] == [0, 1]
    lib.P = 132
    lib.calls.clear()
    assert tgrid._form(n, M, 3, 0)[0] is False
    assert [c[1][7] for c in lib.calls] == [0]


def test_dense_route_past_k7_launches_the_far_form_without_cuts(monkeypatch):
    """The certifier's rows past K7's limit at n = 12 launch the grid route's
    far form without cuts (cuts = 0, far = 1)."""
    lib = _fake_card(monkeypatch)
    n, m = 12, tdense.max_dense_rows(12) + 1
    pool = tcb.empty_pool(1, 1, "cpu")
    dense = tdr.DenseRows(torch.rand(m, n, n), torch.rand(m, n), torch.rand(m))
    st = tpdhg.init_state(n, 1, "cpu", m)
    acc = st.map(torch.zeros_like)
    rec = steps_record([0.1], [0.1], "cpu")[0]
    tgrid._launch_block(torch.rand(n), torch.rand(n, n), pool, build_cut_index(pool, n),
                        [st, acc], [st, acc], rec, 3, dense)
    args = lib.calls[-1][1]
    assert lib.calls[-1][0] == "pdhg_grid_block_launch"
    assert args[:8] == (n, 1, 1, m, 3, 128, 0, 4 * tdense.smem_words(n, m)) and args[-1] == 1


# ---- the port's plain loop at past-limit shapes against the JAX package ----------

def _big_case(n: int, k: int, M: int, live: int, m: int, seed: int = 11):
    """generate_spar(n, 100, 1)'s objective, a pool of M with ``live`` unit
    cuts of width k on random supports, m normalised rank-1 dense rows (the
    seed rows' form) and a random state, in both packages."""
    rng = np.random.default_rng(seed)
    inst = generate_spar(n, 100, 1)
    cX, cx = (-0.5 * inst.Q).astype(np.float32), (-inst.c).astype(np.float32)
    idx = np.stack([np.sort(rng.choice(n, k, replace=False)) for _ in range(live)])
    lin = rng.standard_normal((live, k))
    quad = rng.standard_normal((live, k, k))
    quad = 0.5 * (quad + quad.transpose(0, 2, 1))
    nrm = np.sqrt((lin ** 2).sum(1) + (quad ** 2).sum((1, 2)))
    cuts = (idx.astype(np.int32), (lin / nrm[:, None]).astype(np.float32),
            (quad / nrm[:, None, None]).astype(np.float32),
            (-0.1 * rng.random(live) / nrm).astype(np.float32), np.ones(live, np.float32))
    if m:
        V = rng.standard_normal((m, n + 1))
        rows = [a.astype(np.float32) for a in _seed_rows(V / np.linalg.norm(V, axis=1,
                                                                            keepdims=True))]
        jd = jdr.DenseRows(*(jnp.asarray(a) for a in rows))
        td = tdr.DenseRows(*(torch.as_tensor(a) for a in rows))
    else:
        jd, td = jdr.empty_dense(n, jnp.float32), None
    X = rng.random((n, n)).astype(np.float32)
    pt = dict(x=rng.random(n).astype(np.float32), X=0.5 * (X + X.T),
              yA=0.1 * rng.random((n, n)).astype(np.float32),
              yB=0.1 * rng.random((n, n)).astype(np.float32),
              yC=np.where(np.arange(M) < live, 0.05 * rng.random(M), 0.0).astype(np.float32),
              yD=(0.2 * rng.random(m)).astype(np.float32))
    jpool = jcb.append_cuts(jcb.empty_pool(M, k), *(jnp.asarray(a) for a in cuts))
    tpool = tcb.append_cuts(tcb.empty_pool(M, k, "cpu"), *(torch.as_tensor(a) for a in cuts))
    jst = jpdhg.PDHGState(**{f: jnp.asarray(a) for f, a in pt.items()})
    tst = tpdhg.PDHGState(**{f: torch.as_tensor(a) for f, a in pt.items()})
    return ((jnp.asarray(cx), jnp.asarray(cX), jpool, jd, jst),
            (torch.as_tensor(cx), torch.as_tensor(cX), tpool, td, tst))


# (n, k, M, active cuts, m): past the shared layout's pool, and past its rows
BIG = {"n=20 M=60000": (20, 3, 60000, 1000, 0), "n=12 k=5 m=18000": (12, 5, 1024, 400, 18000)}


@pytest.mark.parametrize("case", BIG)
def test_plain_block_at_past_limit_shapes_matches_the_reference(case):
    """30 iterations through the grid route's wrapper on the CPU (its twin)
    at shapes only the far form takes on the card, against the JAX package's
    _one_iter loop (its run_block past its kernel's shapes), state and
    ergodic sums at rtol = atol = 2e-5."""
    n, k, M, live, m = BIG[case]
    assert tgrid.grid_form(n, M, m, True) and route_refusal(n, M, k, m) == ("grid", None)
    (jcx, jcX, jpool, jd, jst), (tcx, tcX, tpool, td, tst) = _big_case(n, k, M, live, m)
    eta = 0.95 / float(jpdhg.estimate_norm(jpool, n, 30, jnp.float32, jd))

    def body(_, carry):
        s, a = carry
        s = jpdhg._one_iter(jcx, jcX, jpool, jd, n, s, eta, eta)
        return s, jax.tree.map(lambda u, v: u + v, a, s)

    ref, racc = jax.jit(lambda s: jax.lax.fori_loop(
        0, 30, body, (s, jax.tree.map(jnp.zeros_like, s))))(jst)
    st, acc = tgrid.pdhg_grid_block(tcx, tcX, tpool, build_cut_index(tpool, n), tst,
                                    tst.map(torch.zeros_like), eta, eta, 30, td)
    for name in FIELDS:
        for got, want in ((st, ref), (acc, racc)):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", BIG)
def test_checked_block_at_past_limit_shapes_matches_the_reference(case):
    """One checked block of 100 iterations through the grid route's wrapper
    on the CPU against the JAX package's checked_block (its _solve_impl run
    for one block) at the same normK, restart_period 100: the states at
    rtol/atol 2e-5, omega at rtol 1e-4, the iteration count equal."""
    n, k, M, live, m = BIG[case]
    (jcx, jcX, jpool, jd, jst), (cx, cX, pool, dense, tst) = _big_case(n, k, M, live, m, 13)
    normK = float(jpdhg.estimate_norm(jpool, n, 30, jnp.float32, jd))
    st_j, info_j = jpdhg._solve_impl(jcx, jcX, jpool, jd, jst, normK, 1.0, 1e-12, 1e-6, 0.95,
                                     100, 100, 100)
    st, anc, acc = tpdhg._buffers(tst)
    rec = tpdhg.new_record(normK, 1.0, 0.95, 100, 1e-12, "cpu")
    tgrid.pdhg_grid_block_checked(cx, cX, pool, build_cut_index(pool, n), st, acc, anc, rec, 100,
                                  100, 100, 1e-12, dense)
    f = tpdhg.record_floats(rec.numpy())
    assert int(rec[tpdhg.REC_IT]) == int(info_j["iters"]) == 100
    np.testing.assert_allclose(f[tpdhg.REC_OMEGA], float(info_j["omega"]), rtol=1e-4)
    for name in FIELDS:
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(st_j, name)),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", BIG)
def test_norm_at_past_limit_shapes_is_the_twin_and_near_the_reference(case):
    """The grid route's norm on the CPU is estimate_norm_plain bit for bit,
    and within 2% of the JAX package's estimate_norm (another start vector)."""
    n, k, M, live, m = BIG[case]
    (_, _, jpool, jd, _), (_, _, pool, dense, _) = _big_case(n, k, M, live, m)
    index = build_cut_index(pool, n)
    got = tgrid.pdhg_grid_norm(pool, n, 30, None, index, dense)
    assert torch.equal(got, tpdhg.estimate_norm_plain(pool, n, 30, None, index, dense))
    ref = float(jpdhg.estimate_norm(jpool, n, 30, jnp.float32, jd))
    np.testing.assert_allclose(float(got), ref, rtol=2e-2)


# ---- the slice: CutSolver with a pool of 60,000 slots against the JAX package -----

# every LP of the three rounds stops on its test inside EDGE (at 0.08, 0.34
# and 0.62 of tol, the checks before at 52, 10.7 and 2.2 times); neural's
# third LP at tol 2e-5 runs 18,400 iterations, and the looser tolerances
# that would take fewer put some stop within 20% of the edge
BIG_LP = LPConfig(max_iters=20000, tol=2e-5, use_kernel="on")
BIG_CAPACITY = 60000


def test_cut_solver_big_pool_matches_reference(monkeypatch):
    """Three feasibility rounds of the port's CutSolver on spar020-100-1 with
    a pool of 60,000 slots (past K2's and the grid route's shared layout: the
    far form on the card), through the grid route's wrappers ("on"; their
    twins on the CPU), against the JAX package's at the same capacity, rtol 2e-3 a
    round; round 0 with the same LP iterations and cuts; every LP of the
    port stops on its stop test before the cap, inside EDGE."""
    inst = load_or_generate("spar020-100-1", data_dir="data/boxqp")
    cfg = RunConfig(lp=BIG_LP, cuts=CutConfig(capacity=BIG_CAPACITY),
                    scorer=ScorerConfig(strategy="feasibility"))
    assert route_refusal(inst.n, BIG_CAPACITY, 3, 0) == ("grid", None)
    assert tgrid.grid_form(inst.n, BIG_CAPACITY, 0, True)
    ref = JaxCutSolver(inst, reference_config(_plain(cfg))).run(rounds=3)
    solves = _checks_recorded(monkeypatch)
    got = CutSolver(inst, cfg, device="cpu").run(rounds=3)
    assert len(got) == len(ref) == 3
    assert got[0].lp_iters == ref[0].lp_iters
    assert got[0].cuts_added == ref[0].cuts_added > 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.bound, r.bound, rtol=2e-3)
        assert g.lp_iters < BIG_LP.max_iters
    solves = [s for s in solves if s]
    assert len(solves) == 3
    for checks in solves:
        assert checks[-1] <= EDGE[0] * BIG_LP.tol
        assert len(checks) == 1 or checks[-2] >= EDGE[1] * BIG_LP.tol
