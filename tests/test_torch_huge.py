"""The grid route's 1024-column form (csrc/pdhg_grid.cu, GridForm<kHuge>:
512 < n <= 1024, the owned state in global memory) on the CPU: a batch's
set-up and solve on the route at n = 600, the scoring kernels' 32-bit
offset rule, the port's plain block, checked block and power iteration at
n = 520 against the JAX package, and two rounds of CutSolver at n = 520
against the JAX package's.  Its routes, layouts and launches are
tests/test_torch_grid.py's cases at n > 512.  The kernels run only on the
card (chip_smoke.py phase 21 holds them to their twins there); torch runs
on one thread here."""

from math import comb

import numpy as np
import pytest
import torch

from sdpcutsel_tpu.loop import CutSolver as JaxCutSolver
from sdpcutsel_tpu_torch.config import CutConfig, LPConfig, RunConfig
from sdpcutsel_tpu_torch.instances import generate_spar
from sdpcutsel_tpu_torch.loop import CutSolver
from sdpcutsel_tpu_torch.lp import pdhg as tpdhg
from sdpcutsel_tpu_torch.lp import pdhg_grid as tgrid
from sdpcutsel_tpu_torch.lp.pdhg_kernel import route_refusal
from sdpcutsel_tpu_torch.ops.fused_score import OFFSET_LIMIT, offset_refusal
from sdpcutsel_tpu_torch.relax import batched as rb
import test_torch_grid
from test_torch_grid import _checks_recorded, _plain
from test_torch_portmods import reference_config
from test_torch_solver_k4 import EDGE

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's CPU threads share this process; torch's intra-op pool on top of
    them oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the batched route at n = 600 -----------------------------------------------

def test_batched_setup_and_solve_take_the_grid_route_at_n600(monkeypatch):
    """solve_setup_batched and _solve_batched take "grid" at n = 600: the
    batched norm and checked step are the grid wrappers' (their twins on the
    CPU)."""
    calls = []
    real = tgrid.grid_checked_step

    def counted(*args, **kw):
        calls.append(kw.get("batched"))
        return real(*args, **kw)

    monkeypatch.setattr(tgrid, "grid_checked_step", counted)
    n, B, cap = 600, 2, 16
    insts = [generate_spar(n, 100, s + 1) for s in range(B)]
    c = torch.as_tensor(np.stack([i.c for i in insts]), dtype=torch.float32)
    Q = torch.as_tensor(np.stack([i.Q for i in insts]), dtype=torch.float32)
    pool = rb.empty_pool(B, cap, 3, "cpu")
    cfg = LPConfig(max_iters=100, tol=1e-12, use_kernel="on")
    setup = tpdhg.solve_setup_batched(c, pool, cfg)
    assert setup.route == "grid" and setup.normK.shape == (B,)
    st = rb.stack([tpdhg.init_state(n, cap, "cpu") for _ in range(B)])
    _, info = tpdhg._solve_batched(-c, -0.5 * Q, pool, setup.index, st, setup.normK, cfg.omega0,
                                   cfg.tol, cfg.step_scale, cfg.max_iters, cfg.check_every,
                                   cfg.restart_period, None, setup.route)
    assert calls == [True] and (np.asarray(info["iters"]) == 100).all()


# ---- the scoring kernels' 32-bit offsets -----------------------------------------

def test_scoring_offsets_refuse_past_2_31():
    """K1 takes all C(1024, 3) triples (3 words a candidate) and refuses from
    n = 1627 on, where 3 C(n, 3) reaches 2^31; K4's widest array is triQ,
    k (k + 1) / 2 words a candidate; nothing below the limit is refused."""
    assert offset_refusal("pair_score", comb(1024, 3), 3) is None
    assert offset_refusal("pair_score", comb(1626, 3), 3) is None
    why = offset_refusal("pair_score", comb(1627, 3), 3)
    assert why is not None and "2^31" in why and "pair_score" in why
    assert offset_refusal("fused_score", OFFSET_LIMIT // 15, 15) is None
    assert offset_refusal("fused_score", OFFSET_LIMIT // 15 + 1, 15) is not None
    assert offset_refusal("pair_packed", OFFSET_LIMIT - 1, 1) is None
    assert offset_refusal("pair_packed", OFFSET_LIMIT, 1) is not None


# ---- the port's plain loop at n = 520 against the JAX package ---------------------

HUGE_CASE = {"n=520 k=3": (520, 3, 0)}


@pytest.fixture
def _huge_cases(monkeypatch):
    monkeypatch.setattr(test_torch_grid, "CASES", HUGE_CASE)


@pytest.mark.parametrize("case", HUGE_CASE)
def test_plain_block_at_n520_matches_the_reference(case, _huge_cases):
    """30 iterations through the grid wrapper's twin at n = 520 against the
    JAX package's _one_iter loop, rtol = atol = 2e-5."""
    test_torch_grid.test_plain_block_matches_the_reference(case)


@pytest.mark.parametrize("case", HUGE_CASE)
def test_checked_block_at_n520_matches_the_reference(case, _huge_cases):
    """One checked block through the grid wrapper's twin at n = 520 against
    the JAX package's checked_block, states at rtol/atol 2e-5."""
    test_torch_grid.test_checked_block_matches_the_reference_checked_block(case)


@pytest.mark.parametrize("case", HUGE_CASE)
def test_norm_at_n520_is_the_twin_and_near_the_reference(case, _huge_cases):
    """The grid wrapper's norm at n = 520 is estimate_norm_plain bit for bit
    and within 2% of the JAX package's."""
    test_torch_grid.test_norm_on_the_cpu_is_the_twin_and_near_the_reference(case)


# ---- the slice: CutSolver at n = 520 against the JAX package ------------------------

# k = 2 keeps the candidate table at C(520, 2) = 134,940 rows; LP settings
# whose stops sit inside EDGE (tests/test_torch_solver_k4.py)
HUGE_CFG = RunConfig(lp=LPConfig(max_iters=20000, tol=2e-5, use_kernel="on"),
                     cuts=CutConfig(k=2))


def test_cut_solver_n520_matches_reference(monkeypatch):
    """Two rounds of the port's CutSolver on generate_spar(520, 100, 1) at
    k = 2 through the grid route's wrappers ("on"; their twins on the CPU),
    against the JAX package's at rtol 2e-3 per round; round 0 with the same
    LP iterations and cuts; every LP of the port stops on its stop test
    before the cap, inside EDGE."""
    inst = generate_spar(520, 100, 1)
    assert route_refusal(520, HUGE_CFG.cuts.capacity, 2, 0) == ("grid", None)
    ref = JaxCutSolver(inst, reference_config(_plain(HUGE_CFG))).run(rounds=2)
    solves = _checks_recorded(monkeypatch)
    got = CutSolver(inst, HUGE_CFG, device="cpu").run(rounds=2)
    assert len(got) == len(ref) == 2
    assert got[0].lp_iters == ref[0].lp_iters
    assert got[0].cuts_added == ref[0].cuts_added > 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.bound, r.bound, rtol=2e-3)
        assert g.lp_iters < HUGE_CFG.lp.max_iters
    solves = [s for s in solves if s]
    assert len(solves) == 2
    for checks in solves:
        assert checks[-1] <= EDGE[0] * HUGE_CFG.lp.tol
        assert len(checks) == 1 or checks[-2] >= EDGE[1] * HUGE_CFG.lp.tol
