"""BoxQP at k = 4 through the port's CutSolver against the JAX package's, on
the CPU: the route that scores through K4 (ops/fused_score.py) on the card,
its twin here.  The same numpy-seeded instance goes through both packages
(``reference_config``), and every round's certified bound is held at the
reference's rtol 2e-3 (tests/test_loop.py), as
tests/test_torch_fused.py holds k = 2."""

import numpy as np
import pytest
import torch

from sdpcutsel_tpu.loop import CutSolver as JaxCutSolver
from sdpcutsel_tpu_torch.config import CutConfig, LPConfig, RunConfig, ScorerConfig
from sdpcutsel_tpu_torch.instances import load_or_generate
from sdpcutsel_tpu_torch.loop import CutSolver
from sdpcutsel_tpu_torch.lp import pdhg as tpdhg
from test_torch_portmods import reference_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's CPU threads share this process; torch's intra-op pool on top of
    them oversubscribes the cores (10x slower on these small tensors)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# Each strategy's LP settings on spar020-100-1 (C(20, 4) = 4,845 candidates),
# chosen so that every LP of the three rounds converges and stops well away
# from its stop test's edge, which the test checks on the port: the relative
# KKT error at the stopping check is at most EDGE[0] of tol and at the check
# before it at least EDGE[1] times tol (0.51 and 30 for neural, 0.71 and
# 1.69 for feasibility on the port at these settings).  Feasibility's LPs
# converge slowly at k = 4: at LPConfig(6000, 1e-5) its round 1 runs into
# the 6,000-iteration cap unconverged and the packages part by 1.7e-3
# there, and at tol 1e-4 its rounds stop at 0.92-0.96 of tol, on the edge,
# where f32 summation order alone moves the stop by a check (the case of
# ROADMAP Queue 3's generate_spar(12, 100, 2)).
SETTINGS = {"neural": LPConfig(max_iters=6000, tol=1e-5),
            "feasibility": LPConfig(max_iters=20000, tol=3e-5)}
EDGE = (0.8, 1.25)


def _record_checks(monkeypatch) -> list:
    """The port's LP solves on the CPU, as they run: for each solve the
    relative KKT error err / (1 + |p| + |d|) of each check, read from the
    control record after the twin check (pdhg_check_plain) has written it."""
    solves = [[]]
    real = tpdhg.pdhg_check_plain

    def recording(*args, **kw):
        rec = args[7]
        running = not int(rec[tpdhg.REC_STOP])
        real(*args, **kw)
        if running:
            r = rec.cpu().numpy()
            f = tpdhg.record_floats(r)
            solves[-1].append(float(f[tpdhg.REC_ERR])
                              / (1.0 + abs(float(f[tpdhg.REC_P])) + abs(float(f[tpdhg.REC_D]))))
            if r[tpdhg.REC_STOP]:
                solves.append([])

    monkeypatch.setattr(tpdhg, "pdhg_check_plain", recording)
    return solves


@pytest.mark.parametrize("strategy", ["neural", "feasibility"])
def test_cut_solver_k4_matches_reference(strategy, monkeypatch):
    """BoxQP with k = 4: three rounds of the port's solver against the JAX
    solver's, per round at rtol 2e-3; round 0 with the same LP iterations
    and cuts; the bounds fall round by round; every LP of the port stops
    inside EDGE, away from its stop test's edge."""
    inst = load_or_generate("spar020-100-1", data_dir="data/boxqp")
    lp = SETTINGS[strategy]
    cfg = RunConfig(lp=lp, cuts=CutConfig(k=4), scorer=ScorerConfig(strategy=strategy))
    ref = JaxCutSolver(inst, reference_config(cfg)).run(rounds=3)
    solves = _record_checks(monkeypatch)
    got = CutSolver(inst, cfg, device="cpu").run(rounds=3)
    assert len(got) == len(ref) == 3
    assert got[0].lp_iters == ref[0].lp_iters
    assert got[0].cuts_added == ref[0].cuts_added > 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.bound, r.bound, rtol=2e-3)
    bounds = [s.bound for s in got]
    assert all(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:]))
    solves = [s for s in solves if s]
    assert len(solves) == 3
    for checks in solves:
        assert checks[-1] <= EDGE[0] * lp.tol
        assert len(checks) == 1 or checks[-2] >= EDGE[1] * lp.tol


# k = 5 (ROADMAP Queue 3): CutConfig(k=5, sel_size=10) on spar020-100-1
# (C(20, 5) = 15,504 candidates).  At the k = 4 SETTINGS neural's round 2
# runs into its 6,000-iteration cap unconverged (43.5 times tol at the cap);
# at tol 3e-5 every neural LP stops on its test (at 0.05-0.44 of tol, the
# check before at 5.5-35 times), and feasibility's round 1 stops at 0.997 of
# tol there, on the edge, so it takes tol 1e-5 (0.10-0.50 of tol, the check
# before at 5.0-104 times).
SETTINGS_K5 = {"neural": LPConfig(max_iters=20000, tol=3e-5),
               "feasibility": LPConfig(max_iters=20000, tol=1e-5)}


@pytest.mark.parametrize("strategy", ["neural", "feasibility"])
def test_cut_solver_k5_matches_reference(strategy, monkeypatch):
    """BoxQP with k = 5: three rounds of the port's solver (K4's twin scores
    the 5-subsets) against the JAX solver's, per round at rtol 2e-3; round 0
    with the same LP iterations and cuts; the bounds fall round by round;
    every LP of the port stops inside EDGE, before its cap."""
    inst = load_or_generate("spar020-100-1", data_dir="data/boxqp")
    lp = SETTINGS_K5[strategy]
    cfg = RunConfig(lp=lp, cuts=CutConfig(k=5, sel_size=10),
                    scorer=ScorerConfig(strategy=strategy))
    ref = JaxCutSolver(inst, reference_config(cfg)).run(rounds=3)
    solves = _record_checks(monkeypatch)
    got = CutSolver(inst, cfg, device="cpu").run(rounds=3)
    assert len(got) == len(ref) == 3
    assert got[0].lp_iters == ref[0].lp_iters
    assert got[0].cuts_added == ref[0].cuts_added > 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.bound, r.bound, rtol=2e-3)
        assert g.lp_iters < lp.max_iters
    bounds = [s.bound for s in got]
    assert all(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:]))
    solves = [s for s in solves if s]
    assert len(solves) == 3
    for checks in solves:
        assert checks[-1] <= EDGE[0] * lp.tol
        assert len(checks) == 1 or checks[-2] >= EDGE[1] * lp.tol
