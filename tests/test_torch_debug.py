"""Debug mode of the port (sdpcutsel_tpu_torch/utils/debug.py), mirroring
tests/test_debug.py: with debug=True a healthy run checks every round of
either solver and passes; a NaN or Inf state, a wrong shape or a non-finite
bound raises AssertionError; without debug no check runs."""

import pytest
import torch

from sdpcutsel_tpu_torch.config import CutConfig, LPConfig, RunConfig, ScorerConfig
from sdpcutsel_tpu_torch.instances import generate_spar, load_or_generate_qcqp
from sdpcutsel_tpu_torch.loop import CutSolver
from sdpcutsel_tpu_torch.loop import solver as loop_solver
from sdpcutsel_tpu_torch.qcqp import CutSolverQCQP
from sdpcutsel_tpu_torch.relax.cutbuffer import empty_pool
from sdpcutsel_tpu_torch.utils.debug import check_round_state

BOXQP_CFG = RunConfig(lp=LPConfig(max_iters=2000, tol=1e-5),
                      cuts=CutConfig(k=3, sel_size=4, capacity=64),
                      scorer=ScorerConfig(strategy="feasibility"), debug=True)


def _count_checks(monkeypatch, module) -> list:
    """The bounds that the solver module's check_round_state is called with."""
    bounds = []

    def check(x, X, pool, bound):
        bounds.append(bound)
        check_round_state(x, X, pool, bound)

    monkeypatch.setattr(module, "check_round_state", check)
    return bounds


def test_debug_mode_clean_boxqp_run(monkeypatch):
    """tests/test_debug.py's run: each of the 2 rounds is checked and passes."""
    checked = _count_checks(monkeypatch, loop_solver)
    hist = CutSolver(generate_spar(10, 100, 1), BOXQP_CFG, device="cpu").run(rounds=2)
    assert len(hist) == 2
    assert checked == [h.bound for h in hist]


def test_debug_mode_clean_qcqp_run(monkeypatch):
    # the QCQP solver runs the round loop of loop/solver.py's CheckpointableSolver
    checked = _count_checks(monkeypatch, loop_solver)
    cfg = RunConfig(lp=LPConfig(max_iters=1000, tol=1e-5),
                    cuts=CutConfig(k=3, sel_size=4, capacity=64), debug=True)
    hist = CutSolverQCQP(load_or_generate_qcqp("qcqp015-30-3-1"), cfg, device="cpu").run(rounds=2)
    assert len(hist) == 2
    assert checked == [h.bound for h in hist]


def test_no_check_without_debug(monkeypatch):
    checked = _count_checks(monkeypatch, loop_solver)
    cfg = RunConfig(lp=BOXQP_CFG.lp, cuts=BOXQP_CFG.cuts, scorer=BOXQP_CFG.scorer)
    assert len(CutSolver(generate_spar(10, 100, 1), cfg, device="cpu").run(rounds=2)) == 2
    assert checked == []


def test_debug_mode_stops_a_run_at_a_nan_bound(monkeypatch):
    monkeypatch.setattr(loop_solver, "dual_bound_f64", lambda *args, **kw: float("nan"))
    with pytest.raises(AssertionError, match="bound"):
        CutSolver(generate_spar(10, 100, 1), BOXQP_CFG, device="cpu").run(rounds=1)


def _state(n=6, M=8, k=3):
    return torch.zeros(n), torch.zeros(n, n), empty_pool(M, k, "cpu")


def test_check_round_state_passes_a_clean_state():
    check_round_state(*_state(), 1.0)


def _nan_x(x, X, pool):
    x[0] = float("nan")


def _inf_X(x, X, pool):
    X[1, 2] = float("inf")


def _nan_quad(x, X, pool):
    pool.quad[3, 0, 1] = float("nan")


def _inf_rhs(x, X, pool):
    pool.rhs[2] = -float("inf")


@pytest.mark.parametrize("spoil", [_nan_x, _inf_X, _nan_quad, _inf_rhs])
def test_check_round_state_catches_non_finite_state(spoil):
    x, X, pool = _state()
    spoil(x, X, pool)
    with pytest.raises(AssertionError, match="non-finite"):
        check_round_state(x, X, pool, 1.0)


@pytest.mark.parametrize("bound", [float("nan"), float("inf")])
def test_check_round_state_catches_non_finite_bound(bound):
    with pytest.raises(AssertionError, match="bound"):
        check_round_state(*_state(), bound)


def test_check_round_state_catches_shapes():
    x, X, pool = _state()
    with pytest.raises(AssertionError, match="rank"):
        check_round_state(X, X, pool, 1.0)
    with pytest.raises(AssertionError, match="X has shape"):
        check_round_state(x, X[:, :5], pool, 1.0)
    pool.quad = pool.quad[:, :2]
    with pytest.raises(AssertionError, match="pool.quad"):
        check_round_state(x, X, pool, 1.0)
