"""The port's selection strategies on the QCQP round controller, on the
CPU: feasibility, optimality and triangle match sdpcutsel_tpu's per-round
certified bounds at rtol 2e-3 where the LPs converge; ``random`` repeats
from its seed; scan mode repeats a per-round run bit for bit with random
draws and with vertex steering (the checks of tests/test_torch_strategies.py)."""

import pytest
import torch

from sdpcutsel_tpu.qcqp.solver import CutSolverQCQP as JaxCutSolverQCQP
from sdpcutsel_tpu_torch.config import CutConfig, LPConfig, RunConfig, ScorerConfig
from sdpcutsel_tpu_torch.instances.qcqp import load_or_generate_qcqp
from sdpcutsel_tpu_torch.qcqp import CutSolverQCQP
from test_torch_portmods import reference_config
from test_torch_strategies import (_assert_bounds_match, _qcqp, check_random_repeats,
                                   check_scan_repeats_per_round_run, check_score_fn_hook,
                                   check_steering_scores_at_the_steered_point)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("strategy", ["feasibility", "optimality", "triangle"])
def test_qcqp_strategy_matches_reference(strategy):
    """qcqp015-30-3-1 at k = 3: every LP converges within the cap."""
    inst = load_or_generate_qcqp("qcqp015-30-3-1")
    cfg = RunConfig(lp=LPConfig(max_iters=6000, tol=1e-5),
                    cuts=CutConfig(k=3, sel_size=8, capacity=128),
                    scorer=ScorerConfig(strategy=strategy))
    ref = JaxCutSolverQCQP(inst, reference_config(cfg)).run(rounds=3)
    got = CutSolverQCQP(inst, cfg, "cpu").run(rounds=3)
    assert all(h.lp_iters < 6000 for h in got)
    _assert_bounds_match(got, ref)


def test_random_repeats_from_its_seed():
    check_random_repeats(_qcqp)


@pytest.mark.parametrize("steer_eps", [0.0, 1e-3])
def test_scan_repeats_per_round_run(steer_eps):
    check_scan_repeats_per_round_run(_qcqp, steer_eps)


def test_steering_scores_at_the_steered_point(monkeypatch):
    check_steering_scores_at_the_steered_point(_qcqp, monkeypatch)


def test_score_fn_hook():
    check_score_fn_hook(_qcqp)
