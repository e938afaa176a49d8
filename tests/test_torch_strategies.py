"""The port's selection strategies on the BoxQP round controller, on the
CPU: every one of the reference's six lowers the bound
(tests/test_strategies.py); triangle and optimality match sdpcutsel_tpu's
per-round certified bounds at rtol 2e-3 (tests/test_loop.py's tolerance);
``random`` repeats bit for bit from its seed (its stream is a CPU
torch.Generator's, not jax.random's, so it is held to repeatability and
validity only); and scan mode repeats a per-round run bit for bit with
random draws and with vertex steering.  The ``check_*`` helpers serve the
QCQP solver's file, tests/test_torch_strategies_qcqp.py."""

import dataclasses

import numpy as np
import pytest
import torch

from sdpcutsel_tpu.loop import CutSolver as JaxCutSolver
from sdpcutsel_tpu_torch.config import CutConfig, LoopConfig, LPConfig, RunConfig, ScorerConfig
from sdpcutsel_tpu_torch.cuts.eigen import feasibility_scores_from_point
from sdpcutsel_tpu_torch.instances import generate_spar, load_or_generate
from sdpcutsel_tpu_torch.instances.qcqp import load_or_generate_qcqp
from sdpcutsel_tpu_torch.loop import CutSolver
from sdpcutsel_tpu_torch.loop.solver import STRATEGIES
from sdpcutsel_tpu_torch.qcqp import CutSolverQCQP
from test_torch_portmods import reference_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _outcome(hist):
    return [(h.bound, h.certificate, h.lp_iters, h.lp_kkt_error, h.cuts_added,
             h.cuts_active) for h in hist]


def _assert_bounds_match(got, ref, rtol=2e-3):
    assert len(got) == len(ref)
    assert got[0].cuts_added == ref[0].cuts_added > 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.bound, r.bound, rtol=rtol)
    assert [h.bound for h in got] == list(np.minimum.accumulate([h.certificate for h in got]))


def test_every_reference_strategy_is_ported():
    assert sorted(STRATEGIES) == sorted(
        ["feasibility", "neural", "random", "combined", "optimality", "triangle"])


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_improves_bound(strategy):
    inst = generate_spar(12, 100, 3)
    cfg = RunConfig(lp=LPConfig(max_iters=6000, tol=1e-5),
                    cuts=CutConfig(k=3, sel_size=10, capacity=128),
                    scorer=ScorerConfig(strategy=strategy))
    hist = CutSolver(inst, cfg, device="cpu").run(rounds=2)
    assert hist[0].cuts_added > 0
    bounds = [h.bound for h in hist]
    assert bounds[-1] < bounds[0] - 1e-4
    assert all(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("name,strategy,rounds", [
    ("spar020-100-1", "triangle", 3), ("spar030-100-1", "triangle", 3),
    ("spar020-100-1", "optimality", 2), ("spar030-100-1", "optimality", 2)])
def test_boxqp_strategy_matches_reference(name, strategy, rounds):
    inst = load_or_generate(name, data_dir="data/boxqp")
    cfg = RunConfig(lp=LPConfig(max_iters=6000, tol=1e-5),
                    scorer=ScorerConfig(strategy=strategy))
    ref = JaxCutSolver(inst, reference_config(cfg)).run(rounds=rounds)
    got = CutSolver(inst, cfg, device="cpu").run(rounds=rounds)
    _assert_bounds_match(got, ref)


def _box(**loop):
    return (generate_spar(12, 100, 3), CutSolver,
            RunConfig(lp=LPConfig(max_iters=1500, tol=1e-5),
                      cuts=CutConfig(k=3, sel_size=8, capacity=128),
                      scorer=ScorerConfig(strategy="random"), loop=LoopConfig(**loop)))


def _qcqp(**loop):
    return (load_or_generate_qcqp("qcqp012-40-3-2"), CutSolverQCQP,
            RunConfig(lp=LPConfig(max_iters=1500, tol=1e-5),
                      cuts=CutConfig(k=4, sel_size=8, capacity=128),
                      scorer=ScorerConfig(strategy="random"), loop=LoopConfig(**loop)))


def check_random_repeats(path):
    """A second solver with the same seed repeats the run bit for bit."""
    inst, solver_cls, cfg = path()
    first = solver_cls(inst, cfg, "cpu").run(rounds=3)
    again = solver_cls(inst, cfg, "cpu").run(rounds=3)
    other = solver_cls(inst, dataclasses.replace(cfg, seed=1), "cpu").run(rounds=3)
    assert _outcome(again) == _outcome(first)
    assert first[0].cuts_added > 0 and first[-1].bound < first[0].bound
    assert np.isfinite([h.certificate for h in first]).all()
    assert _outcome(other) != _outcome(first)     # the seed is read


def check_scan_repeats_per_round_run(path, steer_eps):
    """Random scores, and steering on top: the generator's draws and the
    device work run in one order in both modes."""
    inst, solver_cls, cfg = path(steer_eps=steer_eps, steer_iters=200)
    per_round = solver_cls(inst, cfg, "cpu")
    per_round.run(rounds=3)
    scan_cfg = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, use_scan=True))
    scan = solver_cls(inst, scan_cfg, "cpu")
    scan.run(rounds=3)
    assert len(scan.history) == 3 and _outcome(scan.history) == _outcome(per_round.history)
    assert torch.equal(scan.generator.get_state(), per_round.generator.get_state())
    assert all(torch.equal(a, b) for a, b in zip(scan.state.fields(), per_round.state.fields()))


def check_steering_scores_at_the_steered_point(path, monkeypatch):
    """Selection sees the steered point, while the certificate and the warm
    start are the unsteered solve's: a steered run and an unsteered one
    share round 0's certificate and state, not the point that selects."""
    inst, solver_cls, cfg = path()
    cfg = dataclasses.replace(cfg, scorer=ScorerConfig(strategy="feasibility"))
    plain = solver_cls(inst, cfg, "cpu")
    plain.run(rounds=1)
    steered_cfg = dataclasses.replace(cfg, loop=LoopConfig(steer_eps=1e-2, steer_iters=300))
    steered = solver_cls(inst, steered_cfg, "cpu")
    seen = []
    select = solver_cls.__module__ + ".select_and_generate"
    real = __import__(solver_cls.__module__, fromlist=["select_and_generate"]).select_and_generate
    monkeypatch.setattr(select, lambda x, X, *a: seen.append((x, X)) or real(x, X, *a))
    steered.run(rounds=1)
    assert steered.history[0].certificate == plain.history[0].certificate
    assert steered.history[0].lp_iters == plain.history[0].lp_iters
    x, X = seen[0]
    assert not torch.equal(X, steered.state.X)
    assert torch.equal(steered.state.X, plain.state.X)


def test_random_repeats_from_its_seed():
    check_random_repeats(_box)


@pytest.mark.parametrize("steer_eps", [0.0, 1e-3])
def test_scan_repeats_per_round_run(steer_eps):
    check_scan_repeats_per_round_run(_box, steer_eps)


def test_steering_scores_at_the_steered_point(monkeypatch):
    check_steering_scores_at_the_steered_point(_box, monkeypatch)


def check_score_fn_hook(path):
    """A custom score_fn(x, X, generator) replaces the strategy's scores: the
    feasibility violations, given as a hook, repeat strategy feasibility bit
    for bit; the hook gets the solver's own generator."""
    inst, solver_cls, cfg = path()
    cfg = dataclasses.replace(cfg, scorer=ScorerConfig(strategy="feasibility"))
    want = solver_cls(inst, cfg, "cpu").run(rounds=2)
    seen = []

    def hook(x, X, generator):
        seen.append(generator)
        return feasibility_scores_from_point(x, X, solver.table, 6)

    solver = solver_cls(inst, dataclasses.replace(cfg, scorer=ScorerConfig(strategy="custom")),
                        "cpu", score_fn=hook)
    assert _outcome(solver.run(rounds=2)) == _outcome(want)
    assert seen and all(g is solver.generator for g in seen)


def test_score_fn_hook():
    check_score_fn_hook(_box)
