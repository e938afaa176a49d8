"""Port parity of the whole slice: sdpcutsel_tpu_torch's CutSolver against
sdpcutsel_tpu's on the CPU.  Every round's certified bound agrees at rtol
2e-3 (tests/test_loop.py's tolerance) and the bounds are monotone.  Covered:
strategy neural with the default cut settings; feasibility and combined on
the lexicographic route; the reference's pair (``pair_layout="on"``) and
packed (``"packed"``) routes; scan mode; polish."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from sdpcutsel_tpu.loop import CutSolver as _JaxCutSolver
from sdpcutsel_tpu_torch.config import CutConfig, LoopConfig, LPConfig, RunConfig, ScorerConfig
from sdpcutsel_tpu_torch.instances import generate_spar, load_or_generate
from sdpcutsel_tpu_torch.loop import CutSolver
from test_torch_portmods import reference_config

CFG = RunConfig(lp=LPConfig(max_iters=6000, tol=1e-5))


def JaxCutSolver(inst, cfg):
    """The reference solver, on the port's instance and the same config values."""
    return _JaxCutSolver(inst, reference_config(cfg))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's CPU threads share this process; torch's intra-op pool on top of
    them oversubscribes the cores (10x slower on these small tensors)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spar020():
    return load_or_generate("spar020-100-1", data_dir="data/boxqp")


def _with(cfg, strategy=None, **loop_kw):
    if strategy is not None:
        cfg = dataclasses.replace(cfg, scorer=ScorerConfig(strategy=strategy))
    if loop_kw:
        cfg = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, **loop_kw))
    return cfg


def _assert_rounds_match(got, ref, rtol=2e-3):
    assert len(got) == len(ref)
    # round 0 precedes any selection: same solve, same candidates picked
    assert got[0].cuts_added == ref[0].cuts_added
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.bound, r.bound, rtol=rtol)
    bounds = [s.bound for s in got]
    assert all(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:]))


def _outcome(hist):
    """Everything a round reports except its wall time."""
    return [(h.bound, h.certificate, h.lp_iters, h.lp_kkt_error, h.cuts_added,
             h.cuts_active) for h in hist]


@pytest.mark.parametrize("name", ["spar020-100-1", "spar014-100-3"])
def test_cut_solver_matches_reference(name):
    if name == "spar014-100-3":
        inst = generate_spar(14, 100, 3)
    else:
        inst = _spar020()
    ref = JaxCutSolver(inst, CFG).run(rounds=3)
    got = CutSolver(inst, CFG, device="cpu").run(rounds=3)
    assert got[0].lp_iters == ref[0].lp_iters
    assert got[0].cuts_added > 0
    _assert_rounds_match(got, ref)


@pytest.mark.parametrize("strategy", ["feasibility", "combined"])
def test_lexicographic_strategies_match_reference(strategy):
    """The reference's CPU route: feasibility_scores_from_point and the
    combined gate, both with 6 Jacobi sweeps."""
    inst = _spar020()
    cfg = _with(CFG, strategy)
    ref = JaxCutSolver(inst, cfg).run(rounds=3)
    got = CutSolver(inst, cfg, device="cpu").run(rounds=3)
    assert got[0].cuts_added > 0
    _assert_rounds_match(got, ref)


@pytest.mark.parametrize("strategy", ["neural", "feasibility", "combined"])
def test_pair_layout_on_scores_match_reference_slot_for_slot(strategy):
    """``pair_layout="on"``: the reference scores the pair layout's table
    (5 sweeps) and masks its invalid slots.  Its valid slots are the port's
    lexicographic table in order, and the port scores them with 5 sweeps
    too, so at one point both give the same score slot for slot."""
    inst = _spar020()
    cfg = _with(dataclasses.replace(CFG, cuts=CutConfig(pair_layout="on")), strategy)
    ref, got = JaxCutSolver(inst, cfg), CutSolver(inst, cfg, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.random(inst.n).astype(np.float32)
    X = np.clip(np.outer(x, x) + 0.15 * rng.standard_normal((inst.n,) * 2), 0, 1)
    X = (0.5 * (X + X.T)).astype(np.float32)
    want = np.asarray(ref._score_fn(x, X, None, ref._score_consts))
    have = got._scores(torch.as_tensor(x), torch.as_tensor(X)).numpy()
    valid = np.asarray(ref.table_valid)
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(ref.table)[valid])
    want = want[valid]
    assert have.shape == want.shape and np.array_equal(np.isinf(have), np.isinf(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(have[ok], want[ok], rtol=2e-4, atol=5e-5)


@pytest.mark.parametrize("strategy", ["feasibility", "combined"])
def test_pair_layout_on_round0_supports_match_reference(strategy):
    """``pair_layout="on"``, whole rounds: the port's round-0 pool holds the
    reference's supports.  The two solves differ by ~1e-6 (the estimate_norm
    start vector differs by design), so two picks whose penalised scores lie
    within that noise may trade places: row order may differ only there.
    The pair table's valid slots run in lexicographic order, so the route
    changes no tie-break; at spar020-100-1 the reference's own "on" and
    "auto" routes pick the same round-0 supports."""
    inst = _spar020()
    cfg = _with(dataclasses.replace(CFG, cuts=CutConfig(pair_layout="on")), strategy)
    ref = JaxCutSolver(inst, cfg)
    ref.run(rounds=1)
    got = CutSolver(inst, cfg, device="cpu")
    got.run(rounds=1)
    count = got.history[0].cuts_active
    assert count == ref.history[0].cuts_active > 0
    def rows(idx):
        return sorted(map(tuple, np.asarray(idx)[:count].tolist()))

    assert rows(got.pool.idx) == rows(ref.pool.idx)


@pytest.mark.parametrize("strategy", ["feasibility", "neural"])
def test_packed_route_matches_reference(strategy):
    """tests/test_pair_packed.py's solver configuration, n = 70."""
    inst = generate_spar(70, 100, 1)
    cfg = RunConfig(lp=LPConfig(max_iters=3000, tol=2e-6),
                    cuts=CutConfig(k=3, sel_size=10, capacity=256, pair_layout="packed"),
                    scorer=ScorerConfig(strategy=strategy))
    ref = JaxCutSolver(inst, cfg).run(rounds=2)
    solver = CutSolver(inst, cfg, device="cpu")
    assert solver._use_packed and solver.table.shape[0] == 131072
    got = solver.run(rounds=2)
    assert got[0].cuts_added > 0
    _assert_rounds_match(got, ref)


def _scan_cfg(**loop_kw):
    """tests/test_scan_rounds.py's configuration."""
    return RunConfig(lp=LPConfig(max_iters=4000, tol=1e-5),
                     cuts=CutConfig(k=3, sel_size=10, capacity=256),
                     scorer=ScorerConfig(strategy="feasibility"),
                     loop=LoopConfig(**loop_kw))


def test_scan_repeats_per_round_run_and_matches_reference():
    """Scan and per-round runs give the same bits.  Against the reference,
    3 rounds: round 2 picks among feasibility scores tied to within the
    solves' ~1e-6 difference, so from round 3 the pools differ (ROADMAP.md,
    Queue 3)."""
    inst = generate_spar(12, 100, 3)
    scan = CutSolver(inst, _scan_cfg(use_scan=True), device="cpu").run(rounds=4)
    per_round = CutSolver(inst, _scan_cfg(), device="cpu").run(rounds=4)
    assert len(scan) == 4 and _outcome(scan) == _outcome(per_round)
    assert [h.bound for h in scan] == list(np.minimum.accumulate([h.certificate for h in scan]))
    ref = JaxCutSolver(inst, _scan_cfg(use_scan=True)).run(rounds=3)
    _assert_rounds_match(scan[:3], ref)
    assert [h.cuts_active for h in scan[:3]] == [h.cuts_active for h in ref]


@pytest.mark.parametrize("use_scan", [False, True])
def test_polish_matches_reference(use_scan):
    """2 rounds, whose pools agree with the reference's (see above), then
    the polish re-solve."""
    inst = generate_spar(12, 100, 3)
    cfg = _scan_cfg(use_scan=use_scan, polish_iters=2000)
    ref = JaxCutSolver(inst, cfg).run(rounds=2)
    solver = CutSolver(inst, cfg, device="cpu")
    got = solver.run(rounds=2)
    _assert_rounds_match(got, ref)
    # polish lowers only the last bound, to its own certificate at most
    unpolished = np.minimum.accumulate([h.certificate for h in got])
    assert [h.bound for h in got[:-1]] == list(unpolished[:-1])
    assert got[-1].bound == min(unpolished[-1], solver.polish_certificate)


# the five options the port refused before the round controllers' options
# were ported; each now builds and runs one CPU round
OPTIONS = {
    "random": lambda tmp: RunConfig(scorer=ScorerConfig(strategy="random")),
    "triangle": lambda tmp: RunConfig(scorer=ScorerConfig(strategy="triangle")),
    "optimality": lambda tmp: RunConfig(scorer=ScorerConfig(strategy="optimality")),
    "steering": lambda tmp: RunConfig(loop=LoopConfig(steer_eps=1e-3)),
    "checkpoints": lambda tmp: RunConfig(loop=LoopConfig(checkpoint_every=1,
                                                         checkpoint_dir=str(tmp))),
}


@pytest.mark.parametrize("option", OPTIONS)
def test_options_run_one_round(option, tmp_path):
    solver = CutSolver(generate_spar(8, 100, 1), OPTIONS[option](tmp_path), device="cpu")
    hist = solver.run(rounds=1)
    assert len(hist) == 1 and np.isfinite(hist[0].bound)
    assert hist[0].bound == hist[0].certificate
    if option == "checkpoints":
        assert sorted(os.listdir(tmp_path)) == ["spar008-100-1.ck", "spar008-100-1.ck.json"]


@pytest.mark.parametrize("cfg", [
    RunConfig(scorer=ScorerConfig(strategy="nope")),
    RunConfig(cuts=CutConfig(k=4), scorer=ScorerConfig(strategy="triangle")),
])
def test_reference_value_errors(cfg):
    """The reference's two ValueErrors: an unknown strategy, and triangle
    with k != 3 (RLT-3 inequalities are defined on triples)."""
    with pytest.raises(ValueError, match="unknown strategy|requires k=3"):
        CutSolver(generate_spar(8, 100, 1), cfg, device="cpu")
