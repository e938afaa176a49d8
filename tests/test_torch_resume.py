"""Checkpoint and resume of the port's round loop (utils/checkpoint.py,
``CheckpointableSolver``): a run interrupted after 2 rounds and resumed in a
fresh solver from its snapshot repeats the uninterrupted run bit for bit on
the CPU, random draws and steering included; the QCQP gate's state survives
a resume; another instance's snapshot raises.  The instances and cut
settings are tests/test_resume.py's; the LP stops at 2,000 iterations, since
the property needs no converged solve."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from sdpcutsel_tpu_torch.config import CutConfig, LoopConfig, LPConfig, RunConfig, ScorerConfig
from sdpcutsel_tpu_torch.instances import generate_spar
from sdpcutsel_tpu_torch.instances.qcqp import generate_qcqp
from sdpcutsel_tpu_torch.loop import CutSolver
from sdpcutsel_tpu_torch.qcqp import CutSolverQCQP


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _outcome(hist):
    return [(h.round, h.bound, h.certificate, h.lp_iters, h.lp_kkt_error, h.cuts_added,
             h.cuts_active) for h in hist]


def _same_state(a, b):
    fields = [*dataclasses.astuple(a.pool), *a.state.fields()]
    others = [*dataclasses.astuple(b.pool), *b.state.fields()]
    return all(torch.equal(u, v) for u, v in zip(fields, others))


def _box_cfg(strategy, steer, tmp=None):
    return RunConfig(
        lp=LPConfig(max_iters=2000, tol=1e-5),
        cuts=CutConfig(k=3, sel_size=8, capacity=128),
        scorer=ScorerConfig(strategy=strategy),
        loop=LoopConfig(rounds=4, checkpoint_every=1 if tmp else 0,
                        checkpoint_dir=str(tmp) if tmp else None,
                        steer_eps=1e-3 if steer else 0.0, steer_iters=200))


def _qcqp_cfg(strategy, steer, tmp=None, gate="residual"):
    return RunConfig(
        lp=LPConfig(max_iters=2000, tol=1e-5),
        cuts=CutConfig(k=3, sel_size=6, capacity=128, sel_gate=gate, sel_cooldown=3),
        scorer=ScorerConfig(strategy=strategy),
        loop=LoopConfig(rounds=4, checkpoint_every=1 if tmp else 0,
                        checkpoint_dir=str(tmp) if tmp else None,
                        steer_eps=1e-3 if steer else 0.0, steer_iters=200))


CASES = [("feasibility", False), ("random", True)]


@pytest.mark.parametrize("solver_cls", [CutSolver, CutSolverQCQP])
@pytest.mark.parametrize("strategy,steer", CASES)
def test_resume_matches_uninterrupted_bit_for_bit(tmp_path, solver_cls, strategy, steer):
    if solver_cls is CutSolver:
        inst, cfg = generate_spar(12, 100, 3), _box_cfg
    else:
        inst, cfg = generate_qcqp(12, 40, 2, 1), _qcqp_cfg
    ref = solver_cls(inst, cfg(strategy, steer), "cpu")
    ref.run(rounds=4)
    a = solver_cls(inst, cfg(strategy, steer, tmp_path), "cpu")
    a.run(rounds=2)
    path = a._checkpoint_path()
    assert path == os.path.join(str(tmp_path), f"{inst.name}.ck")
    assert os.path.exists(path) and os.path.exists(path + ".json")
    b = solver_cls(inst, cfg(strategy, steer, tmp_path), "cpu").restore(path)
    assert _outcome(b.history) == _outcome(a.history)
    assert _same_state(a, b)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    b.run(rounds=2)
    assert len(b.history) == 4
    assert _outcome(b.history) == _outcome(ref.history)
    assert _same_state(b, ref)
    np.testing.assert_array_equal(b.bounds, ref.bounds)


def test_snapshot_format(tmp_path):
    """An .npz of the pool, state and generator fields with their dtypes,
    and a JSON sidecar of the history and meta."""
    inst = generate_spar(12, 100, 3)
    s = CutSolver(inst, _box_cfg("random", False, tmp_path), "cpu")
    s.run(rounds=1)
    with np.load(s._checkpoint_path()) as z:
        assert z["pool.idx"].dtype == np.int64 and z["pool.count"].shape == ()
        assert z["state.X"].dtype == np.float32 and z["state.X"].shape == (12, 12)
        assert z["generator"].dtype == np.uint8
    with open(s._checkpoint_path() + ".json") as f:
        side = json.load(f)
    assert side["meta"] == {"instance": inst.name, "strategy": "random"}
    assert side["history"][0]["certificate"] == s.history[0].certificate


@pytest.mark.parametrize("gate", ["cooldown", "residual"])
def test_qcqp_resume_preserves_gate_state(tmp_path, gate):
    inst = generate_qcqp(12, 40, 2, 1)
    a = CutSolverQCQP(inst, _qcqp_cfg("feasibility", False, tmp_path, gate), "cpu")
    a.run(rounds=3)
    if gate == "cooldown":
        assert int(a._cooldown.max()) > 0, "the test needs a cooldown state"
    else:
        assert bool(torch.isfinite(a._last_viol).any()), "the test needs a last_viol state"
    b = CutSolverQCQP(inst, _qcqp_cfg("feasibility", False, tmp_path, gate), "cpu")
    b.restore(a._checkpoint_path())
    assert torch.equal(b._cooldown, a._cooldown) and b._cooldown.dtype == torch.int32
    assert torch.equal(b._last_viol, a._last_viol)


@pytest.mark.parametrize("solver_cls", [CutSolver, CutSolverQCQP])
def test_restore_rejects_wrong_instance(tmp_path, solver_cls):
    if solver_cls is CutSolver:
        inst, other, cfg = generate_spar(12, 100, 3), generate_spar(12, 100, 4), _box_cfg
    else:
        inst, other, cfg = generate_qcqp(12, 40, 2, 1), generate_qcqp(12, 40, 2, 2), _qcqp_cfg
    a = solver_cls(inst, cfg("feasibility", False, tmp_path), "cpu")
    a.run(rounds=1)
    with pytest.raises(ValueError, match="checkpoint is for"):
        solver_cls(other, cfg("feasibility", False, tmp_path), "cpu").restore(
            a._checkpoint_path())


def test_scan_mode_writes_no_snapshot(tmp_path):
    inst = generate_spar(12, 100, 3)
    cfg = _box_cfg("feasibility", False, tmp_path)
    cfg = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, use_scan=True))
    CutSolver(inst, cfg, "cpu").run(rounds=2)
    assert os.listdir(tmp_path) == []
