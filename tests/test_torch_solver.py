"""Port parity of the whole slice: sdpcutsel_tpu_torch's CutSolver against
sdpcutsel_tpu's on the CPU, strategy neural with the default cut settings,
3 rounds.  Every round's certified bound agrees at rtol 2e-3
(tests/test_loop.py's tolerance) and the bounds are monotone."""

import numpy as np
import pytest
import torch

from sdpcutsel_tpu.config import LoopConfig, LPConfig, RunConfig, ScorerConfig
from sdpcutsel_tpu.instances import generate_spar, load_or_generate
from sdpcutsel_tpu.loop import CutSolver as JaxCutSolver
from sdpcutsel_tpu_torch.loop import CutSolver

CFG = RunConfig(lp=LPConfig(max_iters=6000, tol=1e-5))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's CPU threads share this process; torch's intra-op pool on top of
    them oversubscribes the cores (10x slower on these small tensors)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["spar020-100-1", "spar014-100-3"])
def test_cut_solver_matches_reference(name):
    if name == "spar014-100-3":
        inst = generate_spar(14, 100, 3)
    else:
        inst = load_or_generate(name, data_dir="data/boxqp")
    ref = JaxCutSolver(inst, CFG).run(rounds=3)
    got = CutSolver(inst, CFG, device="cpu").run(rounds=3)
    assert len(got) == len(ref)
    # round 0 precedes any selection: same solve, same candidates picked
    assert got[0].lp_iters == ref[0].lp_iters
    assert got[0].cuts_added == ref[0].cuts_added > 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.bound, r.bound, rtol=2e-3)
    bounds = [s.bound for s in got]
    assert all(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("cfg", [
    RunConfig(scorer=ScorerConfig(strategy="feasibility")),
    RunConfig(loop=LoopConfig(use_scan=True)),
    RunConfig(loop=LoopConfig(polish_iters=100)),
])
def test_unported_options_raise(cfg):
    with pytest.raises(NotImplementedError):
        CutSolver(generate_spar(8, 100, 1), cfg, device="cpu")
