"""The slice past n = 1024 as a whole on the CPU: one round of the port's
CutSolver on generate_spar(1030, 100, 1) through the grid route's wrappers
at 2048 columns (their twins here), against one round of the JAX package's
CutSolver.  The table is written on the device (here the CPU) and the
selection keeps its penalty by index counts.  k = 2 keeps the table at
C(1030, 2) = 529,935 rows; 400 LP iterations keep the file within a minute
and a half.  torch runs on one thread here."""

import numpy as np
import pytest
import torch

from sdpcutsel_tpu.loop import CutSolver as JaxCutSolver
from sdpcutsel_tpu_torch.config import CutConfig, LPConfig, RunConfig
from sdpcutsel_tpu_torch.instances import generate_spar
from sdpcutsel_tpu_torch.loop import CutSolver
from sdpcutsel_tpu_torch.lp import pdhg_grid as tgrid
from sdpcutsel_tpu_torch.lp.pdhg_kernel import columns, route_refusal
from test_torch_grid import _plain
from test_torch_portmods import reference_config

VAST_CFG = RunConfig(lp=LPConfig(max_iters=400, use_kernel="on"),
                     cuts=CutConfig(k=2, sel_size=10))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's CPU threads share this process; torch's intra-op pool on top of
    them oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cut_solver_n1030_matches_reference(monkeypatch):
    """One round of the port's CutSolver at n = 1030, k = 2, sel_size 10,
    400 LP iterations, on the grid route's 2048-column wrappers ("on"),
    against the JAX package's round at the reference's bound tolerance
    (rtol 2e-3, tests/test_loop.py), with the same LP iterations and cuts
    added; every checked step went through the grid route."""
    inst = generate_spar(1030, 100, 1)
    assert columns(1030) == 2048
    assert route_refusal(1030, VAST_CFG.cuts.capacity, 2, 0) == ("grid", None)
    steps = []
    real = tgrid.grid_checked_step

    def counted(*args, **kw):
        steps.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tgrid, "grid_checked_step", counted)
    solver = CutSolver(inst, VAST_CFG, device="cpu")
    assert solver.table.dtype == torch.int32 and solver.table.shape == (1030 * 1029 // 2, 2)
    got = solver.run(rounds=1)
    ref = JaxCutSolver(inst, reference_config(_plain(VAST_CFG))).run(rounds=1)
    assert steps and len(got) == len(ref) == 1
    assert got[0].lp_iters == ref[0].lp_iters == 400
    assert got[0].cuts_added == ref[0].cuts_added > 0
    assert np.isfinite(got[0].bound)
    np.testing.assert_allclose(got[0].bound, ref[0].bound, rtol=2e-3)
