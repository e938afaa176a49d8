"""The eigencut certifier at full width on the CPU, the JAX package against
the port, round by round: spar125-100-1 with the Burer-Monteiro anchor and
its 320 null directions as seeds, 3 in-out rounds of LPConfig(2000, 2e-6)
over a 2048-row buffer, purge_at one row past the seeds (chip_smoke.py
phase 15 (c)'s settings).  Both packages' certificates rise after round 1's
purge; they agree within rtol 2e-3 a round.  About ten minutes (the JAX
package's LP sums over all 2048 buffer rows), so it is marked slow and run
by hand:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_sdp_fullwidth.py -m slow
"""

import os

import numpy as np
import pytest

from sdpcutsel_tpu.config import LPConfig as JLPConfig
from sdpcutsel_tpu.loop.sdp_bound import bm_null_directions as j_null_directions
from sdpcutsel_tpu.loop.sdp_bound import sdp_relaxation_bound as j_sdp_relaxation_bound
from sdpcutsel_tpu.loop.sdp_primal import bm_feasible_point as j_bm_feasible_point
from sdpcutsel_tpu_torch.config import LPConfig
from sdpcutsel_tpu_torch.instances import parse_boxqp
from sdpcutsel_tpu_torch.loop.sdp_bound import bm_null_directions, sdp_relaxation_bound
from sdpcutsel_tpu_torch.loop.sdp_primal import bm_feasible_point

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "spar125-100-1"


@pytest.mark.slow
def test_full_width_purge_matches_reference():
    inst = parse_boxqp(os.path.join(REPO, "data", "boxqp", f"{NAME}.in"), name=NAME)
    x_in, X_in, _ = bm_feasible_point(inst.Q, inst.c)
    seeds = bm_null_directions(x_in, X_in)
    jx, jX, _ = j_bm_feasible_point(inst.Q, inst.c)
    jseeds = j_null_directions(jx, jX)
    np.testing.assert_array_equal(np.asarray(seeds), np.asarray(jseeds))
    kw = dict(max_rounds=3, max_cuts_per_round=48, capacity=2048, purge_at=len(seeds) + 1)
    _, _, ref = j_sdp_relaxation_bound(inst, JLPConfig(max_iters=2000, tol=2e-6),
                                       anchor=(jx, jX), seed_dirs=jseeds, **kw)
    _, _, got = sdp_relaxation_bound(inst, LPConfig(max_iters=2000, tol=2e-6),
                                     anchor=(x_in, X_in), seed_dirs=seeds, device="cpu", **kw)
    want = np.array([h["bound"] for h in ref])
    have = np.array([h["bound"] for h in got])
    print(f"JAX package {want.tolist()}; port {have.tolist()}; "
          f"rel {(np.abs(have - want) / np.abs(want)).tolist()}")
    assert len(have) == len(want) == 3
    np.testing.assert_allclose(have, want, rtol=2e-3)
    assert want[2] > want[1] and have[2] > have[1]     # both rise after the purge
