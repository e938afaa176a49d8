"""Port parity of vertex steering (lp/pdhg.py ``steer_to_vertex``,
``_steer_impl``) against sdpcutsel_tpu's on the CPU.

The reference draws its Rademacher signs with ``jax.random.bernoulli``, the
port from a CPU ``torch.Generator``; ``_steer_impl`` takes the signs as
arguments, so the parity test feeds it the reference's own.  Tolerance: 200
iterations from the same state with the same ||K||; the steered (x, X) is
held at 2e-5 (K2's block tolerance, tests/test_pdhg_kernel.py) with and
without the dense rows of a QCQP.  The property test of tests/test_pdhg.py
(the steered point stays on the optimal face and leaves its interior) runs
on the port with the port's own signs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpcutsel_tpu.lp import pdhg as jpdhg
from sdpcutsel_tpu.relax import denserows as jdr
from sdpcutsel_tpu_torch.config import LPConfig
from sdpcutsel_tpu_torch.lp import pdhg as tpdhg
from sdpcutsel_tpu_torch.relax.cutbuffer import build_cut_index, empty_pool
from sdpcutsel_tpu_torch.relax.mccormick import SB, apply_K
from test_torch_qcqp import _setup

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("with_dense", [False, True])
def test_steer_with_reference_signs_matches_reference(with_dense):
    inst, (jcx, jcX, jpool, jd, jst), (tcx, tcX, tpool, td, tst) = _setup(seed=5)
    n = inst.n
    if not with_dense:
        jd = jdr.empty_dense(n)
        jst = jst._replace(yD=jnp.zeros((0,), jnp.float32))
        td, tst.yD = None, torch.zeros((0,))
    key = jax.random.PRNGKey(7)
    normK = float(jpdhg.estimate_norm(jpool, n, 30, jnp.float32, jd))
    want = jpdhg._steer_impl(jcx, jcX, jpool, jd, jst, normK, jnp.asarray(1.0, jnp.float32),
                             0.95, jnp.asarray(1e-3, jnp.float32), key, 200)
    # the reference's signs (lp/pdhg.py::_steer_impl's draws)
    kx, kX = jax.random.split(key)
    sx = 2.0 * jax.random.bernoulli(kx, 0.5, (n,)) - 1.0
    SX = 2.0 * jax.random.bernoulli(kX, 0.5, (n, n)) - 1.0
    setup = tpdhg.SolveSetup("plain", build_cut_index(tpool, n), normK)
    got = tpdhg._steer_impl(tcx, tcX, tpool, td, tst, setup, 1.0, 0.95, 1e-3,
                            torch.tensor(np.asarray(sx, np.float32)),
                            torch.tensor(np.asarray(SX, np.float32)), 200)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # steering moved the point
    assert float((got[1] - tst.X).abs().max()) > 1e-3


def test_rademacher_signs_are_seeded_and_balanced():
    a = tpdhg.rademacher_signs(40, torch.Generator().manual_seed(3), "cpu")
    b = tpdhg.rademacher_signs(40, torch.Generator().manual_seed(3), "cpu")
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert a[0].dtype == torch.float32 and set(a[1].unique().tolist()) == {-1.0, 1.0}
    assert 0.4 < float((a[1] > 0).float().mean()) < 0.6


def test_vertex_steering_stays_optimal_and_sharpens():
    """tests/test_pdhg.py:93-140 on the port, with the port's signs: with
    Q = 0 and c = (1, 1, 1, 0, 0, 0) the optimal face holds the whole [0, 1]
    segment of x3..x5; PDHG from 0.5 stays inside it.  Steering keeps the
    objective and feasibility and moves x3..x5 to vertex values of the
    McCormick polytope: 0, 1, or 1/2 (for example with X_ii = 0, where
    X_ii >= 2 x_i - 1 and X_ii >= 0 are both tight).  The reference's test
    asks for 0 or 1 after 8000 iterations, which its PRNGKey(0) signs give;
    keys 1 and 2 leave two or three of x3..x5 within 0.06 of 1/2 there
    (measured with the reference's signs fed to the port, whose steered
    points match the reference's above).  The port's seed-0 signs reach a
    vertex within 20000 iterations."""
    n = 6
    Q = torch.zeros((n, n))
    c = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0, 0.0])
    pool = empty_pool(8, 3, "cpu")
    cfg = LPConfig(max_iters=20_000, tol=1e-6)
    st, _ = tpdhg.solve_lp(Q, c, pool, tpdhg.init_state(n, 8, "cpu"), cfg)
    x0 = st.x.numpy()
    assert ((x0[3:] > 0.05) & (x0[3:] < 0.95)).all()
    sx, sX = tpdhg.steer_to_vertex(Q, c, pool, st, cfg, torch.Generator().manual_seed(0),
                                   eps=1e-3, iters=20_000)
    assert abs(float(c.double() @ sx.double()) - 3.0) <= 5e-3 * 4.0
    kA, kB, _ = apply_K(sx, sX, pool)
    assert float(kA.min()) > -5e-3 and float((kB + SB).min()) > -5e-3
    xs = sx.numpy()
    assert (np.abs(xs[3:, None] - np.array([0.0, 0.5, 1.0])).min(1) < 0.05).all()
    assert (np.abs(xs[3:] - x0[3:]) > 0.05).any()
    assert (xs[:3] > 0.95).all()
