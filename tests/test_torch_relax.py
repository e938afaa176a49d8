"""Port parity: sdpcutsel_tpu_torch.relax against sdpcutsel_tpu.relax on the
same numpy inputs (atol 1e-6, float32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpcutsel_tpu.relax import cutbuffer as jcb
from sdpcutsel_tpu.relax import mccormick as jmc
from sdpcutsel_tpu_torch.relax import cutbuffer as tcb
from sdpcutsel_tpu_torch.relax import mccormick as tmc

TOL = dict(rtol=0, atol=1e-6)


def _cuts(rng, m, n, k=3):
    idx = rng.integers(0, n, (m, k)).astype(np.int32)
    lin = rng.standard_normal((m, k)).astype(np.float32)
    quad = rng.standard_normal((m, k, k)).astype(np.float32)
    quad = 0.5 * (quad + np.transpose(quad, (0, 2, 1)))
    rhs = (0.1 * rng.standard_normal(m)).astype(np.float32)
    valid = rng.random(m) < 0.8
    return idx, lin, quad, rhs, valid


def _pools(rng, n, M, m):
    """The same random pool in both packages (append into an empty pool)."""
    idx, lin, quad, rhs, valid = _cuts(rng, m, n)
    jp = jcb.append_cuts(jcb.empty_pool(M, 3), jnp.asarray(idx), jnp.asarray(lin),
                         jnp.asarray(quad), jnp.asarray(rhs), jnp.asarray(valid))
    tp = tcb.append_cuts(tcb.empty_pool(M, 3, "cpu"), torch.as_tensor(idx),
                         torch.as_tensor(lin), torch.as_tensor(quad),
                         torch.as_tensor(rhs), torch.as_tensor(valid))
    return jp, tp


def _point(rng, n):
    x = rng.random(n).astype(np.float32)
    X = rng.random((n, n)).astype(np.float32)
    return x, 0.5 * (X + X.T)


def _assert_pools_equal(jp, tp):
    for f in ("idx", "lin", "quad", "rhs", "active"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), **TOL)
    assert int(tp.count) == int(jp.count)


@pytest.mark.parametrize("include_rhs", [True, False])
def test_cut_residuals_match(include_rhs):
    rng = np.random.default_rng(0)
    n, M = 17, 48
    jp, tp = _pools(rng, n, M, 40)
    x, X = _point(rng, n)
    rj = jcb.cut_residuals(jnp.asarray(x), jnp.asarray(X), jp, include_rhs)
    rt = tcb.cut_residuals(torch.as_tensor(x), torch.as_tensor(X), tp, include_rhs)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), **TOL)


def test_cut_adjoint_matches():
    """Fixed-order sums over the pool's cut index against the reference,
    and identical bits on a repeat."""
    rng = np.random.default_rng(1)
    n, M = 17, 48
    jp, tp = _pools(rng, n, M, 40)
    yC = rng.random(M).astype(np.float32)
    ix = tcb.build_cut_index(tp, n)
    gxj, gXj = jcb.cut_adjoint(jnp.asarray(yC), jp, n)
    gxt, gXt = tcb.cut_adjoint(torch.as_tensor(yC), tp, n, ix)
    np.testing.assert_allclose(gxt.numpy(), np.asarray(gxj), **TOL)
    np.testing.assert_allclose(gXt.numpy(), np.asarray(gXj), **TOL)
    again = tcb.cut_adjoint(torch.as_tensor(yC), tp, n, ix)
    assert torch.equal(again[0], gxt) and torch.equal(again[1], gXt)


def test_cut_index_of_empty_pool_gives_zero_adjoint():
    n, M = 9, 16
    pool = tcb.empty_pool(M, 3, "cpu")
    gx, gX = tcb.cut_adjoint(torch.ones(M), pool, n, tcb.build_cut_index(pool, n))
    assert gx.shape == (n,) and gX.shape == (n, n)
    assert not gx.any() and not gX.any()


def test_append_cuts_drops_overflow():
    rng = np.random.default_rng(2)
    n, M = 11, 24
    jp, tp = _pools(rng, n, M, 20)
    more = _cuts(rng, 30, n)          # far more valid rows than the 24 slots
    jp2 = jcb.append_cuts(jp, *(jnp.asarray(a) for a in more))
    tp2 = tcb.append_cuts(tp, *(torch.as_tensor(a) for a in more))
    assert int(tp2.count) == M
    _assert_pools_equal(jp2, tp2)


def test_purge_pool_compacts_stably():
    rng = np.random.default_rng(3)
    n, M = 13, 40
    jp, tp = _pools(rng, n, M, 36)
    yC = np.where(rng.random(M) < 0.3, rng.random(M), 0.0).astype(np.float32)
    slack = (rng.random(M) * 2e-3).astype(np.float32)
    pj, yj = jcb.purge_pool(jp, jnp.asarray(yC), jnp.asarray(slack), 1e-3)
    pt, yt = tcb.purge_pool(tp, torch.as_tensor(yC), torch.as_tensor(slack), 1e-3)
    assert 0 < int(pt.count) < int(tp.count)
    _assert_pools_equal(pj, pt)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)


def test_mccormick_operators_match():
    rng = np.random.default_rng(4)
    n, M = 15, 32
    jp, tp = _pools(rng, n, M, 28)
    x, X = _point(rng, n)
    yA, yB = (rng.random((n, n)).astype(np.float32) for _ in range(2))
    yC = rng.random(M).astype(np.float32)
    kj = jmc.apply_K(jnp.asarray(x), jnp.asarray(X), jp)
    kt = tmc.apply_K(torch.as_tensor(x), torch.as_tensor(X), tp)
    gj = jmc.apply_KT(jnp.asarray(yA), jnp.asarray(yB), jnp.asarray(yC), jp, n)
    gt = tmc.apply_KT(torch.as_tensor(yA), torch.as_tensor(yB), torch.as_tensor(yC), tp, n,
                      tcb.build_cut_index(tp, n))
    pj = jmc.project_primal(jnp.asarray(2 * x - 0.5), jnp.asarray(2 * X - 0.5))
    pt = tmc.project_primal(torch.as_tensor(2 * x - 0.5), torch.as_tensor(2 * X - 0.5))
    for a, b in zip([*kt, *gt, *pt], [*kj, *gj, *pj]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-5)
