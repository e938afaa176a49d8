"""Port parity of the triangle (RLT-3) cut family: sdpcutsel_tpu_torch's
cuts/triangle.py against sdpcutsel_tpu's on the same numpy points, at f32
atol 1e-6 and with the same picks, ties included (lowest flat (triple, type)
index first); and the validity properties of tests/test_triangle.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpcutsel_tpu.cuts import triangle as jtri
from sdpcutsel_tpu_torch.cuts import triangle as ttri
from sdpcutsel_tpu_torch.cuts.enumerate import combinations_table
from sdpcutsel_tpu_torch.relax.cutbuffer import append_cuts, cut_residuals, empty_pool

ATOL = 1e-6


def _point(n: int, seed: int, tied: bool):
    """(x, X) in [0, 1]; ``tied``: entries on a grid of 1/4, so that many
    violations tie exactly, as at an LP vertex."""
    rng = np.random.default_rng(seed)
    x = rng.random(n)
    X = np.clip(np.outer(x, x) + 0.3 * rng.standard_normal((n, n)), 0, 1)
    if tied:
        x, X = np.round(4 * x) / 4, np.round(4 * X) / 4
    X = 0.5 * (X + X.T)
    return x.astype(np.float32), X.astype(np.float32)


@pytest.mark.parametrize("n", [12, 20])
@pytest.mark.parametrize("tied", [False, True])
def test_violations_scores_and_selection_match_reference(n, tied):
    x, X = _point(n, n, tied)
    table = combinations_table(n, 3)
    jx, jX, jt = jnp.asarray(x), jnp.asarray(X), jnp.asarray(table)
    tx, tX, tt = torch.as_tensor(x), torch.as_tensor(X), torch.as_tensor(table)
    np.testing.assert_allclose(ttri.triangle_violations(tx, tX, tt).numpy(),
                               np.asarray(jtri.triangle_violations(jx, jX, jt)), atol=ATOL)
    np.testing.assert_allclose(ttri.triangle_scores(tx, tX, tt).numpy(),
                               np.asarray(jtri.triangle_scores(jx, jX, jt)), atol=ATOL)
    mask = np.arange(table.shape[0]) % 7 != 3
    for table_mask in (None, mask):
        got = ttri.triangle_select_and_generate(
            tx, tX, tt, 30, 1e-4,
            table_mask=None if table_mask is None else torch.as_tensor(table_mask))
        want = jtri.triangle_select_and_generate(
            jx, jX, jt, 30, 1e-4,
            table_mask=None if table_mask is None else jnp.asarray(table_mask))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))       # same picks
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))       # same validity
        for g, w in zip(got[1:4], want[1:4]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    if tied:
        # the top 30 hold ties, so the order among equal violations is tested
        top = np.sort(ttri.triangle_violations(tx, tX, tt).numpy().ravel())[::-1][:31]
        assert len(np.unique(top)) < len(top)


def test_normalised_rows_match_reference():
    np.testing.assert_array_equal(ttri._LIN_N, jtri._LIN_N)
    np.testing.assert_array_equal(ttri._QUAD_N, jtri._QUAD_N)
    np.testing.assert_array_equal(ttri._RHS_N, jtri._RHS_N)


def test_triangle_valid_on_lifted_points():
    """All 4 inequalities hold at X = x x^T for x in [0, 1]^n."""
    rng = np.random.default_rng(0)
    n = 8
    table = torch.as_tensor(combinations_table(n, 3))
    for _ in range(20):
        x = torch.as_tensor(rng.random(n), dtype=torch.float32)
        assert float(ttri.triangle_violations(x, torch.outer(x, x), table).max()) <= 1e-5


def test_triangle_tight_at_vertices():
    """At binary x, T0 is tight at a two-ones vertex and T1 at (1, 0, 1)."""
    table = torch.as_tensor(combinations_table(3, 3))
    x = torch.tensor([1.0, 1.0, 0.0])
    assert abs(float(ttri.triangle_violations(x, torch.outer(x, x), table)[0, 0])) < 1e-6
    x = torch.tensor([1.0, 0.0, 1.0])
    assert abs(float(ttri.triangle_violations(x, torch.outer(x, x), table)[0, 1])) < 1e-6


def test_triangle_detects_violation():
    """X far below x x^T off the diagonal violates T0 (2.7 - 0 - 1 = 1.7)."""
    table = torch.as_tensor(combinations_table(3, 3))
    v = ttri.triangle_violations(torch.full((3,), 0.9), torch.zeros((3, 3)), table)
    assert float(v[0, 0]) > 0.5


def test_triangle_rows_match_violations():
    """The emitted rows are violated at the point, and their residuals undo
    to the largest violations (tests/test_triangle.py:51-81)."""
    x, X = _point(6, 1, False)
    tx, tX = torch.as_tensor(x), torch.as_tensor(X)
    table = torch.as_tensor(combinations_table(6, 3))
    rows = ttri.triangle_select_and_generate(tx, tX, table, 8, 1e-6)
    pool = append_cuts(empty_pool(16, 3, "cpu"), *rows)
    m = int(pool.count)
    assert m > 0
    res = cut_residuals(tx, tX, pool).numpy()[:m]
    assert (res < 0).all()
    lin = pool.lin.numpy()[:m]
    norms = np.where(lin.sum(1) < -1.0, np.sqrt(4.5), np.sqrt(2.5))
    top = np.sort(ttri.triangle_violations(tx, tX, table).numpy().ravel())[::-1][:m]
    np.testing.assert_allclose(np.sort(-res * norms)[::-1], top, atol=1e-5)
