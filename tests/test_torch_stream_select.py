"""The k = 3 round by pieces of the candidate table (past n = 2048 on the
card): ``cuts/enumerate.py``'s pieces and row writer against
``combinations_table``, ``ops/topk.py``'s StreamedTopk against
``diverse_topk`` (and ``masked_topk`` at alpha 0) bit for bit and against the
JAX package's ``diverse_topk`` on numpy-seeded scores (ties of 60 and more,
runs of -inf, fewer finite scores than picks), and whole CutSolver runs with
the route forced (the private ``_pieces``) against the whole-table route bit
for bit and against the JAX package at rtol 2e-3.  torch runs on one thread
here."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpcutsel_tpu.ops.topk import diverse_topk as jax_diverse_topk
from sdpcutsel_tpu_torch.config import LPConfig, RunConfig, ScorerConfig
from sdpcutsel_tpu_torch.cuts.enumerate import (combinations_rows_on, combinations_table,
                                                combinations_table_on, first_index_pieces)
from sdpcutsel_tpu_torch.instances import load_or_generate
from sdpcutsel_tpu_torch.loop import CutSolver
from sdpcutsel_tpu_torch.loop import solver as tsolver
from sdpcutsel_tpu_torch.ops.topk import StreamedTopk, diverse_topk, masked_topk
from test_torch_solver import JaxCutSolver, _assert_rounds_match, _outcome

CFG = RunConfig(lp=LPConfig(max_iters=6000, tol=1e-5))
N = 30                                  # the streamed selection's table: C(30, 3) = 4,060 rows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the pieces and the rows written by first index ------------------------------

@pytest.mark.parametrize("n,k,cap", [(20, 3, 1), (20, 3, 7), (30, 3, 1000), (12, 4, 30),
                                     (9, 2, 5), (40, 3, 10 ** 9)])
def test_rows_by_first_index_are_the_table(n, k, cap):
    """Each piece's rows (written from the table of width k - 1) are the
    table's rows at the piece's offset, in order; the pieces cover the
    table once, each of whole first indices and at most ``cap`` rows unless
    one first index alone has more."""
    table = combinations_table(n, k)
    sub = combinations_table_on(n, k - 1, "cpu")
    pieces = first_index_pieces(n, k, cap)
    at = 0
    for i0, i1, offset, rows in pieces:
        assert offset == at == math.comb(n, k) - math.comb(n - i0, k)
        got = combinations_rows_on(n, k, i0, i1, "cpu", sub)
        assert got.dtype == torch.int32 and got.shape == (rows, k)
        np.testing.assert_array_equal(got.numpy(), table[offset:offset + rows])
        assert np.array_equal(combinations_rows_on(n, k, i0, i1, "cpu").numpy(), got.numpy())
        assert rows <= cap or i1 == i0 + 1
        assert (table[offset:offset + rows, 0] >= i0).all()
        assert (table[offset:offset + rows, 0] < i1).all()
        at += rows
    assert at == table.shape[0] and pieces[0][0] == 0 and pieces[-1][1] == n - k + 1


def test_row_writer_refuses_bad_ranges():
    with pytest.raises(ValueError):
        combinations_rows_on(10, 3, 5, 9, "cpu")
    with pytest.raises(ValueError):
        first_index_pieces(10, 3, 0)


# ---- the streamed selection -------------------------------------------------------

def _scores(kind: str, seed: int) -> np.ndarray:
    """numpy-seeded float32 scores over C(N, 3) of one kind."""
    rng = np.random.default_rng(seed)
    T = math.comb(N, 3)
    s = rng.standard_normal(T).astype(np.float32)
    if kind == "ties":                  # a few levels: ties of hundreds at the top
        s = rng.integers(0, 4, T).astype(np.float32) * 0.25
    elif kind == "ties60":              # 65 rows tie at the top, the rest below
        s = -rng.random(T).astype(np.float32)
        s[rng.choice(T, 65, replace=False)] = 1.0
    elif kind == "minus_inf":           # runs of -inf
        s[rng.random(T) < 0.7] = -np.inf
        s[1000:1800] = -np.inf
    elif kind == "few_finite":          # fewer finite scores than picks
        s[:] = -np.inf
        s[rng.choice(T, 7, replace=False)] = rng.standard_normal(7).astype(np.float32)
    elif kind == "none_finite":
        s[:] = -np.inf
    return s


def _streamed(scores: torch.Tensor, S: int, alpha: float, cap: int):
    sel = StreamedTopk(S, alpha, 3, "cpu", n=N)
    sub = combinations_table_on(N, 2, "cpu")
    for i0, i1, offset, rows in first_index_pieces(N, 3, cap):
        sel.add(scores[offset:offset + rows], combinations_rows_on(N, 3, i0, i1, "cpu", sub),
                offset)
    return sel.result(), sel.most


KINDS = ["normal", "ties", "ties60", "minus_inf", "few_finite", "none_finite"]


@pytest.mark.parametrize("cap", [1, 7, 1000])
@pytest.mark.parametrize("alpha", [1e-4, 0.5])
@pytest.mark.parametrize("kind", KINDS)
def test_streamed_is_diverse_topk(kind, alpha, cap):
    """Pieces of at most ``cap`` rows give diverse_topk's (values, indices,
    valid) on the whole table bit for bit, and the table's rows of the
    picks; the survivors stay far fewer than the table where scores are
    spread and alpha small (at alpha 0.5 the threshold lies 28.5 below the
    20th score: every row survives)."""
    scores = torch.as_tensor(_scores(kind, KINDS.index(kind)))
    table = torch.as_tensor(combinations_table(N, 3))
    want = diverse_topk(scores, table, 20, alpha)
    (vals, idx, valid, rows), most = _streamed(scores, 20, alpha, cap)
    assert torch.equal(vals, want[0]) and torch.equal(idx, want[1])
    assert torch.equal(valid, want[2]) and torch.equal(rows, table[want[1]])
    if kind == "normal" and alpha < 0.01:
        assert most < table.shape[0] // 4


@pytest.mark.parametrize("kind", KINDS)
def test_streamed_is_masked_topk_at_alpha_0(kind):
    """At alpha 0 (the plain top-k of select_and_generate) the pieces give
    masked_topk's bits."""
    scores = torch.as_tensor(_scores(kind, 10 + KINDS.index(kind)))
    table = torch.as_tensor(combinations_table(N, 3))
    want = masked_topk(scores, 20)
    for cap in (7, 1000):
        (vals, idx, valid, rows), _ = _streamed(scores, 20, 0.0, cap)
        assert torch.equal(vals, want[0]) and torch.equal(idx, want[1])
        assert torch.equal(valid, want[2]) and torch.equal(rows, table[want[1]])


@pytest.mark.parametrize("alpha", [1e-4, 0.5])
@pytest.mark.parametrize("kind", ["ties", "ties60", "minus_inf", "few_finite"])
def test_streamed_gives_the_jax_packages_picks(kind, alpha):
    """The JAX package's diverse_topk on the same scores picks the same
    candidates with the same values and validity."""
    s = _scores(kind, 20 + len(kind))
    table = combinations_table(N, 3)
    (vals, idx, valid, _), _ = _streamed(torch.as_tensor(s), 20, alpha, 97)
    jv, js, jok = jax_diverse_topk(jnp.asarray(s), jnp.asarray(table), 20, N, alpha)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(js))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=0, atol=0)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jok))


def test_streamed_refuses_nan():
    sel = StreamedTopk(5, 1e-4, 3, "cpu", n=3)
    with pytest.raises(ValueError, match="NaN"):
        sel.add(torch.tensor([1.0, float("nan")]), torch.zeros(2, 3, dtype=torch.int32), 0)


# ---- whole solves by pieces ----------------------------------------------------------

@pytest.mark.parametrize("name", ["spar020-100-1", "spar030-100-1"])
def test_cut_solver_by_pieces_is_the_whole_table(name):
    """3 rounds of CutSolver with the piecewise route forced (pieces of at
    most 97 rows: C(20, 3) in 12) repeat the whole-table route bit for bit,
    and the JAX package's rounds at rtol 2e-3; the route keeps no table."""
    inst = load_or_generate(name, data_dir="data/boxqp")
    pieced = CutSolver(inst, CFG, device="cpu", _pieces=97)
    assert pieced.table is None and len(pieced.pieces) > 1
    got = pieced.run(rounds=3)
    whole = CutSolver(inst, CFG, device="cpu")
    assert whole.pieces is None and whole.table is not None
    assert _outcome(got) == _outcome(whole.run(rounds=3))
    _assert_rounds_match(got, JaxCutSolver(inst, CFG).run(rounds=3))


@pytest.mark.parametrize("strategy", ["feasibility", "combined"])
def test_cut_solver_by_pieces_feasibility_and_combined(strategy):
    """The other kernel-scored strategies by pieces repeat the whole table's
    rounds bit for bit (spar020-100-1, 2 rounds)."""
    inst = load_or_generate("spar020-100-1", data_dir="data/boxqp")
    cfg = RunConfig(lp=CFG.lp, scorer=ScorerConfig(strategy=strategy))
    got = CutSolver(inst, cfg, device="cpu", _pieces=200).run(rounds=2)
    assert _outcome(got) == _outcome(CutSolver(inst, cfg, device="cpu").run(rounds=2))


def test_route_by_n():
    """Past PIECE_N a k = 3 kernel-scored strategy goes by pieces of at most
    PIECE_ROWS rows (C(4096, 3) in ~86); random and triangle take the same
    pieces where forced (tests/test_torch_strategy_pieces.py holds their
    own thresholds); a custom score_fn keeps the whole table; _pieces=False
    forces it."""
    assert tsolver.PIECE_N == 2048
    pieces = first_index_pieces(4096, 3, tsolver.PIECE_ROWS)
    assert sum(p[3] for p in pieces) == math.comb(4096, 3) == 11_444_858_880
    assert all(p[3] <= tsolver.PIECE_ROWS for p in pieces) and 80 <= len(pieces) <= 100
    inst = load_or_generate("spar020-100-1", data_dir="data/boxqp")
    assert CutSolver(inst, CFG, device="cpu", _pieces=False).pieces is None
    for strategy in ("random", "triangle"):
        cfg = RunConfig(lp=CFG.lp, scorer=ScorerConfig(strategy=strategy))
        assert CutSolver(inst, cfg, device="cpu", _pieces=50).pieces == first_index_pieces(
            inst.n, 3, 50)
    custom = RunConfig(lp=CFG.lp, scorer=ScorerConfig(strategy="custom"))
    assert CutSolver(inst, custom, device="cpu", _pieces=50,
                     score_fn=lambda x, X, g: torch.zeros(1140)).pieces is None
