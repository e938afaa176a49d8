"""random, triangle and optimality at k = 3 by pieces of the candidate table
(``loop/solver.py``'s piecewise route past each strategy's n): CutSolver with
the route forced (the private ``_pieces``) against the whole-table route bit
for bit (history, pool, each round's cut rows and picks, the generator's
state), per round and in scan mode; triangle and optimality by pieces against
the JAX package's rounds at rtol 2e-3; the streamed flat selection (four
candidates a triple) against ``masked_topk`` on numpy-seeded scores (ties,
-inf, fewer finite than picks, offsets past 2^31); the ADMM's scores by
pieces against one call; optimality where fewer blocks improve than are
picked; the rows written for any run of the table; and the route by n.
torch runs on one thread here."""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

from sdpcutsel_tpu_torch.config import CutConfig, LoopConfig, LPConfig, RunConfig, ScorerConfig
from sdpcutsel_tpu_torch.cuts import triangle as ttri
from sdpcutsel_tpu_torch.cuts.enumerate import (combinations_range_on, combinations_rows_on,
                                                combinations_table, combinations_table_on,
                                                first_index_pieces, range_pieces)
from sdpcutsel_tpu_torch.instances import generate_spar, load_or_generate
from sdpcutsel_tpu_torch.loop import CutSolver
from sdpcutsel_tpu_torch.loop import solver as tsolver
from sdpcutsel_tpu_torch.models import labels as tlab
from sdpcutsel_tpu_torch.ops.topk import choose_cores, masked_topk
from test_torch_solver import JaxCutSolver, _assert_rounds_match, _outcome

LP = LPConfig(max_iters=6000, tol=1e-5)
PIECEWISE = ("random", "triangle", "optimality")
# forced piece sizes: one first index a piece (not for optimality, whose
# pieces are runs of rows: 1,140 ADMM calls), sizes that are multiples of
# nothing, and one piece past the table
CAPS = {"random": (1, 97, 10 ** 6), "triangle": (1, 97, 10 ** 6), "optimality": (97, 383)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(strategy: str, **loop) -> RunConfig:
    return RunConfig(lp=LP, scorer=ScorerConfig(strategy=strategy), loop=LoopConfig(**loop))


def _spar020():
    return load_or_generate("spar020-100-1", data_dir="data/boxqp")


def _pool(solver) -> list:
    p = solver.pool
    return [p.idx, p.lin, p.quad, p.rhs, p.active, p.count]


def _same(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(torch.as_tensor(u), torch.as_tensor(v))
                                    for u, v in zip(a, b))


def _recorded_run(solver, rounds: int, scan: bool = False):
    """Run ``rounds`` and record each round's cut rows (append_cuts's
    arguments) and, on the whole table, its picks (select_and_generate's)."""
    rows, picks = [], []
    append, select = tsolver.append_cuts, tsolver.select_and_generate

    def keep_rows(pool, *r, **kw):
        rows.append([t.clone() for t in r])
        return append(pool, *r, **kw)

    def keep_picks(*a, **kw):
        out = select(*a, **kw)
        picks.append(out[1])
        return out

    with pytest.MonkeyPatch.context() as m:
        m.setattr(tsolver, "append_cuts", keep_rows)
        m.setattr(tsolver, "select_and_generate", keep_picks)
        hist = solver.run_scan(rounds) if scan else solver.run(rounds=rounds)
    return hist, rows, picks


@functools.lru_cache(maxsize=None)
def _whole(strategy: str, rounds: int, scan: bool = False):
    """The whole table's run, once for every test that holds pieces to it."""
    solver = CutSolver(_spar020(), _cfg(strategy), device="cpu", _pieces=False)
    assert solver.pieces is None and solver.table is not None
    return solver, *_recorded_run(solver, rounds, scan)


def _assert_pieces_are_whole(strategy, cap, scan=False):
    rounds = 2
    whole, hist_w, rows_w, picks_w = _whole(strategy, rounds, scan)
    pieced = CutSolver(_spar020(), _cfg(strategy), device="cpu", _pieces=cap)
    assert pieced.table is None and pieced.pieces
    hist_p, rows_p, _ = _recorded_run(pieced, rounds, scan)
    assert _outcome(hist_p) == _outcome(hist_w) and hist_w[0].cuts_added > 0
    assert len(rows_p) == len(rows_w) == rounds
    assert all(_same(a, b) for a, b in zip(rows_p, rows_w))
    assert _same(_pool(pieced), _pool(whole))
    assert _same(pieced.state.fields(), whole.state.fields())
    assert torch.equal(pieced.generator.get_state(), whole.generator.get_state())
    _, idx, _, rows = pieced.last_selection.result()
    if strategy == "triangle":          # the last round's flat picks: (triple, type)
        assert torch.equal(rows.long(), rows_w[-1][0])
        assert torch.equal(torch.as_tensor(ttri._LIN_N)[idx % 4], rows_w[-1][1])
    else:
        assert torch.equal(idx, picks_w[-1])
        assert torch.equal(rows, whole.table[picks_w[-1]])
    return pieced


@pytest.mark.parametrize("strategy,cap", [(s, c) for s in PIECEWISE for c in CAPS[s]])
def test_pieces_repeat_the_whole_table(strategy, cap):
    """2 rounds by pieces of at most ``cap`` rows (optimality: of ``cap``
    rows) repeat the whole table's history, cut rows, picks, pool, state and
    generator bit for bit."""
    pieced = _assert_pieces_are_whole(strategy, cap)
    if cap == 1 and strategy != "optimality":
        assert len(pieced.pieces) == 18          # one first index a piece: 0 .. 17


@pytest.mark.parametrize("strategy", PIECEWISE)
def test_scan_by_pieces_repeats_the_whole_table(strategy):
    """Scan mode takes the same route: 2 scan rounds by pieces equal the
    whole table's scan, which equals its per-round run."""
    pieced = _assert_pieces_are_whole(strategy, 383, scan=True)
    assert _outcome(pieced.history) == _outcome(_whole(strategy, 2)[1])


def test_random_by_pieces_keeps_the_generators_stream():
    """Random's draws by pieces continue one stream: a steered run (the
    signs drawn before the scores each round) and the next round's draws
    see the whole draw's state."""
    cfg = _cfg("random", steer_eps=1e-3, steer_iters=100)
    whole = CutSolver(_spar020(), cfg, device="cpu", _pieces=False)
    pieced = CutSolver(_spar020(), cfg, device="cpu", _pieces=50)
    assert len(pieced.pieces) > 10
    assert _outcome(pieced.run(rounds=2)) == _outcome(whole.run(rounds=2))
    assert torch.equal(pieced.generator.get_state(), whole.generator.get_state())


def test_restore_by_pieces(tmp_path):
    """A solver by pieces restored from a snapshot of the whole table's run
    repeats its last round bit for bit."""
    whole = CutSolver(_spar020(), _cfg("random"), device="cpu", _pieces=False)
    hist = whole.run(rounds=2)
    first = CutSolver(_spar020(), _cfg("random"), device="cpu", _pieces=False)
    first.run(rounds=1)
    first.checkpoint(str(tmp_path / "r1.ck"))
    pieced = CutSolver(_spar020(), _cfg("random"), device="cpu", _pieces=97)
    pieced.restore(str(tmp_path / "r1.ck"))
    assert _outcome(pieced.run(rounds=1)) == _outcome(hist)


@pytest.mark.parametrize("strategy,name,rounds", [
    ("triangle", "spar020-100-1", 3), ("triangle", "spar030-100-1", 2),
    ("optimality", "spar020-100-1", 2)])
def test_pieces_match_the_jax_package(strategy, name, rounds):
    """By pieces against the JAX package's CutSolver at rtol 2e-3 a round."""
    inst = load_or_generate(name, data_dir="data/boxqp")
    cfg = _cfg(strategy)
    got = CutSolver(inst, cfg, device="cpu", _pieces=383).run(rounds=rounds)
    _assert_rounds_match(got, JaxCutSolver(inst, cfg).run(rounds=rounds))
    assert got[0].cuts_added > 0


# ---- the streamed flat selection (four candidates a triple) ---------------------

N = 30                                   # C(30, 3) = 4,060 triples, 16,240 flat candidates
KINDS = ["normal", "ties", "minus_inf", "few_finite", "none_finite"]


def _flat_scores(kind: str, seed: int) -> np.ndarray:
    """numpy-seeded float32 (T, 4) scores of one kind."""
    rng = np.random.default_rng(seed)
    T = math.comb(N, 3)
    s = rng.standard_normal((T, 4)).astype(np.float32)
    if kind == "ties":                  # a few levels: ties of thousands at the top
        s = rng.integers(0, 4, (T, 4)).astype(np.float32) * 0.25
    elif kind == "minus_inf":
        s[rng.random((T, 4)) < 0.7] = -np.inf
        s[1000:1800] = -np.inf
    elif kind == "few_finite":
        s[:] = -np.inf
        s.reshape(-1)[rng.choice(4 * T, 7, replace=False)] = rng.standard_normal(7)
    elif kind == "none_finite":
        s[:] = -np.inf
    return s


def _streamed_flat(scores: torch.Tensor, S: int, cap: int, base: int = 0):
    """The flat selection fed by first-index pieces of at most ``cap`` rows,
    the table's global rows shifted by ``base``."""
    sel = ttri.triangle_selection(S, "cpu")
    sub = combinations_table_on(N, 2, "cpu")
    for i0, i1, offset, rows in first_index_pieces(N, 3, cap):
        sel.add(scores[offset:offset + rows].reshape(-1),
                combinations_rows_on(N, 3, i0, i1, "cpu", sub), 4 * (base + offset))
    return sel.result(), sel.most


@pytest.mark.parametrize("cap", [1, 7, 1000])
@pytest.mark.parametrize("kind", KINDS)
def test_streamed_flat_is_masked_topk(kind, cap):
    """masked_topk(scores.reshape(-1), 20)'s values, flat indices and
    validity bit for bit, and the picks' triples; at most 20 survivors kept
    between pieces."""
    s = torch.as_tensor(_flat_scores(kind, KINDS.index(kind)))
    table = torch.as_tensor(combinations_table(N, 3))
    want = masked_topk(s.reshape(-1), 20)
    (vals, idx, valid, rows), _ = _streamed_flat(s, 20, cap)
    assert idx.dtype == torch.int64
    assert torch.equal(vals, want[0]) and torch.equal(idx, want[1])
    assert torch.equal(valid, want[2]) and torch.equal(rows, table[want[1] // 4])


@pytest.mark.parametrize("kind", ["normal", "ties", "few_finite"])
def test_streamed_flat_offsets_past_2_31(kind):
    """Global flat indices past 2^31 (the table's rows shifted by 2^30 + 7,
    as at n = 2048, where 4 T passes 2^32): the same picks, shifted."""
    s = torch.as_tensor(_flat_scores(kind, 40 + KINDS.index(kind)))
    base = (1 << 30) + 7
    want = masked_topk(s.reshape(-1), 20)
    (vals, idx, valid, _), _ = _streamed_flat(s, 20, 97, base)
    assert int(idx.min()) >= 4 * base > 2 ** 31
    assert torch.equal(vals, want[0]) and torch.equal(valid, want[2])
    assert torch.equal(idx - 4 * base, want[1])


@pytest.mark.parametrize("tied", [False, True])
def test_triangle_by_pieces_is_the_whole_selection(tied):
    """triangle_add_piece over pieces then triangle_cut_rows give
    triangle_select_and_generate's rows bit for bit at a numpy point
    (``tied``: violations on a grid of 1/4, ties at the top)."""
    n = 20
    rng = np.random.default_rng(3)
    x = rng.random(n)
    X = np.clip(np.outer(x, x) + 0.3 * rng.standard_normal((n, n)), 0, 1)
    if tied:
        x, X = np.round(4 * x) / 4, np.round(4 * X) / 4
    x, X = torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(0.5 * (X + X.T),
                                                                      dtype=torch.float32)
    table = torch.as_tensor(combinations_table(n, 3))
    want = ttri.triangle_select_and_generate(x, X, table, 30, 1e-4)
    for cap in (1, 40, 10 ** 6):
        sel = ttri.triangle_selection(30, "cpu")
        for _, _, offset, rows in first_index_pieces(n, 3, cap):
            ttri.triangle_add_piece(sel, x, X, table[offset:offset + rows], offset)
        assert _same(ttri.triangle_cut_rows(x, sel, 1e-4), want)


# ---- optimality's ADMM by pieces ---------------------------------------------------

def _admm_point(n: int, seed: int):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n))
    x = rng.random(n)
    X = np.clip(np.outer(x, x) + 0.2 * rng.standard_normal((n, n)), 0, 1)
    return [torch.as_tensor(a, dtype=torch.float32)
            for a in (10.0 * (Q + Q.T), x, 0.5 * (X + X.T))]


def test_admm_scores_by_pieces_are_one_call(monkeypatch):
    """exact_score_fn over runs of rows (whole eigh chunks, and runs that
    split a chunk) gives one call's scores bit for bit; it keeps no
    (T, 3, 3) block between calls."""
    monkeypatch.setattr(tlab, "EIGH_CHUNK", 64)
    n = 14
    Q, x, X = _admm_point(n, 8)
    table = torch.as_tensor(combinations_table(n, 3))
    whole = tlab.exact_score_fn(Q, table, iters=40)
    want = whole(x, X)
    assert not any(isinstance(c.cell_contents, torch.Tensor) and c.cell_contents.dim() == 3
                   for c in whole.__closure__)
    fn = tlab.exact_score_fn(Q, iters=40)
    for rows in (128, 100, 1000):
        got = torch.cat([fn(x, X, rows=table[o:o + c]) for *_, o, c in range_pieces(n, 3, rows)])
        assert torch.equal(got, want)


def test_optimality_with_fewer_improving_blocks_than_picks():
    """Where fewer than sel_size blocks improve (x x^T at every other pair,
    one pair at its upper bound: its n - 2 triples), the threshold falls
    below 0; the picks and cut rows stay the whole table's, bit for bit.
    StreamedTopk's dominance rules bound the zero rows by C(m + k, k),
    m = k (sel_size - 1) (the floor), but at n = 20 every index lies below
    m + k = 60 and no packing fits (choose_cores), so every row survives:
    the survivors are the table, within that bound
    (tests/test_torch_survivors.py holds the rules where they drop rows)."""
    inst = _spar020()
    n = inst.n
    cfg = _cfg("optimality")
    whole = CutSolver(inst, cfg, device="cpu", _pieces=False)
    pieced = CutSolver(inst, cfg, device="cpu", _pieces=383)
    x = torch.as_tensor(np.random.default_rng(2).uniform(0.2, 0.8, n), dtype=torch.float32)
    X = torch.outer(x, x)
    i, j = np.unravel_index(np.argmax(inst.Q - 1e9 * np.eye(n)), inst.Q.shape)
    X[i, j] = X[j, i] = torch.minimum(x[i], x[j])
    scores = whole._scores(x, X)
    improving = int((scores > 0).sum())
    assert 0 < improving < cfg.cuts.sel_size
    want = tsolver.select_and_generate(x, X, whole.table, scores, cfg.cuts)
    rows, sel = pieced._select_pieces(x, X)
    assert _same(rows, want[0])
    assert torch.equal(sel.result()[1], want[1])
    m = 3 * (cfg.cuts.sel_size - 1)
    assert choose_cores(n, 3, cfg.cuts.sel_size) == () and n <= m + 3
    assert sel.most == whole.table.shape[0] <= math.comb(m + 3, 3)


# ---- the rows of any run of the table --------------------------------------------

@pytest.mark.parametrize("n,k,rows", [(20, 3, 97), (30, 3, 1), (12, 4, 30), (9, 2, 5),
                                      (40, 3, 8192), (30, 3, 10 ** 6)])
def test_rows_of_any_run_are_the_table(n, k, rows):
    """range_pieces cover the table once in runs of ``rows`` rows (offsets
    multiples of it) and combinations_range_on writes each run's rows;
    on whole first indices it writes combinations_rows_on's."""
    table = combinations_table(n, k)
    sub = combinations_table_on(n, k - 1, "cpu")
    pieces = range_pieces(n, k, rows)
    got = torch.cat([combinations_range_on(n, k, o, o + c, "cpu", sub) for *_, o, c in pieces])
    np.testing.assert_array_equal(got.numpy(), table)
    for i0, i1, o, c in pieces:
        assert o % rows == 0 and c <= rows
        assert table[o, 0] == i0 and table[o + c - 1, 0] == i1 - 1
    for i0, i1, o, c in first_index_pieces(n, k, rows):
        assert torch.equal(combinations_range_on(n, k, o, o + c, "cpu", sub),
                           combinations_rows_on(n, k, i0, i1, "cpu", sub))
    assert combinations_range_on(n, k, 5, 5, "cpu").shape == (0, k)
    with pytest.raises(ValueError):
        combinations_range_on(n, k, 0, math.comb(n, k) + 1, "cpu")
    with pytest.raises(ValueError):
        range_pieces(n, k, 0)


# ---- the route by n ---------------------------------------------------------------

@pytest.mark.parametrize("strategy", PIECEWISE)
def test_route_past_the_table_at_n_4096(strategy):
    """At generate_spar(4096, 100, 1) each strategy goes by pieces (its own
    size) and holds no table: no (T, ·) tensor, no (T, 3, 3) block."""
    inst = generate_spar(4096, 100, 1)
    solver = CutSolver(inst, _cfg(strategy), device="cpu")
    assert solver.table is None and solver.pieces
    assert sum(p[3] for p in solver.pieces) == math.comb(4096, 3)
    cap = (tsolver.OPTIMALITY_PIECE_ROWS if strategy == "optimality" else tsolver.PIECE_ROWS)
    assert max(p[3] for p in solver.pieces) <= cap
    if strategy == "optimality":
        assert cap % tlab.EIGH_CHUNK == 0
        assert all(p[2] % tlab.EIGH_CHUNK == 0 for p in solver.pieces)
    big = [v for v in vars(solver).values() if isinstance(v, torch.Tensor)
           and v.shape and v.shape[0] > 4096 * 4096]
    assert not big
    closure = getattr(getattr(solver, "_exact", None), "__closure__", None) or ()
    assert not any(isinstance(c.cell_contents, torch.Tensor) and c.cell_contents.dim() == 3
                   for c in closure)


@pytest.mark.parametrize("strategy", PIECEWISE)
def test_route_by_strategy_threshold(strategy, monkeypatch):
    """Each strategy's threshold at k = 3 (``PIECE_N_OF[strategy, 3]``)
    decides its route: at n = 20 whole at a threshold of 20, by pieces at
    19; a custom score_fn and k = 2 keep the whole table, and k = 4 takes
    its own route (tests/test_torch_kpieces.py); the thresholds lie below
    PIECE_N (their whole routes hold more a row than the kernel-scored
    ones')."""
    assert tsolver.PIECE_N_OF[strategy, 3] < tsolver.PIECE_N
    inst = _spar020()
    monkeypatch.setitem(tsolver.PIECE_N_OF, (strategy, 3), 20)
    solver = CutSolver(inst, _cfg(strategy), device="cpu")
    assert solver.pieces is None and solver.table.shape == (1140, 3)
    monkeypatch.setitem(tsolver.PIECE_N_OF, (strategy, 3), 19)
    assert CutSolver(inst, _cfg(strategy), device="cpu").table is None
    custom = CutSolver(inst, _cfg("custom"), device="cpu", _pieces=50,
                       score_fn=lambda x, X, g: torch.zeros(1140))
    assert custom.pieces is None
    if strategy != "triangle":
        k2 = dataclasses.replace(_cfg(strategy), cuts=CutConfig(k=2))
        assert CutSolver(inst, k2, device="cpu", _pieces=50).pieces is None
        k4 = dataclasses.replace(_cfg(strategy), cuts=CutConfig(k=4))
        assert CutSolver(inst, k4, device="cpu", _pieces=50).pieces == range_pieces(20, 4, 50)
