"""BoxQP at k = 4 and 5 by pieces of the candidate table (``loop/solver.py``'s
piecewise route past ``PIECE_N_OF[strategy, k]``): the rows of any run of
C(n, k) written from the pair table (``cuts/enumerate.py``) against
``combinations_table``; ``StreamedTopk`` with kk = 4 and 5 against
``diverse_topk`` and ``masked_topk`` on numpy-seeded scores (ties, -inf,
fewer finite scores than picks, pieces of random lengths, offsets past
2^31); CutSolver with the route forced (the private ``_pieces``) against
the whole table bit for bit (picks, cut rows, pool, certificates, state,
generator), k = 4 neural by pieces against the JAX package at rtol 2e-3;
and the route by (strategy, k).  torch runs on one thread here."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from sdpcutsel_tpu.loop import CutSolver as JaxCutSolver
from sdpcutsel_tpu_torch.config import CutConfig, LPConfig, RunConfig, ScorerConfig
from sdpcutsel_tpu_torch.cuts.enumerate import (combinations_range_on, combinations_table,
                                                combinations_table_on, range_pieces)
from sdpcutsel_tpu_torch.instances import generate_spar, load_or_generate
from sdpcutsel_tpu_torch.loop import CutSolver
from sdpcutsel_tpu_torch.loop import solver as tsolver
from sdpcutsel_tpu_torch.ops.fused_score import launch_ranges, offset_refusal
from sdpcutsel_tpu_torch.ops.topk import StreamedTopk, diverse_topk, masked_topk
from test_torch_portmods import reference_config

LP = LPConfig(max_iters=6000, tol=1e-5)      # tests/test_torch_solver_k4.py's neural settings


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the rows of any run, from the pair table ---------------------------------------

RANGE_CASES = [(n, k, seed) for k, ns in ((2, (9, 40)), (3, (12, 30)), (4, (9, 20, 31)),
                                          (5, (10, 18, 26))) for n in ns for seed in (0, 1)]


@pytest.mark.parametrize("n,k,seed", RANGE_CASES)
def test_range_from_the_pair_table_is_the_table(n, k, seed):
    """combinations_range_on over numpy-seeded runs (most of them across
    first indices, the empty run, the whole table) equals
    combinations_table(n, k)[start:stop] bit for bit, from the pair table
    (the default) and from the table of every width below k."""
    table = combinations_table(n, k)
    T = table.shape[0]
    rng = np.random.default_rng(100 * k + n + seed)
    runs = [tuple(sorted(rng.integers(0, T + 1, 2).tolist())) for _ in range(12)]
    runs += [(0, T), (T // 2, T // 2), (T - 1, T)]
    subs = [None, *(combinations_table_on(n, w, "cpu") for w in range(1, k))]
    crossing = 0
    for a, b in runs:
        want = table[a:b]
        crossing += b > a and want[0, 0] != want[-1, 0]
        for sub in subs:
            got = combinations_range_on(n, k, a, b, "cpu", sub)
            assert got.dtype == torch.int32 and got.shape == (b - a, k)
            np.testing.assert_array_equal(got.numpy(), want)
    assert crossing >= 5


def test_range_refuses_bad_arguments():
    with pytest.raises(ValueError):
        combinations_range_on(20, 4, 0, math.comb(20, 4) + 1, "cpu")
    with pytest.raises(ValueError):                 # a table of width k is not below k
        combinations_range_on(20, 4, 0, 5, "cpu", combinations_table_on(20, 4, "cpu"))
    with pytest.raises(ValueError):                 # another n's pair table
        combinations_range_on(20, 4, 0, 5, "cpu", combinations_table_on(19, 2, "cpu"))
    with pytest.raises(ValueError):                 # past int64
        combinations_range_on(46340, 5, 0, 5, "cpu")


def test_range_past_2_31_rows():
    """Runs of C(512, 4) = 2,829,877,120 rows past row 2^31 (int64 row
    numbers) and C(200, 5)'s last rows, held to the rows' definition: each
    row sorted, within [0, n), and the successor of the one before in
    lexicographic order."""
    for n, k, start in ((512, 4, 2 ** 31 - 3), (200, 5, math.comb(200, 5) - 2000)):
        got = combinations_range_on(n, k, start, start + 2000, "cpu").numpy().astype(np.int64)
        assert (np.diff(got, axis=1) > 0).all() and got.min() >= 0 and got.max() < n
        assert all(_successor(u, n) == tuple(v) for u, v in zip(got[:-1], got[1:]))
    assert tuple(got[-1]) == tuple(range(195, 200))


def _successor(row, n: int) -> tuple:
    row, k = list(row), len(row)
    i = k - 1
    while row[i] == n - k + i:
        i -= 1
    row[i] += 1
    for j in range(i + 1, k):
        row[j] = row[j - 1] + 1
    return tuple(row)


# ---- the streamed selection at kk = 4 and 5 ------------------------------------------

KINDS = ["normal", "ties", "minus_inf", "few_finite", "none_finite"]
SEL = {4: (14, 20), 5: (12, 10)}          # kk: (n of the table, picks)


def _scores(kind: str, T: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    s = rng.standard_normal(T).astype(np.float32)
    if kind == "ties":                  # a few levels: ties of hundreds at the top
        s = rng.integers(0, 4, T).astype(np.float32) * 0.25
    elif kind == "minus_inf":
        s[rng.random(T) < 0.7] = -np.inf
        s[100:400] = -np.inf
    elif kind == "few_finite":          # fewer finite scores than picks
        s[:] = -np.inf
        s[rng.choice(T, 7, replace=False)] = rng.standard_normal(7).astype(np.float32)
    elif kind == "none_finite":
        s[:] = -np.inf
    return s


def _streamed(scores, table, S: int, alpha: float, seed: int, base: int = 0):
    """StreamedTopk fed pieces of numpy-seeded random lengths (1 to a fifth
    of the table), the global rows shifted by ``base``."""
    rng = np.random.default_rng(seed)
    T, kk = table.shape
    sel = StreamedTopk(S, alpha, kk, "cpu", n=int(table.max()) + 1)
    at = 0
    while at < T:
        r = int(rng.integers(1, max(2, T // 5)))
        sel.add(scores[at:at + r], table[at:at + r], base + at)
        at += r
    return sel.result(), sel.most


@pytest.mark.parametrize("alpha", [1e-4, 0.0])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kk", [4, 5])
def test_streamed_at_kk(kk, kind, alpha):
    """Pieces of random lengths give diverse_topk's (alpha 1e-4) or
    masked_topk's (alpha 0) values, indices and validity bit for bit over
    C(n, kk), and the table's rows of the picks; a -inf pick is row 0,
    0..kk-1, as on the whole table."""
    n, S = SEL[kk]
    table = torch.as_tensor(combinations_table(n, kk))
    scores = torch.as_tensor(_scores(kind, table.shape[0], 10 * kk + KINDS.index(kind)))
    want = (diverse_topk(scores, table, S, alpha) if alpha > 0 else masked_topk(scores, S))
    for seed in (0, 1):
        (vals, idx, valid, rows), _ = _streamed(scores, table, S, alpha, seed)
        assert torch.equal(vals, want[0]) and torch.equal(idx, want[1])
        assert torch.equal(valid, want[2]) and torch.equal(rows, table[want[1]])
    if kind == "none_finite" and alpha > 0:
        assert torch.equal(rows, torch.arange(kk, dtype=torch.int32).expand(S, kk))


@pytest.mark.parametrize("kk", [4, 5])
def test_streamed_offsets_past_2_31(kk):
    """Global indices past 2^31 (the table's rows shifted by 2^31 + 5, as in
    C(512, 4)): the same picks, shifted, and the same rows."""
    n, S = SEL[kk]
    table = torch.as_tensor(combinations_table(n, kk))
    scores = torch.as_tensor(_scores("ties", table.shape[0], 70 + kk))
    base = 2 ** 31 + 5
    want = diverse_topk(scores, table, S, 1e-4)
    (vals, idx, valid, rows), _ = _streamed(scores, table, S, 1e-4, 3, base)
    assert idx.dtype == torch.int64 and int(idx.min()) >= base
    assert torch.equal(idx - base, want[1]) and torch.equal(vals, want[0])
    assert torch.equal(rows, table[want[1]])


def test_streamed_cap_raises(monkeypatch):
    """Past SURVIVOR_CAP survivors add raises (zero scores below alpha P:
    every row survives, as no dominance rule prunes C(10, 4) at S = 5: no
    packing fits and every index lies below the floor's m + kk = 20),
    never changing a pick; at the cap it keeps going."""
    from sdpcutsel_tpu_torch.ops import topk
    table = torch.as_tensor(combinations_table(10, 4))
    scores = torch.zeros(table.shape[0])
    assert topk.choose_cores(10, 4, 5) == () and 10 <= 4 * 4 + 4
    monkeypatch.setattr(topk, "SURVIVOR_CAP", table.shape[0])
    sel = StreamedTopk(5, 1e-4, 4, "cpu", n=10)
    sel.add(scores, table, 0)
    assert sel.most == table.shape[0]
    monkeypatch.setattr(topk, "SURVIVOR_CAP", 100)
    sel = StreamedTopk(5, 1e-4, 4, "cpu", n=10)
    with pytest.raises(RuntimeError, match="cap of 100"):
        for at in range(0, table.shape[0], 60):
            sel.add(scores[at:at + 60], table[at:at + 60], at)


# ---- K4's launches over a piece ---------------------------------------------------------

@pytest.mark.parametrize("k", [4, 5])
def test_k4_launches_over_a_piece(k):
    """K4 reads triQ's k (k + 1) / 2 words a row at 32-bit offsets: a
    default piece is one launch; a 2^27-row piece at k = 5 (2,013,265,920
    words, under 2^31) one launch, and 2^28 rows two, each under 2^31
    words, in order: split, never refused."""
    w = k * (k + 1) // 2
    R = tsolver.PIECE_ROWS_WIDE[k]
    assert launch_ranges(R, w) == [(0, R)] and offset_refusal("fused_score", R, w) is None
    assert launch_ranges(1 << 27, w) == [(0, 1 << 27)]
    parts = launch_ranges(1 << 28, w)
    assert offset_refusal("fused_score", 1 << 28, w) is not None and len(parts) == 2
    assert parts[0][0] == 0 and parts[-1][1] == 1 << 28
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    assert all((e - s) * w < 2 ** 31 for s, e in parts)


# ---- CutSolver by pieces against the whole table --------------------------------------

SOLVES = [(4, "neural", 1000), (4, "feasibility", 777), (4, "combined", 1234),
          (4, "random", 500), (4, "optimality", 1024), (5, "neural", 3000), (5, "random", 999)]


def _cfg(k: int, strategy: str) -> RunConfig:
    return RunConfig(lp=LP, cuts=CutConfig(k=k, sel_size=10 if k == 5 else 20),
                     scorer=ScorerConfig(strategy=strategy))


def _spar020():
    return load_or_generate("spar020-100-1", data_dir="data/boxqp")


def _recorded(solver, rounds: int):
    """The run's history, each round's cut rows (append_cuts's arguments)
    and picks (select_and_generate's on the whole table; StreamedTopk's
    global indices by pieces)."""
    rows, picks = [], []
    append, select, cut_rows = tsolver.append_cuts, tsolver.select_and_generate, None

    def keep_rows(pool, *r):
        rows.append([t.clone() for t in r])
        if solver.pieces is not None:
            picks.append(solver.last_selection.result()[1])
        return append(pool, *r)

    def keep_picks(*a):
        out = select(*a)
        picks.append(out[1])
        return out

    with pytest.MonkeyPatch.context() as m:
        m.setattr(tsolver, "append_cuts", keep_rows)
        m.setattr(tsolver, "select_and_generate", keep_picks)
        hist = solver.run(rounds=rounds)
    del cut_rows
    return hist, rows, picks


def _same(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(torch.as_tensor(u), torch.as_tensor(v))
                                    for u, v in zip(a, b))


@pytest.mark.parametrize("k,strategy,cap", SOLVES)
def test_pieces_repeat_the_whole_table(k, strategy, cap):
    """2 rounds by forced pieces of ``cap`` rows repeat the whole table's
    bit for bit: each round's picks and cut rows, the certificates and the
    rest of the history, the pool, the solver's state and the generator's
    state; the piecewise route holds no table and no features."""
    whole = CutSolver(_spar020(), _cfg(k, strategy), device="cpu", _pieces=False)
    pieced = CutSolver(_spar020(), _cfg(k, strategy), device="cpu", _pieces=cap)
    assert whole.pieces is None and whole.table.shape == (math.comb(20, k), k)
    assert pieced.table is None and len(pieced.pieces) == -(-math.comb(20, k) // cap) > 1
    assert getattr(pieced, "triQ", None) is None and getattr(pieced, "scale", None) is None
    hw, rows_w, picks_w = _recorded(whole, 2)
    hp, rows_p, picks_p = _recorded(pieced, 2)
    assert [dataclasses.astuple(h)[:-1] for h in hp] == [dataclasses.astuple(h)[:-1] for h in hw]
    assert hw[0].cuts_added > 0
    assert len(rows_p) == len(picks_p) == len(picks_w) == 2
    assert all(_same(a, b) for a, b in zip(rows_p, rows_w))
    assert all(torch.equal(a, b) for a, b in zip(picks_p, picks_w))
    p, w = pieced.pool, whole.pool
    assert _same([p.idx, p.lin, p.quad, p.rhs, p.active, p.count],
                 [w.idx, w.lin, w.quad, w.rhs, w.active, w.count])
    assert _same(pieced.state.fields(), whole.state.fields())
    assert torch.equal(pieced.generator.get_state(), whole.generator.get_state())


def test_k4_neural_by_pieces_matches_the_jax_package():
    """k = 4 neural by pieces (of 1,000 rows, C(20, 4) in 5) against the JAX
    package's CutSolver at tests/test_torch_solver_k4.py's settings: 3
    rounds at rtol 2e-3, round 0 with the same LP iterations and cuts."""
    inst = _spar020()
    cfg = RunConfig(lp=LP, cuts=CutConfig(k=4), scorer=ScorerConfig(strategy="neural"))
    got = CutSolver(inst, cfg, device="cpu", _pieces=1000).run(rounds=3)
    ref = JaxCutSolver(inst, reference_config(cfg)).run(rounds=3)
    assert len(got) == len(ref) == 3
    assert got[0].lp_iters == ref[0].lp_iters
    assert got[0].cuts_added == ref[0].cuts_added > 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.bound, r.bound, rtol=2e-3)


# ---- the route by (strategy, k) ------------------------------------------------------

@pytest.mark.parametrize("strategy,k", [(s, k) for k in (4, 5) for s in
                                        ("neural", "feasibility", "combined", "random",
                                         "optimality")])
def test_route_by_strategy_and_k(strategy, k, monkeypatch):
    """The threshold of (strategy, k) decides the route: at n = 20 the whole
    table at a threshold of 20, pieces at 19, whatever the thresholds of
    the other widths; the pieces are range_pieces's runs of
    PIECE_ROWS_WIDE[k] rows (optimality: OPTIMALITY_PIECE_ROWS); k = 2 and a
    custom score_fn
    keep the whole table."""
    inst = _spar020()
    cfg = _cfg(k, strategy)
    other = 3 if k == 5 else 5
    monkeypatch.setitem(tsolver.PIECE_N_OF, (strategy, k), 20)
    monkeypatch.setitem(tsolver.PIECE_N_OF, (strategy, other), 1)
    assert CutSolver(inst, cfg, device="cpu").pieces is None
    monkeypatch.setitem(tsolver.PIECE_N_OF, (strategy, k), 19)
    monkeypatch.setitem(tsolver.PIECE_N_OF, (strategy, other), 10 ** 6)
    solver = CutSolver(inst, cfg, device="cpu")
    rows = (tsolver.OPTIMALITY_PIECE_ROWS if strategy == "optimality"
            else tsolver.PIECE_ROWS_WIDE[k])
    assert solver.table is None and solver.pieces == range_pieces(20, k, rows)
    custom = dataclasses.replace(cfg, scorer=ScorerConfig(strategy="custom"))
    assert CutSolver(inst, custom, device="cpu", _pieces=50,
                     score_fn=lambda x, X, g: torch.zeros(math.comb(20, k))).pieces is None
    k2 = dataclasses.replace(cfg, cuts=CutConfig(k=2))
    assert CutSolver(inst, k2, device="cpu", _pieces=50).pieces is None


@pytest.mark.parametrize("n,k", [(512, 4), (200, 5)])
def test_route_past_the_table(n, k):
    """By default generate_spar(512, 100, 1) at k = 4 (2,829,877,120 rows,
    past 2^31) and generate_spar(200, 5) at k = 5 go by pieces of
    PIECE_ROWS_WIDE[k] rows and hold no tensor of the table; every threshold
    at k = 4, 5 lies below the instance's n and above spar020's."""
    inst = generate_spar(n, 100, 1)
    cfg = RunConfig(cuts=CutConfig(k=k, sel_size=10 if k == 5 else 20))
    solver = CutSolver(inst, cfg, device="cpu")
    assert solver.table is None and solver.pieces
    assert sum(p[3] for p in solver.pieces) == math.comb(n, k)
    assert max(p[3] for p in solver.pieces) == tsolver.PIECE_ROWS_WIDE[k]
    assert not [v for v in vars(solver).values() if isinstance(v, torch.Tensor)
                and v.numel() > n * n + n]
    for (strategy, width), at in tsolver.PIECE_N_OF.items():
        if width == k:
            assert 20 < at < n, (strategy, width, at)
