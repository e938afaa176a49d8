"""``ops/topk.py``'s StreamedTopk with its dominance rules (the floor and
the packings of each core size) against the whole table's ``diverse_topk``
bit for bit (values, global indices, validity, rows) and against the JAX
package's ``diverse_topk``, on numpy-seeded scores fed in pieces of random
lengths: all tied at 0, fewer positive scores than picks with zeros
elsewhere, uniform distinct scores, ties at non-zero values, and a mix with
-inf, at kk = 3, 4, 5 and small sel_size, so that every rule drops rows on
tables of a few thousand rows; offsets past 2^31; the tied case's survivors
bounded by C(m + kk, kk) whatever n, and its picks the lexicographic
disjoint rows; and CutSolver's round by pieces against the whole table
where fewer rows improve than are picked (optimality) and on an all-zero
MLP (neural).  torch runs on one thread here."""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpcutsel_tpu.ops.topk import diverse_topk as jax_diverse_topk
from sdpcutsel_tpu_torch.config import CutConfig, LPConfig, RunConfig, ScorerConfig
from sdpcutsel_tpu_torch.cuts.enumerate import combinations_table
from sdpcutsel_tpu_torch.instances import load_or_generate
from sdpcutsel_tpu_torch.loop import CutSolver
from sdpcutsel_tpu_torch.loop import solver as tsolver
from sdpcutsel_tpu_torch.models.scorer import load_params
from sdpcutsel_tpu_torch.ops import topk
from sdpcutsel_tpu_torch.ops.topk import StreamedTopk, choose_cores, diverse_topk

KINDS = ["zeros", "few_positive", "uniform", "ties", "minus_inf"]
ALPHA = 0.05            # tau's band: 0.05 m of the scores' range, so that the packings work
# (kk, S) and, for each core size c, an n at which its packing applies:
# n >= c + (kk - c)(m + 1), m = kk (S - 1)
SIZES = {3: (3, {0: 24, 1: 20, 2: 40}), 4: (3, {0: 38, 1: 30, 2: 24, 3: 16}),
         5: (2, {0: 32, 1: 28, 2: 24, 3: 20, 4: 14})}
CASES = [(kk, c) for kk, (_, ns) in SIZES.items() for c in ns]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scores(kind: str, T: int, S: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return np.zeros(T, np.float32)
    if kind == "few_positive":          # S - 1 rows score above 0, the rest 0
        s = np.zeros(T, np.float32)
        s[rng.choice(T, S - 1, replace=False)] = rng.uniform(0.5, 1.5, S - 1)
        return s
    if kind == "uniform":               # distinct, uniform on [0, 1): random's band
        s = rng.permutation(T).astype(np.float32) / np.float32(T)
        return s
    if kind == "ties":                  # four levels, ties of thousands at the top
        return (rng.integers(1, 5, T) * 0.25).astype(np.float32)
    s = rng.random(T).astype(np.float32)    # minus_inf: half the rows -inf
    s[rng.random(T) < 0.5] = -np.inf
    return s


def _streamed(scores, table, S: int, alpha: float, seed: int, n: int, base: int = 0):
    """StreamedTopk (with the table's n) fed pieces of numpy-seeded random
    lengths (1 to a fifth of the table), the global rows shifted by
    ``base``."""
    rng = np.random.default_rng(seed)
    T, kk = table.shape
    sel = StreamedTopk(S, alpha, kk, "cpu", n=n)
    at = 0
    while at < T:
        r = int(rng.integers(1, max(2, T // 5)))
        sel.add(scores[at:at + r], table[at:at + r], base + at)
        at += r
    return sel


def _same(sel, want, table, base: int = 0) -> bool:
    vals, idx, valid, rows = sel.result()
    return (torch.equal(vals, want[0]) and torch.equal(idx - base, want[1])
            and torch.equal(valid, want[2]) and torch.equal(rows, table[want[1]]))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kk,c", CASES)
def test_each_core_size_is_the_whole_table(kk, c, kind, monkeypatch):
    """The packings of core size c alone (REBUILD_MIN and REBUILD_MIN_WIDE
    8, so that they are built on a table of thousands of rows), with the
    floor, give
    diverse_topk's picks on the whole table bit for bit, for two piece
    cuts; on uniform scores the packing is built and drops rows of tau's
    band."""
    S, ns = SIZES[kk]
    n = ns[c]
    monkeypatch.setattr(topk, "REBUILD_MIN", 8)
    monkeypatch.setattr(topk, "REBUILD_MIN_WIDE", 8)
    monkeypatch.setattr(topk, "choose_cores", lambda *a: (c,))
    table = torch.as_tensor(combinations_table(n, kk))
    T = table.shape[0]
    scores = torch.as_tensor(_scores(kind, T, S, 7 * kk + c + KINDS.index(kind)))
    want = diverse_topk(scores, table, S, ALPHA)
    for seed in (0, 1):
        sel = _streamed(scores, table, S, ALPHA, seed, n)
        assert [p.c for p in sel.packs] == [c]
        assert _same(sel, want, table)
    if kind == "uniform":
        top = torch.topk(scores, S).values[-1]
        band = int((scores >= top - torch.tensor([kk * (S - 1)], dtype=torch.float32)
                    * ALPHA).sum())
        assert sel.packs[0].built and sel.vals.numel() < band


@pytest.mark.parametrize("kk,c", [(3, 0), (4, 1), (5, 2)])
def test_the_greedy_takes_the_same_members_several_a_step(kk, c, monkeypatch):
    """The packings' greedy taking up to ACCEPTS = 4 members a core a step,
    in windows of a few entries (CORE_STEP 64), builds the packings (every
    core's threshold, top and reach) of the one-member-a-step greedy, and
    so keeps the same survivors."""
    S, ns = SIZES[kk]
    n = ns[c]
    monkeypatch.setattr(topk, "REBUILD_MIN", 8)
    monkeypatch.setattr(topk, "REBUILD_MIN_WIDE", 8)
    monkeypatch.setattr(topk, "CORE_STEP", 64)
    monkeypatch.setattr(topk, "choose_cores", lambda *a: (c,))
    table = torch.as_tensor(combinations_table(n, kk))
    scores = torch.as_tensor(_scores("uniform", table.shape[0], S, 40 + kk))
    got = []
    for accepts in (1, 4):
        monkeypatch.setattr(topk, "ACCEPTS", accepts)
        sel = _streamed(scores, table, S, ALPHA, 6, n)
        p = sel.packs[0]
        got.append((p.thr, p.top, p.reach, sel.vals, sel.idx, sel.most))
    assert bool((got[0][0] > -torch.inf).any())
    assert all(torch.equal(a, b) for a, b in zip(got[0][:5], got[1][:5]))
    assert got[0][5] == got[1][5]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kk", [3, 4, 5])
def test_default_rules_give_the_jax_packages_picks(kk, kind):
    """With the default constants and core sizes (choose_cores), at the
    largest n of SIZES and alpha 0.05 and 1e-4: the whole table's picks bit
    for bit and the JAX package's diverse_topk's indices, values and
    validity."""
    S, ns = SIZES[kk]
    n = max(ns.values())
    table = combinations_table(n, kk)
    s = _scores(kind, table.shape[0], S, 50 + 3 * kk + KINDS.index(kind))
    for alpha in (ALPHA, 1e-4):
        want = diverse_topk(torch.as_tensor(s), torch.as_tensor(table), S, alpha)
        sel = _streamed(torch.as_tensor(s), torch.as_tensor(table), S, alpha, 2, n)
        assert _same(sel, want, torch.as_tensor(table))
        jv, js, jok = jax_diverse_topk(jnp.asarray(s), jnp.asarray(table), S, n, alpha)
        vals, idx, valid, _ = sel.result()
        np.testing.assert_array_equal(idx.numpy(), np.asarray(js))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jok))


@pytest.mark.parametrize("kind", ["zeros", "few_positive", "uniform"])
def test_offsets_past_2_31(kind, monkeypatch):
    """Global indices past 2^31 (the table's rows shifted by 2^31 + 5): the
    floor and the packings hold with the shifted indices; the same picks,
    shifted."""
    monkeypatch.setattr(topk, "REBUILD_MIN", 8)
    monkeypatch.setattr(topk, "REBUILD_MIN_WIDE", 8)
    S, ns = SIZES[3]
    n = ns[0]
    table = torch.as_tensor(combinations_table(n, 3))
    scores = torch.as_tensor(_scores(kind, table.shape[0], S, 90 + KINDS.index(kind)))
    base = 2 ** 31 + 5
    want = diverse_topk(scores, table, S, ALPHA)
    sel = _streamed(scores, table, S, ALPHA, 3, n, base)
    assert sel.result()[1].dtype == torch.int64 and int(sel.result()[1].min()) >= base
    assert _same(sel, want, table, base)


@pytest.mark.parametrize("kk", [3, 4, 5])
def test_all_tied_survivors_do_not_grow_with_n(kk):
    """All scores 0: the floor keeps exactly the C(m + kk, kk) rows with
    every index below m + kk (the docstring's bound), at two n; the picks
    are the lexicographic disjoint rows (0..kk-1), (kk..2 kk - 1), ...,
    the whole table's."""
    S = SIZES[kk][0]
    m = kk * (S - 1)
    bound = math.comb(m + kk, kk)
    most = []
    for n in (m + kk + 4, m + kk + 9):
        table = torch.as_tensor(combinations_table(n, kk))
        scores = torch.zeros(table.shape[0])
        sel = _streamed(scores, table, S, 1e-4, n, n)
        most.append(sel.most)
        assert _same(sel, diverse_topk(scores, table, S, 1e-4), table)
        picks = sel.result()[3]
        assert torch.equal(picks, torch.arange(S * kk, dtype=torch.int32).reshape(S, kk))
    assert most[0] == most[1] == bound < math.comb(m + kk + 4, kk)


def test_cap_raises_where_no_rule_applies(monkeypatch):
    """Where n leaves no core size and no row reaches the floor's m + kk
    (n = 10, kk = 4, S = 5: m + kk = 20), every zero row survives and a cap
    below the table raises; at the table the run goes on."""
    table = torch.as_tensor(combinations_table(10, 4))
    scores = torch.zeros(table.shape[0])
    assert choose_cores(10, 4, 5) == ()
    monkeypatch.setattr(topk, "SURVIVOR_CAP", 100)
    sel = StreamedTopk(5, 1e-4, 4, "cpu", n=10)
    with pytest.raises(RuntimeError, match="cap of 100"):
        for at in range(0, table.shape[0], 60):
            sel.add(scores[at:at + 60], table[at:at + 60], at)


def test_the_table_n_is_required_where_the_rules_apply():
    """At alpha > 0 and one candidate a row the rules need the table's n:
    without it StreamedTopk refuses; the running top S (alpha 0) and
    triangle's flat selection (group 4) take none."""
    with pytest.raises(ValueError, match="the table's n"):
        StreamedTopk(5, 1e-4, 3, "cpu")
    assert not StreamedTopk(5, 0.0, 3, "cpu").prune
    assert not StreamedTopk(5, 0.0, 3, "cpu", group=4).prune


@pytest.mark.parametrize("start", [0, 1, 37])
def test_the_floor_is_off_unless_the_first_row_is_the_tables(start):
    """Pieces of C(14, 3) all at 0 from row ``start`` on: from row 0 the
    floor drops rows; from a later row (whose faces were never seen) it is
    off, and the picks are still diverse_topk's over the rows given, bit for
    bit, at their global indices."""
    S, n = 3, 14
    full = torch.as_tensor(combinations_table(n, 3))
    table = full[start:]
    scores = torch.zeros(table.shape[0])
    want = diverse_topk(scores, table, S, 1e-4)
    sel = _streamed(scores, table, S, 1e-4, 5, n, base=start)
    assert sel.floor == (start == 0)
    assert _same(sel, want, table, base=start)
    assert (sel.most < table.shape[0]) == (start == 0)


def test_choose_cores():
    """The core sizes the docstring names: c = 0 (and 1) at k = 3, n =
    2100; c = 2 alone at k = 5, n = 330; none where no packing fits."""
    assert choose_cores(2100, 3, 20) == (0, 1)
    assert choose_cores(330, 5, 20) == (2,)
    assert choose_cores(99, 5, 20) == () and choose_cores(100, 5, 20) == (4,)
    for n, kk, S in itertools.product((20, 40, 330), (3, 4, 5), (2, 3, 20)):
        m = kk * (S - 1)
        for c in choose_cores(n, kk, S):
            assert n - c >= (kk - c) * (m + 1) and math.comb(n, c) <= topk.CORE_COUNT


# ---- CutSolver's round by pieces ------------------------------------------------

def _cfg(strategy: str, weights: str | None = None) -> RunConfig:
    return RunConfig(lp=LPConfig(max_iters=6000, tol=1e-5), cuts=CutConfig(sel_size=3),
                     scorer=ScorerConfig(strategy=strategy, weights_path=weights))


def _point(n: int, seed: int):
    x = torch.as_tensor(np.random.default_rng(seed).uniform(0.2, 0.8, n), dtype=torch.float32)
    return x, torch.outer(x, x)


def _round_by_pieces_is_whole(cfg) -> tuple:
    inst = load_or_generate("spar020-100-1", data_dir="data/boxqp")
    whole = CutSolver(inst, cfg, device="cpu", _pieces=False)
    pieced = CutSolver(inst, cfg, device="cpu", _pieces=97)
    x, X = _point(inst.n, 4)
    scores = whole._scores(x, X)
    want = tsolver.select_and_generate(x, X, whole.table, scores, cfg.cuts)
    rows, sel = pieced._select_pieces(x, X)
    same = (len(rows) == len(want[0])
            and all(torch.equal(a, b) for a, b in zip(rows, want[0]))
            and torch.equal(sel.result()[1], want[1]))
    return same, sel, scores


def test_optimality_with_fewer_improving_blocks_than_picks():
    """Optimality at x x^T (no block improves: every score 0, fewer than
    sel_size 3 above 0): the round by pieces gives the whole table's picks
    and cut rows bit for bit, and the floor keeps C(m + 3, 3) = 84 of
    C(20, 3) = 1,140 rows."""
    same, sel, scores = _round_by_pieces_is_whole(_cfg("optimality"))
    assert int((scores > 0).sum()) < 3 and bool((scores == 0).all())
    assert same
    assert sel.most == math.comb(3 * 2 + 3, 3)


def test_neural_on_an_all_zero_mlp(tmp_path):
    """Neural on an MLP of zero weights (every score scale relu(0) = 0):
    the round by pieces gives the whole table's picks and cut rows bit for
    bit, and the floor keeps C(m + 3, 3) = 84 rows."""
    path = tmp_path / "mlp_k3_zero.npz"
    np.savez(path, **{k: np.zeros_like(v) for k, v in load_params(3).items()})
    same, sel, scores = _round_by_pieces_is_whole(_cfg("neural", str(path)))
    assert bool((scores == 0).all())
    assert same
    assert sel.most == math.comb(3 * 2 + 3, 3)
