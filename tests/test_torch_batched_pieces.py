"""The batched BoxQP round by pieces of the candidate table
(sdpcutsel_tpu_torch.parallel.round with ``_pieces`` or a
``CombinationShards`` table) against the whole batched route, bit for bit,
on the CPU twins: picks, cut rows, pools, PDHG states, f32 bounds and the
generators' states, at k = 3, 4, 5 for neural, feasibility, combined and
random, over one shard and over shards with padding and edges inside a
piece of 37 rows (not a multiple of 16).  Also the running top-k against
local_topk, the lazy table's rows against shard_candidates, per-instance
features against the batched ones, the route rule, a distributed rank's
random draws by pieces, and the port by pieces
against the JAX package's whole-table batched round (pools equal,
certificates at rtol 2e-3, tests/test_round_sharded.py's tolerance)."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpcutsel_tpu.parallel.mesh import make_mesh as j_make_mesh
from sdpcutsel_tpu.parallel.round import certify_batched_f64 as j_certify
from sdpcutsel_tpu.parallel.round import init_batched_state as j_init
from sdpcutsel_tpu.parallel.round import make_sharded_round_step as j_step
from sdpcutsel_tpu.parallel.sharding import shard_candidates as j_shard
from sdpcutsel_tpu_torch.config import CutConfig, RunConfig
from sdpcutsel_tpu_torch.cuts.enumerate import combinations_table
from sdpcutsel_tpu_torch.instances import generate_spar
from sdpcutsel_tpu_torch.loop import solver as solver_mod
from sdpcutsel_tpu_torch.models.features import candidate_q_features
from sdpcutsel_tpu_torch.ops.topk import RunningTopk
from sdpcutsel_tpu_torch.parallel import Mesh, make_mesh, shard_candidates
from sdpcutsel_tpu_torch.parallel import round as R
from sdpcutsel_tpu_torch.parallel.sharding import (CombinationShards, local_topk,
                                                   shard_combinations)
from sdpcutsel_tpu_torch.relax import batched as rb

CAP, ITERS, SEL, PIECE = 64, 300, 4, 37
# k: (n, the cand that pads the last shard); C(13, 3) = 286, C(12, 4) = 495,
# C(13, 5) = 1287 leave a remainder
SHAPES = {3: (13, 3), 4: (12, 2), 5: (13, 2)}
STRATEGIES = ("neural", "feasibility", "combined", "random")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's CPU threads share this process; torch's intra-op pool on top of
    them oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(n, b, seed=1):
    insts = [generate_spar(n, 100, seed + s) for s in range(b)]
    return (np.stack([i.Q for i in insts]).astype(np.float32),
            np.stack([i.c for i in insts]).astype(np.float32))


def _run(k, strategy, cand, pieces, rounds=2, B=2, cfg=None, scan=False, tables=None):
    """``rounds`` per-round steps (or one scan) from a fresh state; returns
    (the states after each round, the picks and their valid masks of each
    round, the generators' states, the scan's outs or None)."""
    n = SHAPES[k][0]
    Qb, cb = _batch(n, B)
    mesh = make_mesh(1, cand)
    table, valid = tables or shard_candidates(combinations_table(n, k), mesh, device="cpu")
    picks = []
    select = R._Round.select

    def keep(self, *a):
        out = select(self, *a)
        picks.append(tuple(t.clone() for t in out))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(R._Round, "select", keep)
    try:
        state = R.init_batched_state(Qb, cb, CAP, k, seed=3, device="cpu")
        knobs = dict(lp_iters=ITERS, sel_size=SEL, strategy=strategy, kmax=k, _pieces=pieces)
        outs, states = None, []
        if scan:
            state, outs = R.make_sharded_scan_step(mesh, cfg, rounds=rounds, **knobs)(
                state, table, valid)
            states.append(state)
        else:
            step = R.make_sharded_round_step(mesh, cfg, **knobs)
            for _ in range(rounds):
                state, _ = step(state, table, valid)
                states.append(state)
    finally:
        mp.undo()
    gens = [g.get_state() for g in states[-1].generators]
    return states, picks, gens, outs


def _leaves(state):
    return [state.Q, state.c, *rb.values(state.pool), *state.pdhg.fields(), state.bound,
            state.best_bound]


def _assert_same(a, b):
    (sa, pa, ga, _), (sb, pb, gb, _) = a, b
    assert len(sa) == len(sb) and len(pa) == len(pb)
    for x, y in zip(sa, sb):
        for u, v in zip(_leaves(x), _leaves(y)):
            assert torch.equal(u, v)
    for (ia, va), (ib, vb) in zip(pa, pb):
        assert torch.equal(ia, ib) and torch.equal(va, vb)
    assert all(torch.equal(u, v) for u, v in zip(ga, gb))


@pytest.mark.parametrize("cand", [1, "pad"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("k", [3, 4, 5])
def test_pieces_equal_the_whole_route(k, strategy, cand):
    """Forced pieces of 37 rows against the whole batched route, 2 rounds:
    picks, cut rows (the pools), states, bounds, generators bit for bit;
    with cand > 1 the last shard is padded and shard edges fall inside
    pieces of the 37-row grid."""
    cand = SHAPES[k][1] if cand == "pad" else cand
    n = SHAPES[k][0]
    if cand > 1:
        Tp = -(-math.comb(n, k) // cand) * cand
        assert Tp > math.comb(n, k) and (Tp // cand) % PIECE
    _assert_same(_run(k, strategy, cand, PIECE), _run(k, strategy, cand, False))


@pytest.mark.parametrize("alpha", [0.0, 0.05])
def test_pieces_equal_the_whole_route_any_alpha(alpha):
    cfg = RunConfig(cuts=CutConfig(diversity_alpha=alpha))
    _assert_same(_run(3, "neural", 3, PIECE, cfg=cfg), _run(3, "neural", 3, False, cfg=cfg))


def test_scan_by_pieces_equals_per_round_by_pieces():
    per = _run(4, "neural", 2, PIECE, rounds=3)
    scan = _run(4, "neural", 2, PIECE, rounds=3, scan=True)
    for u, v in zip(_leaves(per[0][-1]), _leaves(scan[0][-1])):
        assert torch.equal(u, v)
    assert all(torch.equal(u, v) for u, v in zip(per[2], scan[2]))
    for r in (1, 2):        # round r was solved on the pool round r - 1 left
        assert torch.equal(scan[3]["pool"].idx[r], per[0][r - 1].pool.idx)


def test_lazy_table_round_equals_the_whole_route(monkeypatch):
    """Past the threshold shard_combinations writes nothing; the round
    writes each piece's rows (the default piece size, and forced 37) and
    gives the written table's whole-route bits."""
    n, cand = SHAPES[3]
    monkeypatch.setitem(solver_mod.PIECE_N_OF, ("neural", 3), n - 1)
    lazy = shard_combinations(n, 3, make_mesh(1, cand), device="cpu")
    assert isinstance(lazy[0], CombinationShards) and lazy[1] is None
    whole = _run(3, "combined", cand, False)
    _assert_same(_run(3, "combined", cand, None, tables=lazy), whole)
    _assert_same(_run(3, "combined", cand, PIECE, tables=lazy), whole)
    with pytest.raises(ValueError):
        _run(3, "combined", cand, False, tables=lazy)


def test_route_rule(monkeypatch):
    """A written table goes by pieces once B x its rows passes the
    threshold; pair_layout keeps the whole route and refuses a lazy table."""
    n, cand = SHAPES[4]
    mesh = make_mesh(1, cand)
    table, _ = shard_candidates(combinations_table(n, 4), mesh, device="cpu")
    rnd = R._build_round(mesh, None, ITERS, SEL, None, "neural", None, 0, 4, False, None)
    limit = R.WHOLE_ROWS_OF["neural", 4]
    assert rnd.piece_rows(table, max(1, limit // table.shape[0])) is None
    monkeypatch.setitem(R.WHOLE_ROWS_OF, ("neural", 4), 2 * table.shape[0])
    assert rnd.piece_rows(table, 2) is None
    assert rnd.piece_rows(table, 3) == R.PIECE_ROWS_OF[4] // 3
    pair = R._build_round(mesh, None, ITERS, SEL, None, "neural", None, 0, 3, True, None)
    assert pair.piece_rows(table, 10 ** 6) is None
    lazy = CombinationShards(n, 3, math.comb(n, 3), math.comb(n, 3) + 2, 2, 0,
                             math.comb(n, 3) + 2)
    with pytest.raises(ValueError):
        pair.piece_rows(lazy, 1)


def test_fewer_finite_scores_than_picks_in_a_shard():
    """combined at round 0's point: a shard with fewer finite scores than
    sel_size; the running top-k keeps the whole sort's -inf rows."""
    n, k, cand, S = 10, 3, 3, 25
    Qb, cb = _batch(n, 2, seed=5)
    mesh = make_mesh(1, cand)
    table, valid = shard_candidates(combinations_table(n, k), mesh, device="cpu")
    rnd = R._build_round(mesh, None, ITERS, S, None, "combined", None, 0, k, False, None)
    state = R.init_batched_state(Qb, cb, CAP, k, device="cpu")
    x = torch.rand(2, n, generator=torch.Generator().manual_seed(0))
    X = 0.5 * (x[:, :, None] * x[:, None, :]) + 0.5 * torch.diag_embed(x)
    scores = rnd.scores(state, x, X, table, [])
    per = table.shape[0] // cand
    finite = torch.isfinite(torch.where(valid, scores, -torch.inf)).reshape(2, cand, per).sum(-1)
    assert (finite < S).any() and (finite > 0).any()
    for lo in range(0, table.shape[0], per):
        sc, ok, tab = scores[:, lo:lo + per], valid[lo:lo + per], table[lo:lo + per]
        top = RunningTopk(S)
        for s in range(0, per, 7):
            top.add(sc[:, s:s + 7], ok[s:s + 7], tab[s:s + 7], lo + s)
        want = local_topk(sc, ok, tab, S)
        assert all(torch.equal(u, v) for u, v in zip(top.result(), want))
    a = _run_fixed(rnd, state, x, X, table, valid, PIECE)
    b = _run_fixed(rnd, state, x, X, table, valid, False)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def _run_fixed(rnd, state, x, X, table, valid, pieces):
    rnd = dataclasses.replace(rnd, pieces=pieces)
    return rnd.select(state, x, X, table, valid, [])


def test_running_topk_ties_and_minus_inf():
    """Ties and -inf entries go to the lowest positions, as the whole stable
    sort; pieces shorter than S included."""
    g = torch.Generator().manual_seed(2)
    scores = torch.randint(0, 4, (3, 203), generator=g).float()
    scores[:, ::3] = -torch.inf
    scores[1] = -torch.inf
    valid = torch.rand(203, generator=g) > 0.2
    table = torch.randint(0, 50, (203, 4), generator=g, dtype=torch.int32)
    want = local_topk(scores, valid, table, 9)
    for P in (1, 5, 9, 16, 37, 203):
        top = RunningTopk(9)
        for s in range(0, 203, P):
            top.add(scores[:, s:s + P], valid[s:s + P], table[s:s + P], s)
        assert all(torch.equal(u, v) for u, v in zip(top.result(), want))


@pytest.mark.parametrize("k,cand", [(3, 3), (4, 2), (5, 2)])
def test_lazy_table_rows_are_shard_candidates(k, cand, monkeypatch):
    """Every shard's rows and mask written from the description, a
    distributed rank's range included (a Mesh with ranks, no process group),
    are shard_candidates'; a rank's written table is its put_global shard."""
    n = SHAPES[k][0]
    monkeypatch.setitem(solver_mod.PIECE_N_OF, ("neural", k), n - 1)
    pairs = torch.triu_indices(n, n, 1).to(torch.int32).T.contiguous()
    one = make_mesh(1, cand)
    table, valid = shard_candidates(combinations_table(n, k), one, device="cpu")
    lazy, none = shard_combinations(n, k, one, device="cpu")
    assert none is None and lazy.shape == tuple(table.shape)
    for lo, hi in lazy.local():
        for s in range(lo, hi, 11):
            rows, ok = lazy.write(s, min(hi, s + 11), pairs)
            assert torch.equal(rows, table[s:min(hi, s + 11)])
            assert torch.equal(ok, valid[s:min(hi, s + 11)])
    for r in range(cand):
        rank = Mesh(1, cand, True, r, torch.device("cpu"))
        want = shard_candidates(combinations_table(n, k), rank, device="cpu")
        mine, _ = shard_combinations(n, k, rank, device="cpu")
        assert [(mine.lo, mine.hi)] == mine.local() == [(r * lazy.shard_rows,
                                                          (r + 1) * lazy.shard_rows)]
        got = mine.write(mine.lo, mine.hi, pairs)
        assert all(torch.equal(u, v) for u, v in zip(got, want))
        monkeypatch.setitem(solver_mod.PIECE_N_OF, ("neural", k), n)
        written = shard_combinations(n, k, rank, device="cpu")
        assert all(torch.equal(u, v) for u, v in zip(written, want))
        monkeypatch.setitem(solver_mod.PIECE_N_OF, ("neural", k), n - 1)


@pytest.mark.parametrize("lazy", [False, True])
def test_a_ranks_random_draws_by_pieces_are_the_one_process_stream(lazy, monkeypatch):
    """random on a distributed rank (a Mesh with ranks, no process group; the
    gather is stood in for): by pieces of 37 rows it keeps its own shard's
    winners of the one-process draw, and its generators end in the
    one-process states, whether its rows are written or described."""
    n, cand = SHAPES[3]
    if lazy:
        monkeypatch.setitem(solver_mod.PIECE_N_OF, ("neural", 3), n - 1)
    parts = []
    monkeypatch.setattr(R, "gather_cand", lambda p, dim=0, mesh=None: (
        parts.append([t.clone() for t in p]), torch.cat(list(p), dim))[1])
    Qb, cb = _batch(n, 2)
    state = R.init_batched_state(Qb, cb, CAP, 3, seed=3, device="cpu")
    x = torch.rand(2, n, generator=torch.Generator().manual_seed(1))
    X = x[:, :, None] * x[:, None, :]

    def select(mesh, pieces):
        rnd = R._build_round(mesh, None, ITERS, SEL, None, "random", None, 0, 3, False, pieces)
        table, valid = shard_combinations(n, 3, mesh, device="cpu")
        gens = [R._copy_generator(g) for g in state.generators]
        parts.clear()
        rnd.select(state, x, X, table, valid, gens)
        return parts[0], [g.get_state() for g in gens]

    whole, whole_gens = select(make_mesh(1, cand), False if not lazy else PIECE)
    for r in range(cand):
        mine, gens = select(Mesh(1, cand, True, r, torch.device("cpu")), PIECE)
        assert torch.equal(mine[0], whole[r])
        assert all(torch.equal(u, v) for u, v in zip(gens, whole_gens))


@pytest.mark.parametrize("k", [4, 5])
def test_per_instance_features_are_the_batched_ones(k):
    n = SHAPES[k][0]
    Qb, _ = _batch(n, 3)
    Q = torch.as_tensor(Qb)
    table = torch.as_tensor(combinations_table(n, k))
    triQ, scale = candidate_q_features(Q, table)
    for b in range(3):
        for s in range(0, table.shape[0], PIECE):
            t, sc = candidate_q_features(Q[b], table[s:s + PIECE])
            assert torch.equal(t, triQ[b, s:s + PIECE]) and torch.equal(sc, scale[b, s:s + PIECE])


def _reference(n, B, k, rounds):
    Qb, cb = _batch(n, B)
    mesh = j_make_mesh(data=1, cand=1)
    state = j_init(jnp.asarray(Qb), jnp.asarray(cb), capacity=CAP, kmax=k)
    table, valid = j_shard(combinations_table(n, k), mesh)
    step = j_step(mesh, lp_iters=ITERS, sel_size=SEL, strategy="neural", kmax=k)
    out = []
    for _ in range(rounds):
        state, _ = step(state, table, valid)
        out.append((np.asarray(state.pool.idx), np.asarray(state.pool.count), j_certify(state)))
    return out


@pytest.mark.parametrize("n,B,k", [(12, 3, 3), (10, 2, 4)])
def test_pieces_match_the_jax_package(n, B, k):
    """The JAX package's whole-table batched round against the port by
    forced pieces (cand 2): pools equal after 1 and 3 rounds, f64
    certificates at rtol 2e-3."""
    ref = _reference(n, B, k, 3)
    Qb, cb = _batch(n, B)
    mesh = make_mesh(1, 2)
    table, valid = shard_candidates(combinations_table(n, k), mesh, device="cpu")
    state = R.init_batched_state(Qb, cb, CAP, k, device="cpu")
    step = R.make_sharded_round_step(mesh, lp_iters=ITERS, sel_size=SEL, strategy="neural",
                                     kmax=k, _pieces=PIECE)
    for r in range(3):
        state, _ = step(state, table, valid)
        if r in (0, 2):
            np.testing.assert_array_equal(state.pool.count.numpy(), ref[r][1])
            np.testing.assert_array_equal(state.pool.idx.numpy(), ref[r][0])
            np.testing.assert_allclose(R.certify_batched_f64(state), ref[r][2], rtol=2e-3)
