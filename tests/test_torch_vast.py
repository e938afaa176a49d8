"""The grid route's 2048-column form (csrc/pdhg_grid.cuh, GridForm<kVast>:
1024 < n <= 2048, the owned state in global memory, the dense rows read in
place) and what the main path needs past n = 1024 on the CPU: the routes
on CUDA and where they refuse, the width and the layout summed from the
kernel source, a Python mirror of what each CTA owns, the wrappers'
marshalling against the library's signatures, the port's plain block at
n = 1030 against the JAX package, the table written on a device, the
support-diverse selection on index counts against the (T, k, k) compare it
replaces (and the JAX package's picks), and the scoring kernels' split into
launches past their 32-bit offsets.  The kernels run only on the card
(chip_smoke.py phase 23 holds them to their twins there); torch runs on one
thread here."""

import os
import re
from math import comb

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpcutsel_tpu.ops.topk import diverse_topk as jax_diverse_topk
from sdpcutsel_tpu_torch.config import CutConfig
from sdpcutsel_tpu_torch.cuts.enumerate import combinations_table, combinations_table_on
from sdpcutsel_tpu_torch.instances import parse_boxqp
from sdpcutsel_tpu_torch.lp import pdhg_dense as tdense
from sdpcutsel_tpu_torch.lp import pdhg_grid as tgrid
from sdpcutsel_tpu_torch.lp import pdhg_kernel as tkernel
from sdpcutsel_tpu_torch.lp.pdhg_kernel import SMEM_MAX, kernel_route, route_refusal
from sdpcutsel_tpu_torch.models.scorer import MLPScorer, load_params
from sdpcutsel_tpu_torch.ops import topk as ttopk
from sdpcutsel_tpu_torch.ops.fused_score import OFFSET_LIMIT, launch_ranges, offset_refusal
from sdpcutsel_tpu_torch.ops.pair_score import pair_score_plain
from sdpcutsel_tpu_torch.parallel.mesh import Mesh
from sdpcutsel_tpu_torch.parallel.sharding import shard_candidates, shard_combinations
from sdpcutsel_tpu_torch.scoring_variants import scoring_point
import test_torch_grid
from test_torch_grid import (_forms_from_source, _grid_layout_words, _python, _slices,
                             _source, _work_expr)

CUDA = torch.device("cuda")
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "boxqp")
VAST_N = (1025, 1100, 1500, 2048)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's CPU threads share this process; torch's intra-op pool on top of
    them oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the routes past n = 1024 ------------------------------------------------------

@pytest.mark.parametrize("n", [1025, 1500, 2048])
@pytest.mark.parametrize("M,k,m", [(1024, 3, 0), (1024, 5, 25), (65536, 3, 0), (1024, 2, 0)])
def test_pools_of_cuts_take_the_grid_route_to_n2048(n, M, k, m):
    """A pool of cuts at 1024 < n <= 2048 takes the grid route on CUDA under
    "auto" and "on" (K2's cluster refuses it by n), by route_refusal alone:
    nothing is launched."""
    assert "n <= 256" in tkernel.plan_refusal(n, M, k, m)
    assert route_refusal(n, M, k, m) == ("grid", None)
    assert tgrid.grid_refusal(n, M, k, m) is None
    for use_kernel in ("auto", "on"):
        assert kernel_route(use_kernel, CUDA, n, M, k, m) == "grid"
    assert kernel_route("off", CUDA, n, M, k, m) == "plain"


@pytest.mark.parametrize("n", [1025, 1500, 2048])
@pytest.mark.parametrize("m", [1, 64, 368, 2048, 40000])
def test_the_certifier_takes_the_dense_route_to_n2048(n, m):
    """The certifier's pool at 1024 < n <= 2048 stays on the dense route,
    whose wrappers launch the grid route's 2048-column form without cuts
    (its replica of yD in shared memory up to max_dense_rows, the far form
    past it)."""
    assert route_refusal(n, 1, 1, m) == ("dense", None)
    assert kernel_route("auto", CUDA, n, 1, 1, m) == "dense"
    assert not tdense.k7_takes(n, m) and tdense.block_plan(n, m) == "grid"
    far = m > tdense.max_dense_rows(n)
    assert tgrid.grid_form(n, 1, m, False) is far
    assert tdense.smem_words(n, m) == tgrid.block_words(n, 1, m, False, far)
    assert 4 * tdense.smem_words(n, m) <= SMEM_MAX
    assert tdense.dense_route_refusal(n, 1, 1, m) is None


@pytest.mark.parametrize("M,k,m", [(1024, 3, 0), (1024, 5, 25), (65536, 3, 0), (1, 1, 64),
                                   (1, 1, 40000)])
def test_n2049_is_refused_by_every_route(M, k, m):
    """n = 2049 and n = 2048 are taken on the pool's route (the open form
    past n = 2048); the refusal moved to the open form's 32-bit bound:
    n = 46,341 is refused on CUDA under "auto" and "on" with "n <= 46340",
    the pool's route named; "off" runs plain."""
    n = tkernel.OPEN_NMAX + 1
    route, why = route_refusal(n, M, k, m)
    assert route == ("dense" if (M, k) == (1, 1) else "grid")
    assert "n <= 46340" in why
    for use_kernel in ("auto", "on"):
        with pytest.raises(ValueError, match="n <= 46340"):
            kernel_route(use_kernel, CUDA, n, M, k, m)
    assert kernel_route("off", CUDA, n, M, k, m) == "plain"
    assert route_refusal(2048, M, k, m) == (route, None)
    assert route_refusal(2049, M, k, m) == (route, None)


# ---- the width and the layout, from the kernel source ------------------------------

def _cols_for(n: int) -> int:
    """csrc/pdhg_common.cuh's cols_for(n), evaluated from the source."""
    text = _source("pdhg_common.cuh")
    consts = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    body = text[text.index("constexpr int cols_for(int n)"):]
    expr = re.search(r"return (.*?);", body, re.S).group(1)
    return eval(_python(expr), {}, {**consts, "n": n})                     # noqa: S307


def test_columns_match_the_kernel_source():
    """kVast is 2048 in the header and in the Python mirrors, columns(n) is
    cols_for(n) from 1 to 2049 (the open form's tag past 2048, 0 past its
    bound, which no kernel takes), and the forms' constants are the
    header's at all six widths."""
    assert "constexpr int kVast = 2048;" in _source("pdhg_common.cuh")
    assert tkernel.VAST == 2048 and tgrid.GRID_NMAX == tkernel.OPEN_NMAX
    for n in range(1, 2050):
        assert _cols_for(n) == tkernel.columns(n), n
    assert _cols_for(2049) == tkernel.OPEN and _cols_for(0) == 0
    assert _cols_for(tkernel.OPEN_NMAX + 1) == 0
    assert {tkernel.columns(n) for n in VAST_N} == {2048}
    forms = _forms_from_source()
    assert forms == tgrid.FORMS and set(forms) == {128, 256, 512, 1024, 2048, tkernel.OPEN}


def test_2048_columns_hold_a_ctas_entries():
    """kMaxE at 2048 columns holds ceil(n^2 / P) + ceil(n / P) entries at
    n = 2048 on the H100's 132 SMs (launch_grid's check), kSpan sub-spans of
    the adjoint's kSub; no state arrays and no ring in shared memory."""
    kmax, _, scratch, stages, state = tgrid.FORMS[2048]
    need = -(-2048 * 2048 // 132) + -(-2048 // 132)
    assert tgrid.max_entries(2048) == kmax >= need == 31792
    assert tdense.max_entries(2048) == kmax
    assert stages == 0 and state == 0
    assert -(-2048 // 132) <= 512 // 32        # a CTA's x entries within its warps
    assert -(-2112 // 132) <= 512 // 32 < -(-2113 // 132)
    # the norm's replica of y at [128, 128 + n), the residual's sums at the end
    assert 128 + 2048 <= scratch - 8 * 16 and 256 + 132 * 6 <= scratch


@pytest.mark.parametrize("n", VAST_N)
@pytest.mark.parametrize("M,m", [(1024, 0), (1024, 25), (1024, 368), (1, 2048), (4096, 64),
                                 (65536, 0)])
def test_2048_layout_matches_the_kernel_source(n, M, m):
    """block_words is grid_layout at 2048 columns, with and without cuts, in
    both forms: no slab (the passes read the rows in place), no state
    arrays; the shared form fits a CTA where grid_form keeps it, the far
    form always."""
    kmax, _, scratch, _, _ = tgrid.FORMS[2048]
    for cuts in (True, False):
        for far in (False, True):
            words = tgrid.block_words(n, M, m, cuts, far)
            assert words == _grid_layout_words(n, M, m, cuts, far)
            replicas = 0 if far else m + (M if cuts else 0)
            assert words == tgrid._META + scratch + replicas + kmax
        assert 4 * tgrid.block_words(n, M, m, cuts, True) <= SMEM_MAX
        assert tgrid.grid_form(n, M, m, cuts) is (4 * tgrid.block_words(n, M, m, cuts) > SMEM_MAX)
    assert 4 * tgrid.block_words(n, 1024, 25, True) <= SMEM_MAX       # the band QCQP, shared
    assert 4 * tgrid.block_words(n, 1, 64, False) <= SMEM_MAX         # the certifier, shared
    assert tgrid.grid_form(n, 65536, 0, True)                         # 65,536 slots: far


@pytest.mark.parametrize("n,m,M,P", [(2048, 0, 1024, 132), (1500, 25, 1024, 132),
                                     (1100, 64, 1, 132), (2048, 0, 65536, 132)])
def test_2048_work_matches_the_kernel_source(n, m, M, P):
    """work_words and norm_work_words at 2048 columns are the source's, in
    size_t: the scratch past 2^31 bytes is counted, not wrapped."""
    for cuts in (True, False):
        names = dict(n=n, m=m, M=M, P=P, NN=n * n, Pm=P * m, cuts=cuts, kNS=10, kND=6)
        assert tgrid.norm_work_words(n, m, M, P, cuts) == eval(              # noqa: S307
            _work_expr("norm_work_words"), {}, names)
        for checked in (True, False):
            for far in (True, False):
                names.update(checked=checked, far=far)
                assert tgrid.work_words(n, m, M, P, cuts, checked, far) == eval(  # noqa: S307
                    _work_expr("work_words"), {}, names)


@pytest.mark.parametrize("P", [132, 130])
@pytest.mark.parametrize("n", [1025, 1500, 2048])
def test_every_entry_has_one_owner_at_2048_columns(n, P):
    """On P CTAs every entry of X and x has exactly one owner, and in the
    passes in place one thread of its CTA: thread t the entries t + 512 i
    of [X | x], i below kSpan, the adjoint's sub-spans of kSub covering
    them; a CTA's entries within kMaxE and its x entries within the warps."""
    kmax = tgrid.FORMS[2048][0]
    span = -(-kmax // 512)
    sub = int(re.search(r"constexpr int kSub = (\d+);", _source("pdhg_grid.cuh")).group(1))
    owner_X, owner_x = np.zeros(n * n, int), np.zeros(n, int)
    for (e0, e1), (i0, i1) in zip(_slices(n * n, P), _slices(n, P)):
        owner_X[e0:e1] += 1
        owner_x[i0:i1] += 1
        LA, LB = e1 - e0, i1 - i0
        if LA + LB > kmax:             # launch_grid refuses the grid (kErrLayout)
            assert P < 132 and n == 2048
            continue
        assert LB <= 16
        taken = []
        for t in range(512):
            nA = (LA - 1 - t) // 512 + 1 if t < LA else 0
            jx = LA + ((t - LA) % 512)
            taken += [t + 512 * (i0_ + i) for i0_ in range(0, span, sub) for i in range(sub)
                      if i0_ + i < nA]
            if jx < LA + LB:
                taken.append(jx)
        assert sorted(taken) == list(range(LA + LB))
    assert (owner_X == 1).all() and (owner_x == 1).all()


# ---- the wrappers' launches at 2048 columns, recorded by a stand-in library --------

@pytest.mark.parametrize("n,m", [(2048, 0), (1100, 5)])
def test_vast_launches_match_the_library(n, m, monkeypatch):
    """The block, the checked launch and the norm marshal the C entries'
    arguments at 2048 columns (tests/test_torch_grid.py's check)."""
    test_torch_grid.test_grid_launches_match_the_library(n, m, monkeypatch)


def test_the_certifier_past_n1024_launches_the_form_without_cuts(monkeypatch):
    """The dense route's wrappers at n = 1100 launch the grid route's form
    without cuts at 2048 columns."""
    test_torch_grid.test_dense_route_past_n256_launches_the_grid_form_without_cuts(
        1100, 2048, monkeypatch)


# ---- the port's plain block at n = 1030 against the JAX package ----------------------

VAST_CASE = {"n=1030 k=3": (1030, 3, 0)}


@pytest.fixture
def _vast_cases(monkeypatch):
    monkeypatch.setattr(test_torch_grid, "CASES", VAST_CASE)


@pytest.mark.parametrize("case", VAST_CASE)
def test_plain_block_at_n1030_matches_the_reference(case, _vast_cases):
    """30 iterations through the grid wrapper's twin at n = 1030 against the
    JAX package's _one_iter loop, rtol = atol = 2e-5."""
    test_torch_grid.test_plain_block_matches_the_reference(case)


@pytest.mark.parametrize("case", VAST_CASE)
def test_norm_at_n1030_is_the_twin_and_near_the_reference(case, _vast_cases):
    """The grid wrapper's norm at n = 1030 is estimate_norm_plain bit for
    bit and within 2% of the JAX package's."""
    test_torch_grid.test_norm_on_the_cpu_is_the_twin_and_near_the_reference(case)


# ---- the table written on a device ---------------------------------------------------

@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_device_table_is_the_host_table(k):
    """combinations_table_on gives combinations_table's rows in its order,
    int32, for every n <= 40 (and n = k)."""
    for n in range(k, 41):
        got = combinations_table_on(n, k, "cpu")
        assert got.dtype == torch.int32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), combinations_table(n, k))


def test_device_table_at_n300():
    got = combinations_table_on(300, 3, "cpu")
    assert got.shape == (comb(300, 3), 3) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), combinations_table(300, 3))


@pytest.mark.parametrize("cand", [1, 3])
def test_shard_combinations_is_shard_candidates(cand):
    """The batched paths' table on the device: shard_candidates of the host
    table, padded rows and mask alike."""
    mesh = Mesh(1, cand)
    got = shard_combinations(37, 3, mesh, device="cpu")
    want = shard_candidates(combinations_table(37, 3), mesh, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# ---- the selection on index counts ---------------------------------------------------

def _compare_topk(scores, table, k: int, alpha: float, mask=None):
    """ops/topk.py::diverse_topk before this change: the penalty from the
    (..., T, kk, kk) compare of every row with the pick."""
    neg = torch.full_like(scores, -torch.inf)
    sc = scores if mask is None else torch.where(mask, scores, neg)
    sc = sc.clone()
    pen = torch.zeros_like(sc)
    vals, sel = [], []
    for _ in range(k):
        i = torch.argmax(sc - alpha * pen, dim=-1, keepdim=True)
        val = torch.gather(sc, -1, i)
        row = torch.gather(table, -2, i[..., None].expand(*i.shape, table.shape[-1]))
        add = (table[..., :, :, None] == row[..., :, None, :]).sum((-2, -1)).to(sc.dtype)
        pen = torch.where(torch.isfinite(val), pen + add, pen)
        sc.scatter_(-1, i, -torch.inf)
        vals.append(val[..., 0])
        sel.append(i[..., 0])
    vals = torch.stack(vals, -1)
    return vals, torch.stack(sel, -1), torch.isfinite(vals)


def _same(a, b):
    return all(torch.equal(u, v) for u, v in zip(a, b))


def _tied_scores(rng, shape, levels: int = 4):
    """Scores on a few levels: many exact ties."""
    return torch.as_tensor(rng.integers(0, levels, shape).astype(np.float32) * 0.25)


@pytest.mark.parametrize("alpha", [1e-4, 0.1, 1.0, 3.0])
def test_diverse_topk_ties(alpha):
    """Random scores with many exact ties over C(30, 3): the same picks,
    values and validity as the compare, bit for bit."""
    rng = np.random.default_rng(1)
    table = torch.as_tensor(combinations_table(30, 3))
    for _ in range(4):
        scores = _tied_scores(rng, table.shape[0])
        assert _same(ttopk.diverse_topk(scores, table, 20, alpha),
                     _compare_topk(scores, table, 20, alpha))


@pytest.mark.parametrize("alpha", [1e-4, 0.5])
def test_diverse_topk_masks_and_minus_inf(alpha):
    """A mask, -inf scores and fewer finite candidates than picks: the
    compare's bits (the picks past the finite ones are -inf, invalid, and
    add no penalty)."""
    rng = np.random.default_rng(2)
    table = torch.as_tensor(combinations_table(12, 3))
    T = table.shape[0]
    for trial in range(6):
        scores = _tied_scores(rng, T)
        scores[torch.as_tensor(rng.random(T) < 0.3)] = -torch.inf
        mask = torch.as_tensor(rng.random(T) < (0.9 if trial % 2 else 0.05))
        got = ttopk.diverse_topk(scores, table, 16, alpha, mask)
        assert _same(got, _compare_topk(scores, table, 16, alpha, mask))
    none = torch.full((T,), -torch.inf)
    got = ttopk.diverse_topk(none, table, 5, alpha)
    assert _same(got, _compare_topk(none, table, 5, alpha)) and not got[2].any()


@pytest.mark.parametrize("kk", [3, 5])
def test_diverse_topk_batch_and_repeated_indices(kk):
    """A batch (B, T) of tables (B, T, kk) whose rows repeat indices (the
    QCQP clique tables pad that way): each instance picked on its own, the
    compare's bits, one count for each time an index appears."""
    rng = np.random.default_rng(3)
    table = torch.as_tensor(rng.integers(0, 9, (3, 400, kk)).astype(np.int32))
    scores = _tied_scores(rng, (3, 400), levels=3)
    mask = torch.as_tensor(rng.random((3, 400)) < 0.8)
    for m in (None, mask):
        got = ttopk.diverse_topk(scores, table, 16, 0.5, m)
        assert _same(got, _compare_topk(scores, table, 16, 0.5, m))
        for b in range(3):
            one = ttopk.diverse_topk(scores[b], table[b], 16, 0.5, None if m is None else m[b])
            assert _same(one, tuple(t[b] for t in got))


def test_diverse_topk_in_steps(monkeypatch):
    """The penalty's update in steps of PENALTY_ROWS rows (the columns
    gathered a step at a time, as at n = 2048) gives the one-step bits."""
    rng = np.random.default_rng(4)
    table = torch.as_tensor(combinations_table(25, 3))
    scores = _tied_scores(rng, table.shape[0])
    batch = torch.as_tensor(rng.integers(0, 7, (2, 300, 4)).astype(np.int32))
    bscores = _tied_scores(rng, (2, 300))
    want = ttopk.diverse_topk(scores, table, 20, 0.3), ttopk.diverse_topk(bscores, batch, 12, 0.3)
    monkeypatch.setattr(ttopk, "PENALTY_ROWS", 97)
    assert _same(ttopk.diverse_topk(scores, table, 20, 0.3), want[0])
    assert _same(ttopk.diverse_topk(bscores, batch, 12, 0.3), want[1])
    assert _same(want[0], _compare_topk(scores, table, 20, 0.3))


def test_diverse_topk_on_the_main_path_at_n125():
    """The main path's selection at n = 125: K1's twin's neural scores of
    all 317,750 triples of spar125-100-1 at a random point, sel_size 20 at
    the default alpha (CutConfig), the compare's bits."""
    inst = parse_boxqp(os.path.join(DATA, "spar125-100-1.in"), name="spar125-100-1")
    x, X, Q = scoring_point(inst, "cpu")
    table = combinations_table_on(inst.n, 3, "cpu")
    scores = pair_score_plain(x, X, Q, table, MLPScorer(load_params(3), "cpu"))[0]
    alpha = CutConfig().diversity_alpha
    got = ttopk.diverse_topk(scores, table, 20, alpha)
    assert _same(got, _compare_topk(scores, table, 20, alpha)) and bool(got[2].all())


@pytest.mark.parametrize("alpha", [1e-4, 0.25])
def test_diverse_topk_gives_the_jax_packages_picks(alpha):
    """The JAX package's diverse_topk on the same scores picks the same
    candidates with the same values (ties broken toward the lower index)."""
    rng = np.random.default_rng(5)
    table_np = combinations_table(22, 3)
    s = rng.integers(0, 5, table_np.shape[0]).astype(np.float32) * 0.5
    mask = rng.random(table_np.shape[0]) < 0.85
    vals, sel, ok = ttopk.diverse_topk(torch.as_tensor(s), torch.as_tensor(table_np), 20, alpha,
                                       torch.as_tensor(mask))
    jv, js, jok = jax_diverse_topk(jnp.asarray(s), jnp.asarray(table_np), 20, 22, alpha,
                                   jnp.asarray(mask))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(js))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


# ---- the scoring kernels' launches past their 32-bit offsets -------------------------

@pytest.mark.parametrize("width", [3, 10, 15])
def test_launch_ranges_cover_c2048_3(width):
    """At T = C(2048, 3) the launches cover [0, T) in order, contiguous,
    each below 2^31 words (offset_refusal takes each one), as few as the
    limit allows: two for K1's 3 words a candidate."""
    T = comb(2048, 3)
    ranges = launch_ranges(T, width)
    assert ranges[0][0] == 0 and ranges[-1][1] == T
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(e > s and (e - s) * width < OFFSET_LIMIT for s, e in ranges)
    assert all(offset_refusal("k", e - s, width) is None for s, e in ranges)
    assert len(ranges) == -(-T * width // (OFFSET_LIMIT - 1))
    if width == 3:
        assert len(ranges) == 2 and offset_refusal("pair_score", T, 3) is not None


def test_launch_ranges_below_the_limit_and_forced():
    """One launch wherever one takes the table (C(1024, 3) and C(1626, 3),
    none for no rows); a forced row limit gives near-equal ranges of at most
    that many rows, in order."""
    assert launch_ranges(comb(1024, 3), 3) == [(0, comb(1024, 3))]
    assert launch_ranges(comb(1626, 3), 3) == [(0, comb(1626, 3))]
    assert len(launch_ranges(comb(1627, 3), 3)) == 2
    assert launch_ranges(0, 3) == []
    T = comb(1024, 3)
    ranges = launch_ranges(T, 3, 1 << 26)
    assert len(ranges) == 3 and ranges[0] == (0, T // 3) and ranges[-1][1] == T
    assert all(e - s <= 1 << 26 for s, e in ranges)
    with pytest.raises(ValueError, match="max_rows"):
        launch_ranges(T, 3, 0)
