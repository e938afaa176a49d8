"""The grid route's open form (csrc/pdhg_grid.cuh, GridForm<kOpen>: every n
past 2048, no cap on what a CTA owns, its owned entries' buffer and its x
entries in global memory) on the CPU: its constants and layout from the
kernel source, the Python mirrors of its layout and scratch, the width
across n = 2048 -> 2049, the routes at n = 2049, 4096, 6000 and past the
32-bit bound, a Python mirror of what each CTA and thread owns, and the
wrappers' marshalling against the library's signatures (forced open form
included).  The kernels run only on the card (chip_smoke.py phase 24 holds
them to their twins there)."""

import re

import numpy as np
import pytest
import torch

from sdpcutsel_tpu_torch.lp import pdhg_dense as tdense
from sdpcutsel_tpu_torch.lp import pdhg_grid as tgrid
from sdpcutsel_tpu_torch.lp import pdhg_kernel as tkernel
from sdpcutsel_tpu_torch.lp.pdhg_kernel import SMEM_MAX, kernel_route, route_refusal
from sdpcutsel_tpu_torch.relax import cutbuffer as tcb
from sdpcutsel_tpu_torch.relax import denserows as tdr
from sdpcutsel_tpu_torch.relax.cutbuffer import build_cut_index
from sdpcutsel_tpu_torch.lp import pdhg as tpdhg
from sdpcutsel_tpu_torch.lp.pdhg_kernel import steps_record
from test_torch_grid import (_cut_problem, _fake_card, _forms_from_source, _grid_layout_words,
                             _slices, _source, _work_expr)
from test_torch_vast import _cols_for

CUDA = torch.device("cuda")
OPEN_N = (2049, 3000, 4096, 6000, 46340)


# ---- the form's constants and width, from the kernel source ----------------------

def test_open_form_matches_the_kernel_source():
    """kOpen and kOpenMax are the header's and the Python mirrors'; the open
    form's constants (no owned buffer, no ring, no state in shared memory)
    are the header's; kOpenMax is the largest n whose X entries' index
    n n + n stays within 32 bits."""
    text = _source("pdhg_common.cuh")
    assert f"constexpr int kOpen = {tkernel.OPEN};" in text
    assert f"constexpr int kOpenMax = {tkernel.OPEN_NMAX};" in text
    assert tgrid.GRID_NMAX == tkernel.OPEN_NMAX == 46340
    n = tkernel.OPEN_NMAX
    assert n * n + n < 2 ** 31 <= (n + 1) * (n + 1) + n + 1
    assert tkernel.OPEN > n                 # a tag at least every n the form takes
    forms = _forms_from_source()
    assert forms == tgrid.FORMS and forms[tkernel.OPEN] == (0, 1, 2304, 0, 0)


@pytest.mark.parametrize("n", [1, 128, 1024, 2047, 2048, 2049, 2050, 4096, 6000, 46339, 46340,
                               46341, 10 ** 5])
def test_columns_across_2048(n):
    """columns(n) is cols_for(n) from the source on both sides of n = 2048
    and up to the bound; past it cols_for gives 0 (no kernel)."""
    want = _cols_for(n)
    if n > tkernel.OPEN_NMAX:
        assert want == 0 and tkernel.columns(n) == tkernel.OPEN
    else:
        assert want == tkernel.columns(n)
    if 2048 < n <= tkernel.OPEN_NMAX:
        assert want == tkernel.OPEN
    if n == 2048:
        assert want == tkernel.VAST


@pytest.mark.parametrize("n", OPEN_N)
@pytest.mark.parametrize("M,m", [(1024, 0), (1024, 25), (1, 64), (65536, 0), (1, 40000)])
def test_open_layout_matches_the_kernel_source(n, M, m):
    """block_words is grid_layout in the open form, with and without cuts,
    in both forms: the CTA's Slices and arguments, the scratch and the
    replicas alone (no owned buffer, no slab, no state); the shared form
    where it fits a CTA, the far form always."""
    _, _, scratch, _, _ = tgrid.FORMS[tkernel.OPEN]
    for cuts in (True, False):
        for far in (False, True):
            words = tgrid.block_words(n, M, m, cuts, far)
            assert words == _grid_layout_words(n, M, m, cuts, far)
            assert words == tgrid._META + scratch + (0 if far else m + (M if cuts else 0))
        assert 4 * tgrid.block_words(n, M, m, cuts, True) <= SMEM_MAX
        assert tgrid.grid_form(n, M, m, cuts) is (4 * tgrid.block_words(n, M, m, cuts) > SMEM_MAX)
    # the forced open form at n = 2048 lays out as the open form
    assert tgrid.block_words(2048, M, m, True, False, tkernel.OPEN) == tgrid.block_words(
        4096, M, m, True, False)


@pytest.mark.parametrize("n,m,M,P", [(4096, 0, 1024, 132), (3000, 25, 1024, 132),
                                     (2049, 64, 1, 130), (46340, 0, 65536, 132)])
def test_open_work_matches_the_kernel_source(n, m, M, P):
    """open_words is the source's (the owned entries' buffer, n n + n, the x
    entries' sums, 3 n, and the norm's second y, n), counted in size_t;
    work_words and norm_work_words keep their formulas below it."""
    names = dict(n=n, m=m, M=M, P=P, NN=n * n, Pm=P * m, kNS=10, kND=6)
    assert tgrid.open_words(n) == eval(_work_expr("open_words"), {}, names)   # noqa: S307
    assert tgrid.open_words(n) == n * n + 5 * n
    for cuts in (True, False):
        names["cuts"] = cuts
        assert tgrid.norm_work_words(n, m, M, P, cuts) == eval(              # noqa: S307
            _work_expr("norm_work_words"), {}, names)
        for checked in (True, False):
            names.update(checked=checked, far=False)
            assert tgrid.work_words(n, m, M, P, cuts, checked) == eval(      # noqa: S307
                _work_expr("work_words"), {}, names)
    if n == 46340:                          # past 2^31 floats: counted, not wrapped
        assert tgrid.work_words(n, m, M, P, True, True) + tgrid.open_words(n) > 2 ** 32


# ---- the routes past n = 2048 ------------------------------------------------------

@pytest.mark.parametrize("n", [2049, 4096, 6000])
@pytest.mark.parametrize("M,k,m", [(1024, 3, 0), (1024, 5, 25), (65536, 3, 0), (1024, 2, 0),
                                   (1, 1, 64), (1, 1, 40000)])
def test_routes_past_n2048(n, M, k, m):
    """A pool of cuts past n = 2048 takes the grid route, the certifier's pool
    the dense route (the open form without cuts), under "auto" and "on" on
    CUDA, by route_refusal alone: nothing is launched."""
    route = "dense" if (M, k) == (1, 1) else "grid"
    assert route_refusal(n, M, k, m) == (route, None)
    for use_kernel in ("auto", "on"):
        assert kernel_route(use_kernel, CUDA, n, M, k, m) == route
    assert kernel_route("off", CUDA, n, M, k, m) == "plain"
    if route == "dense":
        assert tdense.dense_route_refusal(n, M, k, m) is None and not tdense.k7_takes(n, m)


@pytest.mark.parametrize("M,k,m", [(1024, 3, 0), (1024, 5, 25), (1, 1, 64)])
def test_past_the_bound_is_refused(M, k, m):
    """n = 46,341 is refused by every route, naming n <= 46340; n = 46,340
    is taken; k outside 2..5 stays refused by name."""
    n = tkernel.OPEN_NMAX + 1
    route, why = route_refusal(n, M, k, m)
    assert "n <= 46340" in why
    for use_kernel in ("auto", "on"):
        with pytest.raises(ValueError, match="n <= 46340"):
            kernel_route(use_kernel, CUDA, n, M, k, m)
    assert kernel_route("off", CUDA, n, M, k, m) == "plain"
    assert route_refusal(n - 1, M, k, m) == (route, None)
    assert "k = 2..5" in tgrid.grid_refusal(4096, 1024, 6, 0)


# ---- what each CTA and thread owns -------------------------------------------------

@pytest.mark.parametrize("P", [132, 130, 264])
@pytest.mark.parametrize("n", [2049, 3000, 4096])
def test_every_entry_has_one_owner_in_the_open_form(n, P):
    """On P CTAs every entry of X and x has one owner; the CTAs' slices of
    the owned entries' buffer (at e0 + i0, E words each) tile its n n + n
    words; in the passes in place thread t takes the entries t + 512 i of
    [X | x] (the adjoint's sub-spans of kSub) and at most one x entry, so
    every entry of a CTA is one thread's; lane 0 of warp w takes x entries
    i0 + w + 16 j, each one warp's; launch_grid's check (x entries within
    the threads) holds."""
    sub = int(re.search(r"constexpr int kSub = (\d+);", _source("pdhg_grid.cuh")).group(1))
    owner_X, owner_x = np.zeros(n * n, int), np.zeros(n, int)
    buf = np.zeros(n * n + n, int)
    for (e0, e1), (i0, i1) in zip(_slices(n * n, P), _slices(n, P)):
        owner_X[e0:e1] += 1
        owner_x[i0:i1] += 1
        LA, LB = e1 - e0, i1 - i0
        E = LA + LB
        buf[e0 + i0:e0 + i0 + E] += 1
        assert -(-n // P) <= 512 and LB <= 512
        taken = []
        for t in range(0, 512, 37):     # a sample of the threads
            nA = (LA - 1 - t) // 512 + 1 if t < LA else 0
            jx = LA + ((t - LA) % 512)
            span = -(-nA // sub) * sub
            taken += [t + 512 * (i0_ + i) for i0_ in range(0, span, sub) for i in range(sub)
                      if i0_ + i < nA]
            if jx < E:
                taken.append(jx)
        assert len(taken) == len(set(taken)) and all(0 <= j < E for j in taken)
        by_warp = sorted(i for w in range(16) for i in range(i0 + w, i1, 16))
        assert by_warp == list(range(i0, i1))
    assert (owner_X == 1).all() and (owner_x == 1).all() and (buf == 1).all()


def test_every_thread_entry_is_taken_once_at_n4096():
    """At n = 4096 on 132 CTAs (~127,100 entries a CTA, past kVast's
    31,808): thread t's entries t + 512 i and its x entry cover CTA 0's
    [X | x] exactly once."""
    n, P = 4096, 132
    (e0, e1), (i0, i1) = _slices(n * n, P)[0], _slices(n, P)[0]
    LA, LB = e1 - e0, i1 - i0
    assert LA + LB > tgrid.FORMS[2048][0] and LB > 16
    seen = np.zeros(LA + LB, int)
    for t in range(512):
        nA = (LA - 1 - t) // 512 + 1 if t < LA else 0
        seen[t + 512 * np.arange(nA)] += 1
        jx = LA + ((t - LA) % 512)
        if jx < LA + LB:
            seen[jx] += 1
    assert (seen == 1).all()


# ---- the wrappers' launches in the open form, recorded by a stand-in library ---------

@pytest.mark.parametrize("n,m", [(2049, 0), (2049, 3)])
def test_open_launches_match_the_library(n, m, monkeypatch):
    """The block, the checked launch and the norm marshal the C entries'
    arguments in the open form: its width tag, the layout's shared bytes,
    and a scratch of open_words(n) more floats than the other forms'."""
    lib = _fake_card(monkeypatch)
    allocated = []
    real = tgrid._work

    def work(words, n_, cols, dev):
        allocated.append((words, cols))
        return real(words, n_, cols, dev)

    monkeypatch.setattr(tgrid, "_work", work)
    cx, cX, pool, index, st, dense = _cut_problem(n=n, m=m)
    M, k = pool.idx.shape
    acc, anc = st.map(torch.zeros_like), st.map(torch.clone)
    rec = steps_record([0.1], [0.1], "cpu")[0]
    tgrid._launch_block(cx, cX, pool, index, [st, acc], [st, acc], rec, 3, dense)
    tgrid._checked_launcher(cx, cX, pool, index, st, acc, anc, rec, 100, 500, 1000, 1e-6,
                            dense)()
    names = [c[0] for c in lib.calls]
    assert names == ["pdhg_grid_ctas", "pdhg_grid_block_launch", "pdhg_grid_ctas",
                     "pdhg_grid_block_checked_launch"]
    smem = 4 * tgrid.block_words(n, M, m, True)
    assert lib.calls[1][1][:8] == (n, M, k, m, 3, tkernel.OPEN, 1, smem)
    assert lib.calls[3][1][:8] == (n, M, k, m, 100, tkernel.OPEN, 1, smem)
    assert allocated == [(tgrid.work_words(n, m, M, 132, True, False), tkernel.OPEN),
                         (tgrid.work_words(n, m, M, 132, True, True), tkernel.OPEN)]
    assert real(10, n, tkernel.OPEN, "cpu").numel() == 10 + tgrid.open_words(n)
    assert real(10, n, tkernel.VAST, "cpu").numel() == 10


def test_open_form_forced_where_kvast_takes_n(monkeypatch):
    """The private _open forces the open form at 1024 < n <= 2048 (the
    measurements against kVast), with the open form's tag and scratch; it
    refuses elsewhere."""
    lib = _fake_card(monkeypatch)
    n = 1100
    cx, cX, pool, index, st, dense = _cut_problem(n=n, m=0)
    acc = st.map(torch.zeros_like)
    rec = steps_record([0.1], [0.1], "cpu")[0]
    tgrid._launch_block(cx, cX, pool, index, [st, acc], [st, acc], rec, 3, dense)
    tgrid._launch_block(cx, cX, pool, index, [st, acc], [st, acc], rec, 3, dense, None, True)
    assert [c[1][5] for c in lib.calls if c[0] == "pdhg_grid_block_launch"] == [
        tkernel.VAST, tkernel.OPEN]
    ctas = [c[1] for c in lib.calls if c[0] == "pdhg_grid_ctas"]
    assert ctas[1][4] == tkernel.OPEN
    with pytest.raises(ValueError, match="1024 < n <= 2048"):
        tgrid._form(600, 1024, 3, 0, None, True)


def test_the_certifier_past_n2048_launches_the_open_form_without_cuts(monkeypatch):
    """The dense route's wrappers past n = 2048 launch the grid route's open
    form without cuts (cuts = 0)."""
    lib = _fake_card(monkeypatch)
    n, m = 2049, 5
    pool = tcb.empty_pool(1, 1, "cpu")
    dense = tdr.DenseRows(torch.rand(m, n, n), torch.rand(m, n), torch.rand(m))
    st = tpdhg.init_state(n, 1, "cpu", m)
    acc = st.map(torch.zeros_like)
    rec = steps_record([0.1], [0.1], "cpu")[0]
    tgrid._launch_block(torch.rand(n), torch.rand(n, n), pool, build_cut_index(pool, n),
                        [st, acc], [st, acc], rec, 3, dense)
    assert lib.calls[-1][0] == "pdhg_grid_block_launch"
    assert lib.calls[-1][1][:8] == (n, 1, 1, m, 3, tkernel.OPEN, 0, 4 * tdense.smem_words(n, m))
