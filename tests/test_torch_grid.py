"""The grid route (lp/pdhg_grid.py, csrc/pdhg_grid.cu) on the CPU: the routes
a solve takes on CUDA up to n = 1024 and where the route refuses, the layouts
and scratch summed from the kernel source at the four column widths, the
K2, K6 and K7 layouts at 128 and 256 columns held to copies of their earlier
formulas, a Python mirror of what each CTA of the grid owns, the wrappers'
marshalling against the library's signatures (a stand-in library records
the launches), and the port's plain block, checked block and power iteration
at the route's shapes against the JAX package, whose accelerator path runs
its plain loop there; then the slice as a whole, CutSolver at n = 257 and
CutSolverQCQP on generate_qcqp_band(200, 5, 25, 1) against the JAX package.
The kernels themselves run only on the card (chip_smoke.py phase 19 holds
them to their twins there); torch runs on one thread here."""

import ctypes
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpcutsel_tpu.loop import CutSolver as JaxCutSolver
from sdpcutsel_tpu.lp import pdhg as jpdhg
from sdpcutsel_tpu.qcqp.solver import CutSolverQCQP as JaxCutSolverQCQP
from sdpcutsel_tpu.relax import cutbuffer as jcb
from sdpcutsel_tpu.relax import denserows as jdr
from sdpcutsel_tpu_torch import _build
from sdpcutsel_tpu_torch.config import CutConfig, LPConfig, RunConfig
from sdpcutsel_tpu_torch.instances import generate_spar
from sdpcutsel_tpu_torch.instances.qcqp import generate_qcqp_band
from sdpcutsel_tpu_torch.loop import CutSolver
from sdpcutsel_tpu_torch.lp import pdhg as tpdhg
from sdpcutsel_tpu_torch.lp import pdhg_dense as tdense
from sdpcutsel_tpu_torch.lp import pdhg_grid as tgrid
from sdpcutsel_tpu_torch.lp import pdhg_kernel as tkernel
from sdpcutsel_tpu_torch.lp import pdhg_norm as tnorm
from sdpcutsel_tpu_torch.lp.pdhg_kernel import (SMEM_MAX, kernel_route, pdhg_block_plain,
                                                pdhg_block_steps_plain, plan_refusal,
                                                route_refusal, steps_record)
from sdpcutsel_tpu_torch.qcqp import CutSolverQCQP
from sdpcutsel_tpu_torch.relax import cutbuffer as tcb
from sdpcutsel_tpu_torch.relax import denserows as tdr
from sdpcutsel_tpu_torch.relax.cutbuffer import build_cut_index
from test_torch_portmods import reference_config
from test_torch_solver_k4 import EDGE, _record_checks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "sdpcutsel_tpu_torch", "csrc")
CUDA = torch.device("cuda")
FIELDS = ("x", "X", "yA", "yB", "yC", "yD")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's CPU threads share this process; torch's intra-op pool on top of
    them oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the routes on CUDA ---------------------------------------------------------

GRID_SHAPES = [(257, 1024, 3, 0), (300, 1024, 3, 0), (512, 1024, 3, 0), (200, 1024, 5, 25),
               *((150, 1024, 5, m) for m in (26, 32, 48, 64)),
               # the 1024-column form
               *((n, 1024, k, m) for n in (513, 520, 600, 700, 1000, 1024)
                 for k, m in ((3, 0), (5, 25)))]
# the shapes the tests of K2's two widths route to K2 (tests/test_torch_wide.py,
# test_torch_pdhg.py)
K2_SHAPES = [(125, 1024, 3, 0), (100, 1024, 5, 25), (125, 2048, 3, 0), (128, 2048, 5, 25),
             *((n, 1024, k, 0) for n in (129, 150, 200, 256) for k in (3, 5)),
             (150, 1024, 3, 25), (200, 1024, 3, 10), (256, 1024, 3, 2), (150, 1024, 5, 16),
             (256, 2048, 5, 0)]


@pytest.mark.parametrize("n,M,k,m", GRID_SHAPES)
def test_grid_route_where_k2s_cluster_refuses(n, M, k, m):
    """Past K2's cluster (n > 256, or dense rows past its shared memory at
    n = 150 and 200) "auto" and "on" take the grid route on CUDA, at
    n > 512 its 1024-column form; "off" stays plain, and "auto" on the CPU
    too."""
    assert plan_refusal(n, M, k, m) is not None
    assert tgrid.grid_refusal(n, M, k, m) is None
    assert 4 * tgrid.block_words(n, M, m, True) <= SMEM_MAX
    assert (tkernel.columns(n) == tkernel.HUGE) is (n > 512)
    assert route_refusal(n, M, k, m) == ("grid", None)
    assert kernel_route("auto", CUDA, n, M, k, m) == "grid"
    assert kernel_route("on", CUDA, n, M, k, m) == "grid"
    assert kernel_route("off", CUDA, n, M, k, m) == "plain"
    assert kernel_route("auto", torch.device("cpu"), n, M, k, m) == "plain"


@pytest.mark.parametrize("n,M,k,m", K2_SHAPES)
def test_k2_keeps_every_shape_it_took(n, M, k, m):
    assert plan_refusal(n, M, k, m) is None
    assert route_refusal(n, M, k, m) == ("k2", None)
    assert kernel_route("auto", CUDA, n, M, k, m) == "k2"


@pytest.mark.parametrize("n,m", [(300, 368), (300, 2048), (512, 2048), (257, 1), (600, 368),
                                 (600, 2048), (1024, 368), (1024, 2048)])
def test_dense_route_takes_the_certifier_past_n256(n, m):
    """The certifier's pool past n = 256 stays on the dense route, whose
    wrappers launch the grid route's form without cuts at 512 or 1024
    columns."""
    assert route_refusal(n, 1, 1, m) == ("dense", None)
    assert kernel_route("auto", CUDA, n, 1, 1, m) == "dense"
    assert tdense.block_plan(n, m) == "grid"
    assert tdense.smem_words(n, m) == tgrid.block_words(n, 1, m, False)
    assert 4 * tdense.smem_words(n, m) <= SMEM_MAX
    assert tdense.max_dense_rows(n) >= 2048
    assert tdense.max_entries(n) == tgrid.FORMS[tkernel.columns(n)][0]


@pytest.mark.parametrize("M,k,m", [(1024, 3, 0), (1024, 5, 25), (1, 1, 368)])
def test_n513_is_refused_by_every_route(M, k, m):
    """n = 46,341, past the open form's 32-bit bound, is refused on CUDA
    under "auto" and "on", naming n <= 46340, with no fall back to the plain
    loop; "off" runs plain.  n = 513, 1025 and 2049 are taken now, on the
    route that takes n = 2048."""
    n = tkernel.OPEN_NMAX + 1
    route, why = route_refusal(n, M, k, m)
    assert "n <= 46340" in why
    if route == "grid":                # every route's reason: K2's first
        assert why.startswith("pdhg_block kernel takes 1 <= n <= 256")
    for use_kernel in ("auto", "on"):
        with pytest.raises(ValueError, match="n <= 46340"):
            kernel_route(use_kernel, CUDA, n, M, k, m)
    assert kernel_route("off", CUDA, n, M, k, m) == "plain"
    assert route_refusal(2049, M, k, m) == (route, None)
    assert route_refusal(513, M, k, m)[1] is None
    assert route_refusal(1025, M, k, m) == (route, None)
    assert kernel_route("auto", CUDA, 1025, M, k, m) == route


def test_grid_refusal_reasons():
    """Past a CTA's shared memory the route takes the pool in its far form;
    cuts of width 1..6 and n outside 1..46340 are refused by name; K2's
    reason comes first where neither takes a shape."""
    assert "k = 2..5" in tgrid.grid_refusal(300, 1024, 6, 0)
    assert "n <= 46340" in tgrid.grid_refusal(0, 1024, 3, 0)
    assert "n <= 46340" in tgrid.grid_refusal(46341, 1024, 3, 0)
    assert tgrid.grid_refusal(2049, 1024, 3, 0) is None
    assert tgrid.grid_refusal(1025, 1024, 3, 0) is None
    top = max(M for M in range(1024, 40000, 64)
              if 4 * tgrid.block_words(512, M, 0, True) <= SMEM_MAX)
    assert not tgrid.grid_form(512, top, 0, True) and tgrid.grid_form(512, top + 64, 0, True)
    assert tgrid.grid_refusal(512, top + 64, 3, 0) is None
    assert route_refusal(512, top + 64, 3, 0) == ("grid", None)
    route, both = route_refusal(512, top, 6, 0)
    why = tgrid.grid_refusal(512, top, 6, 0)
    assert route == "grid" and both.startswith(plan_refusal(512, top, 6, 0))
    assert why in both


def test_batched_setup_refuses_the_grid_route():
    """A batch refuses the grid route only where the route refuses the shape:
    at n = 257 with "on" its setup takes it (the batched norm's twin on the
    CPU), at n = 46,341 it raises with the route's reason; n = 1025 is the
    grid route's."""
    inst = generate_spar(257, 100, 1)
    pool = tcb.empty_pool(64, 3, "cpu")
    batch = tcb.CutPool(*(t[None] for t in (pool.idx, pool.lin, pool.quad, pool.rhs,
                                            pool.active, pool.count)))
    c = torch.as_tensor(inst.c[None], dtype=torch.float32)
    setup = tpdhg.solve_setup_batched(c, batch, LPConfig(use_kernel="on"))
    assert setup.route == "grid"
    assert torch.equal(setup.normK, tpdhg.estimate_norm_batched_plain(batch, 257, 30, None,
                                                                      setup.index))
    with pytest.raises(ValueError, match="n <= 46340"):
        tpdhg.solve_setup_batched(torch.zeros(1, 46341), batch, LPConfig(use_kernel="on"))
    assert route_refusal(1025, 64, 3, 0) == ("grid", None)


# ---- the layouts, summed from the kernel source ---------------------------------

def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _forms_from_source() -> dict:
    """GridForm<Cols>'s constants of csrc/pdhg_grid.cuh by column width."""
    widths = {"kNarrow": 128, "kWide": 256, "kWidest": 512, "kHuge": 1024, "kVast": 2048,
              "kOpen": 65536}
    out = {}
    for name, body in re.findall(r"struct GridForm<(\w+)> \{\s*static constexpr int ([^;]*);",
                                 _source("pdhg_grid.cuh")):
        vals = dict(re.findall(r"(\w+) = (\d+)", body))
        out[widths[name]] = tuple(int(vals[k]) for k in ("kMaxE", "kChunks", "kScratch",
                                                          "kStages", "kState"))
    return out


def test_forms_match_the_kernel_source():
    assert _forms_from_source() == tgrid.FORMS
    text = _source("pdhg_grid.cuh")
    assert f"constexpr int kStage = {tgrid._STAGE};" in text
    assert f"constexpr int kNS = {tgrid._NS};" in text


def _python(expr: str) -> str:
    """A C expression of the layout (+, *, &, ~, comparisons, ||, &&, ?:,
    nested) as Python: each innermost parenthesised group converted first
    and set aside."""
    expr = " ".join(expr.split()).replace(" || ", " or ").replace(" && ", " and ")
    groups = {}

    def flat(e: str) -> str:            # no parentheses left in e
        if "?" not in e:
            return e
        cond, rest = e.split("?", 1)
        a, b = rest.split(":", 1)
        return f"(({flat(a)}) if ({cond}) else ({flat(b)}))"

    while "(" in expr:
        m = re.search(r"\(([^()]*)\)", expr)
        key = f"_g{len(groups)}_"
        groups[key] = f"({flat(m.group(1))})"
        expr = expr[:m.start()] + key + expr[m.end():]
    expr = flat(expr)
    while "_g" in expr:
        expr = re.sub(r"_g\d+_", lambda g: groups[g.group(0)], expr)
    return expr


def _grid_layout_words(n: int, M: int, m: int, cuts: bool, far: bool = False) -> int:
    """csrc/pdhg_grid.cuh's grid_layout at n's column width (``far``: the far
    form's): the sum of its TAKE lines and the values they take, evaluated
    from the source."""
    kmax, _, scratch, stages, state = tgrid.FORMS[tkernel.columns(n)]
    text = _source("pdhg_grid.cuh")
    body = text[text.index("inline GridLayout grid_layout("):]
    body = body[:body.index("#undef TAKE")]
    body = (body.replace("F::kMaxE", str(kmax)).replace("F::kScratch", str(scratch))
            .replace("F::kStages", str(stages)).replace("F::kState", str(state)))
    names = dict(n=n, m=m, M=M, cuts=cuts, far=far, kStage=tgrid._STAGE, kSmemWords=SMEM_MAX // 4,
                 kMeta=int(re.search(r"constexpr int kMeta = (\d+);", text).group(1)))
    for var, expr in re.findall(r"const int (\w+) = (.*?);", body):
        names[var] = eval(_python(expr), {}, names)                       # noqa: S307
    return sum(eval(_python(e), {}, names)                                # noqa: S307
               for e in re.findall(r"TAKE\(\w+, ([^;]*?)\);", body))


@pytest.mark.parametrize("n", [20, 128, 150, 256, 257, 300, 512, 513, 600, 700, 1000, 1024])
@pytest.mark.parametrize("M,m", [(1024, 0), (1024, 25), (1024, 368), (1, 2048), (4096, 64)])
def test_grid_layout_matches_the_kernel_source(n, M, m):
    """block_words is csrc/pdhg_grid.cu's grid_layout at every width, with
    and without cuts; without dense rows there is no slab; the owned state
    takes eight arrays of kMaxE words up to 512 columns and none at 1024."""
    for cuts in (True, False):
        assert tgrid.block_words(n, M, m, cuts) == _grid_layout_words(n, M, m, cuts)
    kmax, _, scratch, _, state = tgrid.FORMS[tkernel.columns(n)]
    assert state == (0 if n > 512 else 8)
    if m == 0:
        assert tgrid.block_words(n, M, 0, True) == tgrid._META + scratch + M + (1 + state) * kmax


def _work_expr(fn: str) -> str:
    text = _source("pdhg_grid.cuh")
    body = text[text.index(f" {fn}("):]
    expr = re.search(r"return (.*?);", body, re.S).group(1)
    expr = re.sub(r"static_cast<size_t>\((\w+)\)", r"\1", " ".join(expr.split()))
    expr = expr.replace(" && ", " and ")
    return re.sub(r"\(([\w ]+?) \? (.*?) : 0\)", r"((\2) if (\1) else 0)", expr)


@pytest.mark.parametrize("n,m,M,P", [(512, 0, 1024, 132), (300, 368, 1, 132), (200, 25, 1024, 66),
                                     (150, 64, 2048, 264), (1024, 25, 1024, 132),
                                     (600, 368, 1, 132)])
def test_grid_work_matches_the_kernel_source(n, m, M, P):
    """work_words and norm_work_words are csrc/pdhg_grid.cu's, evaluated
    from the source, with and without cuts and the checked form's extras."""
    for cuts in (True, False):
        names = dict(n=n, m=m, M=M, P=P, NN=n * n, Pm=P * m, cuts=cuts, far=False, kNS=10,
                     kND=6)
        assert tgrid.norm_work_words(n, m, M, P, cuts) == eval(              # noqa: S307
            _work_expr("norm_work_words"), {}, names)
        for checked in (True, False):
            names["checked"] = checked
            assert tgrid.work_words(n, m, M, P, cuts, checked) == eval(      # noqa: S307
                _work_expr("work_words"), {}, names)


# ---- K2's, K6's and K7's layouts at 128 and 256 columns, as they were -----------

def _two_width_k2_words(n, M, k, m, C, checked):
    """lp/pdhg_kernel.py::_smem_words before the grid route."""
    R, Mc = -(-n // C), -(-M // C)
    RN, cols = R * n, 128 if n <= 128 else 256
    check = C * 2 * 8 + C * 6 + (512 // 32) * 2 * 8 + 2 * 8 + 6 + 8
    return (10 * RN + 2 * R * (cols // 32) + C * (512 // cols) * R + 3 * R + cols + M
            + Mc * (4 + 2 * k + k * k) + m * RN + m * R + 3 * m + C * m + RN + 1 + R + 1
            + (check if checked and RN < check else 0))


def _two_width_norm_words(n, M, k, m, C):
    """lp/pdhg_norm.py::smem_words before the grid route."""
    R, Mc = -(-n // C), -(-M // C)
    RN, cols = R * n, 128 if n <= 128 else 256
    base = (4 * RN + 2 * R * (cols // 32) + C * (512 // cols) * R + cols + R + M + C * m + m
            + C * 4 + 32 + 4)
    words = SMEM_MAX // 4
    resident = m > 0 and base + m * (RN + R) <= words
    o = base + (m * (RN + R) if resident else 0)
    staged = o + Mc * (1 + 2 * k + 2 * k * k) + (RN + 1) + (R + 1) <= words
    if staged:
        o += Mc * (1 + 2 * k + 2 * k * k) + (RN + 1) + (R + 1)
        o += 2 * ((words - o) // 2)
    return o, resident, staged


def _two_width_dense_words(plan, n, m):
    """lp/pdhg_dense.py::_block_words before the grid route."""
    V4 = (n * n + n + 3) & ~3
    if plan == "cta":
        return m * V4 + 8 * n * n + 2 * V4 + 3 * n + 4 * m + 4 * 512
    rest = 2048 + m + (496 if n <= 128 else 500)
    return max((SMEM_MAX // 4 - rest) & ~3, 4 * 8192) + rest


@pytest.mark.parametrize("n", [1, 33, 64, 100, 125, 128, 129, 150, 200, 255, 256])
def test_k2_k6_k7_layouts_are_unchanged(n):
    """At both of K2's widths the cluster's, the norm's and the dense
    route's layouts equal their formulas before the grid route, word for
    word."""
    for M in (40, 1024, 2048, 13808):
        for k in (2, 3, 5):
            for m in (0, 1, 25, 200):
                assert tnorm.smem_words(n, M, k, m) == _two_width_norm_words(n, M, k, m, 16)
                for C in (8, 16):
                    for checked in (False, True):
                        assert (tkernel._smem_words(n, M, k, m, C, checked)
                                == _two_width_k2_words(n, M, k, m, C, checked))
    for m in (0, 1, 40, 368, 2048):
        for plan in ("cta", "grid"):
            assert tdense._block_words(plan, n, m) == _two_width_dense_words(plan, n, m)


# ---- what each CTA owns: a Python mirror of csrc/pdhg_grid.cu's Slices -----------

def _slices(N: int, P: int):
    return [(N * b // P, N * (b + 1) // P) for b in range(P)]


def _lanes(cr: int, kchunks: int):
    """The adjoint's lanes of a CTA whose spans take cr chunks: (strands NS,
    threads a strand, chunks a lane), as Slices sets them."""
    tps = min(cr, 128)
    return (512 // tps) & ~3, tps, -(-cr // tps)


def _pool_index(n: int, k: int = 3, M: int = 1024, live: int = 400, seed: int = 5):
    rng = np.random.default_rng(seed)
    idx = np.sort(np.stack([rng.choice(n, k, replace=False) for _ in range(live)]), axis=1)
    pool = tcb.append_cuts(tcb.empty_pool(M, k, "cpu"), torch.as_tensor(idx),
                           torch.rand(live, k), torch.rand(live, k, k), torch.rand(live),
                           torch.ones(live))
    return build_cut_index(pool, n)


@pytest.mark.parametrize("P", [132, 130, 264])
@pytest.mark.parametrize("n", [257, 300, 512, 600, 1024])
def test_every_entry_slot_and_term_has_one_owner(n, P):
    """On P CTAs every entry of X and x, every pool slot and every term of
    the cut index (the segments of the owned entries) has exactly one owner,
    and what a CTA owns fits the form: entries within kMaxE, x entries
    within the warps, slots within the threads, its spans within the
    adjoint's lanes and the scratch (at 1024 columns: every owned entry one
    thread's in the passes by entry, a row's spans within a ring stage), the
    distances' copy within the scratch."""
    kmax, kchunks, scratch, _, state = tgrid.FORMS[tkernel.columns(n)]
    M = 1024
    index = _pool_index(n, M=M)
    Xoff, xoff = index.Xoff.numpy(), index.xoff.numpy()
    owner_X, owner_x, owner_s = np.zeros(n * n, int), np.zeros(n, int), np.zeros(M, int)
    terms_X, terms_x = np.zeros(int(Xoff[-1]), int), np.zeros(int(xoff[-1]), int)
    for (e0, e1), (i0, i1), (s0, s1) in zip(_slices(n * n, P), _slices(n, P), _slices(M, P)):
        owner_X[e0:e1] += 1
        owner_x[i0:i1] += 1
        owner_s[s0:s1] += 1
        terms_X[Xoff[e0]:Xoff[e1]] += 1
        terms_x[xoff[i0]:xoff[i1]] += 1
        LA, LB = e1 - e0, i1 - i0
        assert LA + LB <= kmax and LB <= 16 and s1 - s0 <= 512
        ES = ((LA + 6) & ~3) + ((LB + 6) & ~3)
        if state == 0:
            span = -(-kmax // 512)             # Slices::kSpan
            assert sorted(t + 512 * i for t in range(512) for i in range(span)
                          if t + 512 * i < LA + LB) == list(range(LA + LB))
            assert ES <= tgrid._STAGE
            continue
        cr = ES // 4
        NS, tps, KC = _lanes(cr, kchunks)
        assert NS >= 4 and NS % 4 == 0 and KC <= kchunks
        assert NS * cr * 4 <= scratch and 4 * ES <= scratch
        covered = sorted(c for ct in range(tps) for j in range(KC) if (c := ct + tps * j) < cr)
        assert covered == list(range(cr))
    assert (owner_X == 1).all() and (owner_x == 1).all() and (owner_s == 1).all()
    assert (terms_X == 1).all() and (terms_x == 1).all()
    assert 256 + P * 6 <= scratch
    if state == 0:   # entry_residual's sums (8 rows x 16 warps) at the scratch's end
        assert max(256 + P * 6, 128 + n) <= scratch - 8 * 16


# ---- the wrappers' launches, recorded by a stand-in library ----------------------

class _RecordingLib:
    """The kernel library without a card: every call's arguments checked
    against the library's signatures and recorded; the grid is ``P``."""

    def __init__(self, P: int = 132):
        self.P, self.calls = P, []

    def __getattr__(self, name):
        sig = _build._SIGNATURES[name]

        def call(*args):
            assert len(args) == len(sig), (name, len(args), len(sig))
            for a, t in zip(args, sig):
                if t is ctypes.c_int:
                    assert isinstance(a, int), (name, a)
                if t is ctypes.c_float:
                    assert isinstance(a, float), (name, a)
            if name.endswith("_ctas") or name.endswith("_grid"):
                args[-1]._obj.value = self.P
            self.calls.append((name, args))
            return 0
        return call


def _fake_card(monkeypatch):
    lib = _RecordingLib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: type("S", (), {"cuda_stream": 0})())
    return lib


def _cut_problem(n=20, M=64, k=3, m=5, seed=0):
    rng = np.random.default_rng(seed)
    live = 10
    idx = np.sort(np.stack([rng.choice(n, k, replace=False) for _ in range(live)]), axis=1)
    pool = tcb.append_cuts(tcb.empty_pool(M, k, "cpu"), torch.as_tensor(idx),
                           torch.rand(live, k), torch.rand(live, k, k), torch.rand(live),
                           torch.ones(live))
    dense = None if m == 0 else tdr.DenseRows(torch.rand(m, n, n), torch.rand(m, n),
                                              torch.rand(m))
    st = tpdhg.init_state(n, M, "cpu", m)
    return torch.rand(n), torch.rand(n, n), pool, build_cut_index(pool, n), st, dense


@pytest.mark.parametrize("n,m", [(20, 5), (20, 0), (300, 0), (600, 0), (600, 5), (1024, 0)])
def test_grid_launches_match_the_library(n, m, monkeypatch):
    """The block, the checked launch and the norm marshal the arguments the
    C entries take (count and kinds), at n's width, with cuts, the layout's
    shared bytes and scratch of work_words / norm_work_words floats on the
    grid; each counts its launch."""
    lib = _fake_card(monkeypatch)
    cx, cX, pool, index, st, dense = _cut_problem(n=n, m=m)
    M, k = pool.idx.shape
    acc, anc = st.map(torch.zeros_like), st.map(torch.clone)
    rec = steps_record([0.1], [0.1], "cpu")[0]
    before = (tgrid.pdhg_grid_block.launches, tgrid.pdhg_grid_block_checked.launches)
    tgrid._launch_block(cx, cX, pool, index, [st, acc], [st, acc], rec, 3, dense)
    tgrid._checked_launcher(cx, cX, pool, index, st, acc, anc, rec, 100, 500, 1000, 1e-6,
                            dense)()
    names = [c[0] for c in lib.calls]
    assert names == ["pdhg_grid_ctas", "pdhg_grid_block_launch", "pdhg_grid_ctas",
                     "pdhg_grid_block_checked_launch"]
    smem = 4 * tgrid.block_words(n, M, m, True)
    assert lib.calls[1][1][:8] == (n, M, k, m, 3, tkernel.columns(n), 1, smem)
    assert lib.calls[3][1][:8] == (n, M, k, m, 100, tkernel.columns(n), 1, smem)
    assert (tgrid.pdhg_grid_block.launches, tgrid.pdhg_grid_block_checked.launches) == (
        before[0] + 2, before[1] + 1)


@pytest.mark.parametrize("n,cols", [(300, 512), (600, 1024)])
def test_dense_route_past_n256_launches_the_grid_form_without_cuts(n, cols, monkeypatch):
    """The dense route's wrappers past n = 256 launch the grid route's form
    without cuts (cuts = 0) at 512 columns, past n = 512 at 1024; at
    n <= 256 they keep K7's."""
    lib = _fake_card(monkeypatch)
    m = 7
    pool = tcb.empty_pool(1, 1, "cpu")
    index = build_cut_index(pool, n)
    dense = tdr.DenseRows(torch.rand(m, n, n), torch.rand(m, n), torch.rand(m))
    st = tpdhg.init_state(n, 1, "cpu", m)
    acc = st.map(torch.zeros_like)
    rec = steps_record([0.1], [0.1], "cpu")[0]
    tgrid._launch_block(torch.rand(n), torch.rand(n, n), pool, index, [st, acc], [st, acc], rec,
                        3, dense)
    args = lib.calls[-1][1]
    assert lib.calls[-1][0] == "pdhg_grid_block_launch"
    assert args[:8] == (n, 1, 1, m, 3, cols, 0, 4 * tdense.smem_words(n, m))
    with pytest.raises(ValueError, match="past n = 256"):
        n = 100
        tgrid._launch_block(torch.rand(n), torch.rand(n, n), pool, build_cut_index(pool, n),
                            [tpdhg.init_state(n, 1, "cpu", m)] * 2,
                            [tpdhg.init_state(n, 1, "cpu", m)] * 2, rec, 3,
                            tdr.DenseRows(torch.rand(m, n, n), torch.rand(m, n), torch.rand(m)))


def test_grid_wrappers_refuse_other_devices():
    cx, cX, pool, index, st, dense = _cut_problem(n=6, m=2)
    meta = lambda t: t.to("meta")      # noqa: E731
    mst = st.map(meta)
    mpool = tcb.CutPool(*(meta(t) for t in (pool.idx, pool.lin, pool.quad, pool.rhs,
                                            pool.active, pool.count)))
    mdense = tdr.DenseRows(*(meta(t) for t in (dense.G, dense.g, dense.h)))
    rec = torch.zeros(tpdhg.REC_WORDS, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tgrid.pdhg_grid_block(meta(cx), meta(cX), mpool, index, mst, mst, 0.1, 0.1, 3, mdense)
    with pytest.raises(ValueError, match="no kernel"):
        tgrid.pdhg_grid_block_steps(meta(cx), meta(cX), mpool, index, mst, mst, rec, 3, mdense)
    with pytest.raises(ValueError, match="no kernel"):
        tgrid.pdhg_grid_block_checked(meta(cx), meta(cX), mpool, index, mst, mst, mst, rec, 100,
                                      300, 1000, 1e-6, mdense)
    with pytest.raises(ValueError, match="no kernel"):
        tgrid.pdhg_grid_norm(mpool, 6, 30, torch.Generator().manual_seed(0), index, mdense)


# ---- the port's plain loop at the route's shapes against the JAX package ---------

def _grid_case(n: int, k: int, m: int, M: int = 64, seed: int = 7):
    """A pool of unit cuts of width k on distinct random supports (8 slots
    inactive) and a random state at n, with generate_qcqp_band(n, 5, m, 1)'s
    objective and dense rows where m > 0 (generate_spar(n, 100, 1)'s
    otherwise), in both packages."""
    rng = np.random.default_rng(seed)
    if m:
        q = generate_qcqp_band(n, 5, m, 1)
        Q, c = q.Q0, q.c0
        jd = jdr.dense_from_qcqp(q.Qs, q.cs, q.bs)
        td = tdr.dense_from_qcqp(q.Qs, q.cs, q.bs, "cpu")
    else:
        inst = generate_spar(n, 100, 1)
        Q, c, jd, td = inst.Q, inst.c, jdr.empty_dense(n, jnp.float32), None
    cX, cx = (-0.5 * Q).astype(np.float32), (-c).astype(np.float32)
    live = M - 8
    idx = np.stack([np.sort(rng.choice(n, k, replace=False)) for _ in range(live)])
    lin = rng.standard_normal((live, k))
    quad = rng.standard_normal((live, k, k))
    quad = 0.5 * (quad + quad.transpose(0, 2, 1))
    nrm = np.sqrt((lin ** 2).sum(1) + (quad ** 2).sum((1, 2)))
    cuts = (idx.astype(np.int32), (lin / nrm[:, None]).astype(np.float32),
            (quad / nrm[:, None, None]).astype(np.float32),
            (-0.1 * rng.random(live) / nrm).astype(np.float32), np.ones(live, np.float32))
    X = rng.random((n, n)).astype(np.float32)
    pt = dict(x=rng.random(n).astype(np.float32), X=0.5 * (X + X.T),
              yA=0.1 * rng.random((n, n)).astype(np.float32),
              yB=0.1 * rng.random((n, n)).astype(np.float32),
              yC=np.where(np.arange(M) < live, 0.05 * rng.random(M), 0.0).astype(np.float32),
              yD=(0.2 * rng.random(m)).astype(np.float32))
    jpool = jcb.append_cuts(jcb.empty_pool(M, k), *(jnp.asarray(a) for a in cuts))
    tpool = tcb.append_cuts(tcb.empty_pool(M, k, "cpu"), *(torch.as_tensor(a) for a in cuts))
    jst = jpdhg.PDHGState(**{f: jnp.asarray(a) for f, a in pt.items()})
    tst = tpdhg.PDHGState(**{f: torch.as_tensor(a) for f, a in pt.items()})
    return ((jnp.asarray(cx), jnp.asarray(cX), jpool, jd, jst),
            (torch.as_tensor(cx), torch.as_tensor(cX), tpool, td, tst))


CASES = {"n=300 k=3": (300, 3, 0), "n=200 k=5 m=25": (200, 5, 25)}


@pytest.mark.parametrize("case", CASES)
def test_plain_block_matches_the_reference(case):
    """30 iterations of the port's pdhg_block_plain through the grid
    route's wrapper on the CPU against the JAX package's _one_iter loop (the
    XLA loop its solve runs at these shapes), state and ergodic sums at
    rtol = atol = 2e-5."""
    n, k, m = CASES[case]
    (jcx, jcX, jpool, jd, jst), (tcx, tcX, tpool, td, tst) = _grid_case(n, k, m)
    eta = 0.95 / float(jpdhg.estimate_norm(jpool, n, 30, jnp.float32, jd))

    def body(_, carry):
        s, a = carry
        s = jpdhg._one_iter(jcx, jcX, jpool, jd, n, s, eta, eta)
        return s, jax.tree.map(lambda u, v: u + v, a, s)

    ref, racc = jax.jit(lambda s: jax.lax.fori_loop(
        0, 30, body, (s, jax.tree.map(jnp.zeros_like, s))))(jst)
    st, acc = tgrid.pdhg_grid_block(tcx, tcX, tpool, build_cut_index(tpool, n), tst,
                                    tst.map(torch.zeros_like), eta, eta, 30, td)
    for name in FIELDS:
        for got, want in ((st, ref), (acc, racc)):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("restart_period", [10 ** 6, 100])
@pytest.mark.parametrize("case", CASES)
def test_checked_step_on_the_cpu_is_the_block_then_the_check(case, restart_period):
    """On the CPU the grid route's checked step is the block's twin followed
    by the check's, bit for bit, over two steps; nothing is launched."""
    n, k, m = CASES[case]
    _, (cx, cX, pool, dense, st) = _grid_case(n, k, m)
    index = build_cut_index(pool, n)
    normK = tpdhg.estimate_norm_plain(pool, n, 30, None, index, dense)
    rec = tpdhg.new_record(normK, 1.0, 0.95, 10 ** 6, 1e-9, "cpu")
    rec[tpdhg.REC_WLEN] = 63
    before = (tgrid.pdhg_grid_block.launches, tgrid.pdhg_grid_block_checked.launches)

    def bufs():
        return [st.map(torch.clone), st.map(lambda t: t * 37.0), st.map(lambda t: t * 0.5),
                rec.clone()]

    mine, theirs = bufs(), bufs()
    step = tgrid.grid_checked_step(cx, cX, pool, index, *mine, 37, restart_period, 10 ** 6,
                                   1e-9, dense)
    for _ in range(2):
        step()
        pdhg_block_steps_plain(cx, cX, pool, index, theirs[0], theirs[1], theirs[3], 37, dense)
        tpdhg.pdhg_check_plain(cx, cX, pool, index, *theirs, 37, restart_period, 10 ** 6, 1e-9,
                               dense)
        for a, b in zip(mine[:3], theirs[:3]):
            assert all(torch.equal(u, v) for u, v in zip(a.fields(), b.fields()))
        assert torch.equal(mine[3], theirs[3])
    assert (tgrid.pdhg_grid_block.launches, tgrid.pdhg_grid_block_checked.launches) == before


@pytest.mark.parametrize("case", CASES)
def test_checked_block_matches_the_reference_checked_block(case):
    """One checked block through the grid route's wrapper on the CPU against
    the JAX package's checked_block (its _solve_impl run for one block) from
    the same state at the same normK, restart_period 100: the states at
    rtol/atol 2e-5, omega at rtol 1e-4, the iteration count equal (the K5
    test's tolerances, tests/test_torch_pdhg_check.py)."""
    n, k, m = CASES[case]
    (jcx, jcX, jpool, jd, jst), (cx, cX, pool, dense, tst) = _grid_case(n, k, m, seed=13)
    normK = float(jpdhg.estimate_norm(jpool, n, 30, jnp.float32, jd))
    st_j, info_j = jpdhg._solve_impl(jcx, jcX, jpool, jd, jst, normK, 1.0, 1e-12, 1e-6, 0.95,
                                     100, 100, 100)
    st, anc, acc = tpdhg._buffers(tst)
    rec = tpdhg.new_record(normK, 1.0, 0.95, 100, 1e-12, "cpu")
    tgrid.pdhg_grid_block_checked(cx, cX, pool, build_cut_index(pool, n), st, acc, anc, rec, 100,
                                  100, 100, 1e-12, dense)
    f = tpdhg.record_floats(rec.numpy())
    assert int(rec[tpdhg.REC_IT]) == int(info_j["iters"]) == 100
    assert int(rec[tpdhg.REC_STOP]) == 1
    np.testing.assert_allclose(f[tpdhg.REC_OMEGA], float(info_j["omega"]), rtol=1e-4)
    for name in FIELDS:
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(st_j, name)),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", CASES)
def test_norm_on_the_cpu_is_the_twin_and_near_the_reference(case):
    """The grid route's norm on the CPU is estimate_norm_plain bit for bit,
    and within 2% of the JAX package's estimate_norm, whose start vector is
    another draw (tests/test_torch_pdhg_norm.py's tolerance)."""
    n, k, m = CASES[case]
    (_, _, jpool, jd, _), (_, _, pool, dense, _) = _grid_case(n, k, m)
    index = build_cut_index(pool, n)
    before = tgrid.pdhg_grid_norm.launches
    for gen in (lambda: torch.Generator().manual_seed(0), lambda: None):
        got = tgrid.pdhg_grid_norm(pool, n, 30, gen(), index, dense)
        assert torch.equal(got, tpdhg.estimate_norm_plain(pool, n, 30, gen(), index, dense))
    assert tgrid.pdhg_grid_norm.launches == before
    ref = float(jpdhg.estimate_norm(jpool, n, 30, jnp.float32, jd))
    np.testing.assert_allclose(float(got), ref, rtol=2e-2)


def test_solve_setup_takes_the_grid_route_and_its_norm(monkeypatch):
    """With "on" a solve at n = 257 sets up on the grid route, whose norm
    and checked step are the grid wrappers' (the twins on the CPU)."""
    calls = []
    real = tgrid.grid_checked_step

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tgrid, "grid_checked_step", counted)
    n = 257
    inst = generate_spar(n, 100, 1)
    Q, c = (torch.as_tensor(a, dtype=torch.float32) for a in (inst.Q, inst.c))
    pool = tcb.empty_pool(64, 3, "cpu")
    cfg = LPConfig(max_iters=200, tol=1e-12, use_kernel="on")
    setup = tpdhg.solve_setup(c, pool, cfg)
    assert setup.route == "grid"
    assert torch.equal(setup.normK, tpdhg.estimate_norm_plain(pool, n, 30, None, setup.index))
    _, info = tpdhg.solve_lp(Q, c, pool, tpdhg.init_state(n, 64, "cpu"), cfg, setup=setup)
    assert calls == [1] and info["iters"] == 200


# ---- the slice: the solvers at the route's shapes against the JAX package --------

# LPConfig of the parity run at n = 257: every LP of both rounds stops on its
# stop test, inside EDGE (tests/test_torch_solver_k4.py), before its cap
GRID_LP = LPConfig(max_iters=20000, tol=3e-5, use_kernel="on")


def _checks_recorded(monkeypatch) -> list:
    """tests/test_torch_solver_k4.py's record of every check's relative KKT
    error, through the grid route's wrappers too (they call the twin check
    by the name they imported)."""
    solves = _record_checks(monkeypatch)
    monkeypatch.setattr(tgrid, "pdhg_check_plain", tpdhg.pdhg_check_plain)
    return solves


def _plain(cfg: RunConfig) -> RunConfig:
    """The reference's configuration: its "auto", the plain loop it runs on
    the CPU and, past its kernel's shapes, on its accelerator too ("on"
    would ask its Pallas kernel for n <= 128 alone)."""
    return dataclasses.replace(cfg, lp=dataclasses.replace(cfg.lp, use_kernel="auto"))


def test_cut_solver_n257_matches_reference(monkeypatch):
    """Two rounds of the port's CutSolver on generate_spar(257, 100, 1), past
    K2's cluster, through the grid route's wrappers ("on"; their twins on the
    CPU), against the JAX package's at rtol 2e-3 per round; round 0 with the
    same LP iterations and cuts; every LP of the port stops on its stop test
    before the cap, inside EDGE."""
    inst = generate_spar(257, 100, 1)
    cfg = RunConfig(lp=GRID_LP)
    ref = JaxCutSolver(inst, reference_config(_plain(cfg))).run(rounds=2)
    solves = _checks_recorded(monkeypatch)
    got = CutSolver(inst, cfg, device="cpu").run(rounds=2)
    assert len(got) == len(ref) == 2
    assert got[0].lp_iters == ref[0].lp_iters
    assert got[0].cuts_added == ref[0].cuts_added > 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.bound, r.bound, rtol=2e-3)
        assert g.lp_iters < GRID_LP.max_iters
    solves = [s for s in solves if s]
    assert len(solves) == 2
    for checks in solves:
        assert checks[-1] <= EDGE[0] * GRID_LP.tol
        assert len(checks) == 1 or checks[-2] >= EDGE[1] * GRID_LP.tol


# round 0 on the band instance: its LP creeps along tol for thousands of
# iterations (it stops at 1,900 by the test at tol 1e-4, at 0.91 of tol, on
# the edge, and at 9,600 at tol 6e-5, which takes ~25 s of the port's and ~70 s
# of the reference's on one CPU thread), so both packages run it to a fixed
# budget and stop at its cap, and the round's stages are compared there
BAND_CFG = RunConfig(lp=LPConfig(max_iters=1900, tol=1e-12, use_kernel="on"),
                     cuts=CutConfig(k=5, sel_size=16, capacity=1024))


def test_cut_solver_qcqp_band_round0_matches_reference():
    """Round 0 of the port's CutSolverQCQP on generate_qcqp_band(200, 5, 25,
    1), whose 25 dense rows K2's cluster does not hold at n = 200, through
    the grid route's wrappers against the JAX package's, its LP run by both
    to BAND_CFG's budget: the certified bound at rtol 2e-3, the same cuts
    added.  A round with cuts in the pool takes minutes on one CPU thread
    here (the cut index's padded rows at every band entry); the LP with cuts
    and dense rows is held to the reference block by block
    (test_plain_block_matches_the_reference, n = 200, k = 5, m = 25) and
    check by check (test_checked_block_matches_the_reference_checked_block),
    and on the card chip_smoke.py phase 19 runs the rounds against the CPU
    port."""
    inst = generate_qcqp_band(200, 5, 25, 1)
    assert route_refusal(200, 1024, 5, 25) == ("grid", None)
    ref = JaxCutSolverQCQP(inst, reference_config(_plain(BAND_CFG))).run(rounds=1)
    got = CutSolverQCQP(inst, BAND_CFG, device="cpu").run(rounds=1)
    assert len(got) == len(ref) == 1
    np.testing.assert_allclose(got[0].bound, ref[0].bound, rtol=2e-3)
    assert got[0].lp_iters == ref[0].lp_iters == BAND_CFG.lp.max_iters
    assert got[0].cuts_added == ref[0].cuts_added > 0
