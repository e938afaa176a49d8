"""The dense route of the PDHG solve (sdpcutsel_tpu_torch/lp/pdhg_dense.py,
csrc/pdhg_dense.cu): the route the certifier's LP takes by shape and
device, the refusals, the shared-memory plan, the norm's launch on the
block's plan (recorded by a stand-in library), the wrappers' device rule
(CPU tensors take the twins, bit for bit; other devices raise), and the
certifier on the CPU under "auto", "off" and "on", bit for bit equal to one
another and to the parent tree's CPU results.  The kernels themselves run
only on the card (chip_smoke.py holds them to the twins there); torch runs
on one thread here (see tests/test_torch_resume.py)."""

import os
import re

import numpy as np
import pytest
import torch

from sdpcutsel_tpu_torch.config import LPConfig
from sdpcutsel_tpu_torch.instances import generate_spar
from sdpcutsel_tpu_torch.instances.qcqp import generate_qcqp
from sdpcutsel_tpu_torch.loop import sdp_bound as tsb
from sdpcutsel_tpu_torch.lp import pdhg as tpdhg
from sdpcutsel_tpu_torch.lp import pdhg_dense as tdense
from sdpcutsel_tpu_torch.lp import pdhg_grid as tgrid
from sdpcutsel_tpu_torch.lp.pdhg_kernel import (SMEM_MAX, kernel_route, pdhg_block_plain,
                                                pdhg_block_steps_plain, route_refusal,
                                                steps_record)
from sdpcutsel_tpu_torch.relax import cutbuffer as tcb
from sdpcutsel_tpu_torch.relax.cutbuffer import build_cut_index
from sdpcutsel_tpu_torch.relax.denserows import DenseRows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CERTIFIER_SHAPES = [(n, m) for n in (10, 125) for m in (1, 368, 2048)]


@pytest.mark.parametrize("n,m", CERTIFIER_SHAPES)
def test_dense_route_for_the_certifier_on_cuda(n, m):
    """The certifier's pool (capacity 1, width 1) takes the dense route on
    CUDA under "auto" and "on", whatever m; "off" is the plain loop, and
    "auto" on the CPU too."""
    cuda = torch.device("cuda")
    assert route_refusal(n, 1, 1, m) == ("dense", None)
    assert kernel_route("auto", cuda, n, 1, 1, m) == "dense"
    assert kernel_route("on", cuda, n, 1, 1, m) == "dense"
    assert kernel_route("on", torch.device("cpu"), n, 1, 1, m) == "dense"
    assert kernel_route("off", cuda, n, 1, 1, m) == "plain"
    assert kernel_route("auto", torch.device("cpu"), n, 1, 1, m) == "plain"


@pytest.mark.parametrize("n", [0, 46341, 50000])
def test_dense_route_refuses_n_outside_the_kernels(n):
    """n > 46,340 (or 0): "auto" on CUDA raises with the reason and names
    "off"; "on" raises on every device; "off" and "auto" on the CPU run
    plain.  n = 1025, 1100, 2049 and 2100 are the dense route's now."""
    for taken in (1025, 1100, 2049, 2100):
        assert route_refusal(taken, 1, 1, 368) == ("dense", None)
    route, why = route_refusal(n, 1, 1, 368)
    assert route == "dense" and "n <= 46340" in why
    with pytest.raises(ValueError, match=re.escape(why)):
        kernel_route("auto", torch.device("cuda"), n, 1, 1, 368)
    with pytest.raises(ValueError, match="use_kernel='off'"):
        kernel_route("auto", torch.device("cuda"), n, 1, 1, 368)
    for device in ("cuda", "cpu"):
        with pytest.raises(ValueError, match="n <= 46340"):
            kernel_route("on", torch.device(device), n, 1, 1, 368)
    assert kernel_route("off", torch.device("cuda"), n, 1, 1, 368) == "plain"
    assert kernel_route("auto", torch.device("cpu"), n, 1, 1, 368) == "plain"


def test_dense_refusal_reasons():
    """A pool of cuts is K2's (the dense route names its pool); more rows
    than shared memory holds is refused with the limit; pools of cuts keep
    K2's rule."""
    assert "capacity 1, width 1" in tdense.dense_refusal(125, 1024, 3, 0)
    top = tdense.max_dense_rows(125)
    assert top >= 4 * 2048
    assert tdense.dense_refusal(125, 1, 1, top) is None
    why = tdense.dense_refusal(125, 1, 1, top + 1)
    assert "shared memory" in why and str(top) in why
    # past K7's rows the route takes the grid route's far form without cuts
    assert tdense.k7_takes(125, top) and not tdense.k7_takes(125, top + 1)
    assert route_refusal(125, 1, 1, top + 1) == ("dense", None)
    assert tdense.smem_words(125, top + 1) == tgrid.block_words(125, 1, top + 1, False, True)
    assert route_refusal(125, 1024, 3, 0) == ("k2", None)
    assert route_refusal(100, 1024, 5, 25) == ("k2", None)


@pytest.mark.parametrize("n", [10, 125, 128])
def test_dense_shared_memory_grows_with_m_not_m_n(n):
    """The kernels' shared memory (the block's layout, which the norm takes)
    fits the card at the full buffer, and adding 16 rows adds the same few
    words at every n: at 2048 rows every n streams G from global memory or
    holds its slice of G resident, the slab giving way to the rows' duals."""
    assert tdense.smem_bytes(n, 2048) <= SMEM_MAX
    step = tdense.smem_words(n, 2048 + 16) - tdense.smem_words(n, 2048)
    assert step == tdense.smem_words(10, 2048 + 16) - tdense.smem_words(10, 2048)
    assert step <= 4 * 16 + 2 * 2


def _certifier_lp(n=12, m=40, seed=0):
    """The certifier's LP at (n, m): an instance, the pool without cuts, m
    normalised rank-1 rows (the seed rows' form) and a random state."""
    inst = generate_spar(n, 100, 3)
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((m, n + 1))
    dense = DenseRows(*(torch.as_tensor(a, dtype=torch.float32)
                        for a in tsb._seed_rows(V / np.linalg.norm(V, axis=1, keepdims=True))))
    pool = tcb.empty_pool(1, 1, "cpu")
    st = tpdhg.init_state(n, 1, "cpu", m)
    st.x = torch.as_tensor(rng.random(n), dtype=torch.float32)
    X = rng.random((n, n))
    st.X = torch.as_tensor(0.5 * (X + X.T), dtype=torch.float32)
    st.yA = torch.as_tensor(0.1 * rng.random((n, n)), dtype=torch.float32)
    st.yD = torch.as_tensor(0.2 * rng.random(m), dtype=torch.float32)
    cx = torch.as_tensor(-inst.c, dtype=torch.float32)
    cX = torch.as_tensor(-0.5 * inst.Q, dtype=torch.float32)
    return cx, cX, pool, build_cut_index(pool, n), dense, st


def _same(a, b):
    return all(torch.equal(u, v) for u, v in zip(a.fields(), b.fields()))


def test_dense_wrappers_take_the_twins_on_the_cpu():
    """On CPU tensors every dense-route wrapper is its twin, bit for bit, and
    launches nothing."""
    cx, cX, pool, index, dense, st = _certifier_lp()
    n = cx.shape[0]
    before = {fn: fn.launches for fn in (tdense.pdhg_dense_block,
                                         tdense.pdhg_dense_block_checked, tdense.pdhg_dense_norm)}
    acc = st.map(torch.zeros_like)
    got = tdense.pdhg_dense_block(cx, cX, pool, index, st, acc, 0.05, 0.07, 9, dense)
    want = pdhg_block_plain(cx, cX, pool, index, st, acc, 0.05, 0.07, 9, dense)
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    rec = steps_record([0.05], [0.07], "cpu")[0]
    mine, theirs = [st.map(torch.clone), acc.map(torch.clone)], [st.map(torch.clone),
                                                                  acc.map(torch.clone)]
    tdense.pdhg_dense_block_steps(cx, cX, pool, index, *mine, rec.clone(), 9, dense)
    pdhg_block_steps_plain(cx, cX, pool, index, *theirs, rec.clone(), 9, dense)
    assert _same(mine[0], theirs[0]) and _same(mine[1], theirs[1])
    normK = tpdhg.estimate_norm_plain(pool, n, 30, torch.Generator().manual_seed(0), index, dense)
    norm = tdense.pdhg_dense_norm(pool, n, 30, torch.Generator().manual_seed(0), index, dense)
    assert torch.equal(norm, normK)
    for rp in (10 ** 6, 100):
        runs = []
        for checked in (True, False):
            bufs = [got[0].map(torch.clone), got[1].map(torch.clone), st.map(torch.clone),
                    tpdhg.new_record(normK, 1.0, 0.95, 20000, 2e-6, "cpu")]
            if checked:
                tdense.pdhg_dense_block_checked(cx, cX, pool, index, *bufs, 9, rp, 20000, 2e-6,
                                                dense)
            else:
                pdhg_block_steps_plain(cx, cX, pool, index, bufs[0], bufs[1], bufs[3], 9, dense)
                tpdhg.pdhg_check_plain(cx, cX, pool, index, *bufs, 9, rp, 20000, 2e-6, dense)
            runs.append(bufs)
        assert all(_same(a, b) for a, b in zip(runs[0][:3], runs[1][:3]))
        assert torch.equal(runs[0][3], runs[1][3])
    assert all(fn.launches == k for fn, k in before.items())


def test_dense_wrappers_refuse_other_devices():
    cx, cX, pool, index, dense, st = _certifier_lp(n=6, m=4)
    meta = lambda t: t.to("meta")      # noqa: E731
    mst = st.map(meta)
    mdense = DenseRows(*(meta(t) for t in (dense.G, dense.g, dense.h)))
    mpool = tcb.CutPool(*(meta(t) for t in (pool.idx, pool.lin, pool.quad, pool.rhs,
                                            pool.active, pool.count)))
    rec = torch.zeros(tpdhg.REC_WORDS, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tdense.pdhg_dense_block(meta(cx), meta(cX), mpool, index, mst, mst, 0.1, 0.1, 3, mdense)
    with pytest.raises(ValueError, match="no kernel"):
        tdense.pdhg_dense_block_steps(meta(cx), meta(cX), mpool, index, mst, mst, rec, 3, mdense)
    with pytest.raises(ValueError, match="no kernel"):
        tdense.pdhg_dense_block_checked(meta(cx), meta(cX), mpool, index, mst, mst, mst, rec,
                                        100, 300, 1000, 1e-6, mdense)
    with pytest.raises(ValueError, match="no kernel"):
        tdense.pdhg_dense_norm(mpool, 6, 30, torch.Generator().manual_seed(0), index, mdense)


def test_dense_launch_checks_refuse_bad_arguments():
    """What a launch checks before it reaches the library: shapes, the
    dense rows' layout and the pool."""
    cx, cX, pool, index, dense, st = _certifier_lp(n=8, m=5)
    assert tdense._checked(cx, cX, pool, (st,), dense, "t")[:2] == (8, 5)
    with pytest.raises(ValueError, match="state.yD"):
        tdense._checked(cx, cX, pool, (st,), DenseRows(dense.G[:4], dense.g[:4], dense.h[:4]), "t")
    with pytest.raises(ValueError, match="dense.G"):
        tdense._checked(cx, cX, pool, (st,), DenseRows(dense.G[:, :7], dense.g, dense.h), "t")
    with pytest.raises(ValueError, match="contiguous"):
        tdense._checked(cx, cX, pool, (st,), DenseRows(dense.G.transpose(1, 2), dense.g,
                                                       dense.h), "t")
    with pytest.raises(ValueError, match="capacity 1, width 1"):
        tdense._checked(cx, cX, tcb.empty_pool(4, 3, "cpu"), (st,), dense, "t")
    with pytest.raises(ValueError, match="state.X"):
        tdense._checked(cx, cX, pool, (st.map(lambda t: t),
                                       tpdhg.PDHGState(st.x, st.X[:, :7], st.yA, st.yB, st.yC,
                                                       st.yD)), dense, "t")


def test_batched_setup_refuses_the_dense_route():
    pools = tcb.empty_pool(1, 1, "cpu")
    batch = tcb.CutPool(*(t[None] for t in (pools.idx, pools.lin, pools.quad, pools.rhs,
                                            pools.active, pools.count)))
    with pytest.raises(ValueError, match="one instance"):
        tpdhg.solve_setup_batched(torch.zeros((1, 12)), batch, LPConfig(use_kernel="on"))


# The parent tree's CPU results (sdp_relaxation_bound before the dense route:
# the certifier then forced the plain loop), taken with torch on one thread:
# (best, first bound, [(bound, LP iterations, rows) a round]).  They are held
# at rtol PARENT_RTOL, iterations and rows exactly, so that a numpy, BLAS or
# torch update that moves an ulp does not fail the test; the three routes of
# this tree are held to each other bit for bit.
PARENT_CPU = {
    "boxqp": (135.30336420471443, 275.02823994847455,
              [(275.02823994847455, 600, 6), (161.17678304247426, 600, 10),
               (147.20137236118654, 600, 16), (143.37888339378162, 600, 14),
               (139.1675997609895, 600, 13), (135.30336420471443, 600, 12),
               (137.28914062207286, 2400, 12)]),
    "qcqp": (255.24450455576263, 266.6834860656916,
             [(266.6834860656916, 600, 6), (258.7655694648445, 600, 10),
              (255.24450455576263, 600, 14)]),
}


PARENT_RTOL = 1e-12


def _close_to_parent(run, want) -> bool:
    (best, b0, rounds), (wbest, wb0, wrounds) = run, want
    return (len(rounds) == len(wrounds)
            and all(r[1:] == w[1:] for r, w in zip(rounds, wrounds))
            and np.allclose([best, b0, *(r[0] for r in rounds)],
                            [wbest, wb0, *(w[0] for w in wrounds)], rtol=PARENT_RTOL, atol=0.0))


def _certify(kind: str, use_kernel: str):
    lp = LPConfig(max_iters=600, tol=2e-6, use_kernel=use_kernel)
    if kind == "boxqp":
        out = tsb.sdp_relaxation_bound(generate_spar(12, 100, 3), lp, max_rounds=6, capacity=64,
                                       device="cpu", purge_at=12, final_polish=True)
    else:
        out = tsb.sdp_relaxation_bound(generate_qcqp(10, 40, 2, 1), lp, max_rounds=3,
                                       capacity=64, device="cpu")
    best, b0, hist = out
    return best, b0, [(h["bound"], h["lp_iters"], h["cuts"]) for h in hist]


@pytest.mark.parametrize("kind", ["boxqp", "qcqp"])
def test_certifier_on_the_cpu_auto_off_on_equal_and_parents(kind, monkeypatch):
    """The certifier on the CPU: "auto" (the plain loop), "off" and "on"
    (the dense route's wrappers, whose twins run on the CPU) give the same
    bits, and the parent tree's results within PARENT_RTOL; "on" goes through
    the dense wrappers, and every solve of the run takes the route its
    use_kernel names."""
    calls = []
    real = tdense.dense_checked_step

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tdense, "dense_checked_step", counted)
    runs = {uk: _certify(kind, uk) for uk in ("auto", "off")}
    assert not calls
    runs["on"] = _certify(kind, "on")
    assert calls
    assert runs["auto"] == runs["off"] == runs["on"]
    assert _close_to_parent(runs["auto"], PARENT_CPU[kind])


# The block's launch plan by shape (lp/pdhg_dense.py::block_plan): the
# sandwiches of the certifier's phase 15 (n = 10 and 12, up to a few hundred
# rows) in one CTA, the full-width certifier (n = 125) over every SM.
SANDWICH_SHAPES = [(10, 40), (10, 90), (10, 368), (12, 70), (12, 90), (12, 200)]
GRID_SHAPES = [(125, 368), (125, 2048), (64, 2048), (10, 2048), (12, 368), (33, 10)]


@pytest.mark.parametrize("n,m", SANDWICH_SHAPES)
def test_block_plan_takes_one_cta_at_the_sandwiches(n, m):
    """The sandwiches' shapes fit one CTA: G and g of every row in its
    shared memory, so its iterations pay block barriers only."""
    assert tdense.block_plan(n, m) == "cta"
    words = tdense.smem_words(n, m)
    assert words == tdense._block_words("cta", n, m)
    assert 4 * words <= SMEM_MAX
    assert words >= m * (n * n + n)


@pytest.mark.parametrize("n,m", GRID_SHAPES)
def test_block_plan_takes_the_grid_elsewhere(n, m):
    """n = 125 at 368 and 2048 rows (and any shape one CTA does not hold,
    or n > CTA_MAX_N) run over the whole card: the grid plan takes a CTA's
    whole shared memory, whatever m (its slab of G gives way to yD)."""
    assert tdense.block_plan(n, m) == "grid"
    assert tdense.smem_words(n, m) == tdense._block_words("grid", n, m)
    assert SMEM_MAX - 16 < 4 * tdense._block_words("grid", n, m) <= SMEM_MAX
    assert tdense._block_words("grid", n, m + 16) == tdense._block_words("grid", n, m)


def _parent_max_dense_rows(n: int) -> int:
    """The largest m the earlier dense routes took at n: the block's layout
    (which this tree keeps for the block, its checked form and the norm),
    the earlier standalone check's (one cluster of C = 16 on K2's bands,
    whose layout held 2 m + 2 C ceil(m / C) words of rows' duals and
    partials) and the earlier cluster norm's (the same bands, m + C
    ceil(m / C) words of rows), its formula frozen here with its constants:
    kWarpsPerRow W = 4, kGroups G = 4, kCols 128, kThreads 512."""
    C, W, G = 16, 4, 4

    def fits(m):
        R, mc = -(-n // C), -(-m // C)
        RN, rows = R * n, 2 * R * W + C * G * R
        check = (2 * 128 + 2 * m + 8 * RN + 2 * R + 2 * rows + 2 * C * mc + C * 2 * 8 + C * 6
                 + 2 * 512 + (2 * 8 + 6 + 8))
        norm = 6 * RN + rows + 128 + 2 * R + C * mc + m + C * 4 + 512 + 4
        return (4 * tdense.smem_words(n, m) <= SMEM_MAX and 4 * check <= SMEM_MAX
                and 4 * norm <= SMEM_MAX)

    lo, hi = 0, 1 << 20
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo


def test_max_dense_rows_not_below_the_parents():
    """At every n <= 128 the route takes at least the rows the parent's did,
    and the grid plan's shared memory holds them."""
    for n in range(1, 129):
        top = tdense.max_dense_rows(n)
        assert top >= _parent_max_dense_rows(n), n
        assert 4 * tdense._block_words("grid", n, top) <= SMEM_MAX


def test_block_plan_refusals():
    """An unknown plan, and the "cta" plan asked for where one CTA does not
    hold the problem, are refused before any launch."""
    with pytest.raises(ValueError, match="unknown block plan"):
        tdense._block_words("cluster", 10, 5)
    cx, cX, pool, index, dense, st = _certifier_lp(n=12, m=400)
    rec = steps_record([0.1], [0.1], "cpu")[0]
    assert tdense.block_plan(12, 400) == "grid"
    with pytest.raises(ValueError, match="'cta' plan does not take n=12, m=400"):
        tdense._launch_block(cx, cX, pool, [st, st], [st, st], rec, 3, dense, plan="cta")
    cx, cX, pool, index, dense, st = _certifier_lp(n=40, m=2)
    with pytest.raises(ValueError, match="'cta' plan does not take n=40, m=2"):
        tdense._launch_block(cx, cX, pool, [st, st], [st, st], rec, 3, dense, plan="cta")


def _layout_words(path: str, fn: str, **names) -> int:
    """The words of a layout function of a kernel source: the sum of its
    TAKE(field, words) lines, the words evaluated with ``names``."""
    with open(os.path.join(REPO, "sdpcutsel_tpu_torch", "csrc", path)) as f:
        text = f.read()
    body = text[text.index(f" {fn}("):]
    body = body[:body.index("#undef TAKE")]
    total = 0
    for expr in re.findall(r"TAKE\(\w+, ([^;]*?)\);", body):
        expr = re.sub(r"^(.*?) \? (.*?) : (.*)$", r"(\2) if (\1) else (\3)", expr)
        total += eval(expr, {}, dict(names))          # noqa: S307 (the repository's own source)
    return total


@pytest.mark.parametrize("n,m", [(10, 368), (12, 90), (125, 2048), (64, 7)])
def test_block_layouts_match_the_kernel_source(n, m):
    """smem words of both plans are csrc/pdhg_dense.cu's cta_layout and
    grid_layout summed from the source."""
    consts = dict(n=n, m=m, NN=n * n, V=n * n + n, V4=(n * n + n + 3) & ~3, kStages=tdense._STAGES,
                  kStage=tdense._STAGE, kMaxE=tdense._MAX_E, kThreads=tdense._THREADS,
                  kScratch=tdense._SCRATCH,
                  free4=(tdense._SMEM_WORDS - (tdense._SCRATCH + m + tdense._MAX_E)) & ~3)
    assert tdense._block_words("cta", n, m) == _layout_words("pdhg_dense.cu", "cta_layout",
                                                             **consts)
    assert tdense._block_words("grid", n, m) == _layout_words("pdhg_dense.cu", "grid_layout",
                                                              **consts)


# ---- the checked block on the dense route: K7's launch with the check (K7c)
# as its epilogue, the solve's step (lp/pdhg_dense.py dense_checked_step)

def _window(st, scale: float = 37.0):
    """Sums of a window of iterates: the state scaled (every field positive
    where the state's is)."""
    return st.map(lambda t: t * scale)


@pytest.mark.parametrize("restart_period", [10 ** 6, 100])
@pytest.mark.parametrize("n,m", [(10, 5), (10, 40), (12, 90), (12, 200)])
def test_dense_checked_block_on_the_cpu_is_the_block_then_the_check(n, m, restart_period):
    """On the CPU the dense route's checked block is the block's twin
    (pdhg_block_steps_plain) followed by the check's (pdhg_check_plain), bit
    for bit: state, sums, anchor and record, over two steps of one
    marshalled step function; nothing is launched."""
    cx, cX, pool, index, dense, st = _certifier_lp(n=n, m=m, seed=3)
    normK = tpdhg.estimate_norm_plain(pool, n, 30, None, index, dense)
    rec = tpdhg.new_record(normK, 1.0, 0.95, 10 ** 6, 1e-9, "cpu")
    rec[tpdhg.REC_WLEN] = 63                 # the window reaches 100 at the first check
    before = (tdense.pdhg_dense_block.launches, tdense.pdhg_dense_block_checked.launches)

    def bufs():
        return [st.map(torch.clone), _window(st), st.map(lambda t: t * 0.5), rec.clone()]

    mine, theirs = bufs(), bufs()
    step = tdense.dense_checked_step(cx, cX, pool, index, *mine, 37, restart_period, 10 ** 6,
                                     1e-9, dense)
    for _ in range(2):
        step()
        pdhg_block_steps_plain(cx, cX, pool, index, theirs[0], theirs[1], theirs[3], 37, dense)
        tpdhg.pdhg_check_plain(cx, cX, pool, index, *theirs, 37, restart_period, 10 ** 6, 1e-9,
                               dense)
        assert all(_same(a, b) for a, b in zip(mine[:3], theirs[:3]))
        assert torch.equal(mine[3], theirs[3])
    assert int(mine[3][tpdhg.REC_IT]) == 74
    assert (tdense.pdhg_dense_block.launches,
            tdense.pdhg_dense_block_checked.launches) == before


def _reference_lp(n: int, m: int, seed: int):
    """_certifier_lp in both packages: the JAX package's pool of capacity 1
    and width 1 (its certifier's), the same dense rows and state."""
    from sdpcutsel_tpu.lp import pdhg as jpdhg
    from sdpcutsel_tpu.relax import cutbuffer as jcb
    from sdpcutsel_tpu.relax import denserows as jdr
    import jax.numpy as jnp

    cx, cX, pool, index, dense, st = _certifier_lp(n=n, m=m, seed=seed)
    jd = jdr.DenseRows(*(jnp.asarray(t.numpy()) for t in (dense.G, dense.g, dense.h)))
    jst = jpdhg.PDHGState(**{f: jnp.asarray(getattr(st, f).numpy())
                             for f in ("x", "X", "yA", "yB", "yC", "yD")})
    return (jnp.asarray(cx.numpy()), jnp.asarray(cX.numpy()), jcb.empty_pool(1, 1), jd, jst), \
        (cx, cX, pool, index, dense, st)


@pytest.mark.parametrize("n,m", [(10, 40), (12, 90)])
def test_dense_checked_block_matches_reference_checked_block(n, m):
    """One checked block on the dense route through the wrapper on the CPU
    against the JAX package's ``checked_block`` with dense rows (its
    ``_solve_impl`` run for one block of the certifier's LP) from the same
    state at the same normK, restart_period 100 (the block restarts): the
    states at rtol/atol 2e-5, omega at rtol 1e-4, the iteration count equal
    (the tolerances of the K5 test in tests/test_torch_pdhg_check.py)."""
    from sdpcutsel_tpu.lp import pdhg as jpdhg
    import jax.numpy as jnp

    (jcx, jcX, jpool, jd, jst), (cx, cX, pool, index, dense, tst) = _reference_lp(n, m, seed=4)
    normK = float(jpdhg.estimate_norm(jpool, n, 30, jnp.float32, jd))
    st_j, info_j = jpdhg._solve_impl(jcx, jcX, jpool, jd, jst, normK, 1.0, 1e-12, 1e-6, 0.95,
                                     100, 100, 100)
    st, anc, acc = tpdhg._buffers(tst)
    rec = tpdhg.new_record(normK, 1.0, 0.95, 100, 1e-12, "cpu")
    tdense.pdhg_dense_block_checked(cx, cX, pool, index, st, acc, anc, rec, 100, 100, 100, 1e-12,
                                    dense)
    f = tpdhg.record_floats(rec.numpy())
    assert int(rec[tpdhg.REC_IT]) == int(info_j["iters"]) == 100
    assert int(rec[tpdhg.REC_STOP]) == 1
    np.testing.assert_allclose(f[tpdhg.REC_OMEGA], float(info_j["omega"]), rtol=1e-4)
    for name in ("x", "X", "yA", "yB", "yC", "yD"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(st_j, name)),
                                   rtol=2e-5, atol=2e-5)


def test_dense_solves_step_through_the_checked_form_and_steering_does_not(monkeypatch):
    """On the dense route every solve builds its step with
    ``dense_checked_step`` once and runs it once a block; steering's block
    is the unchecked ``pdhg_dense_block`` and never the checked form."""
    cx, cX, pool, index, dense, st = _certifier_lp(n=10, m=30, seed=5)
    normK = tpdhg.estimate_norm_plain(pool, 10, 30, None, index, dense)
    made, ran = [], []
    real = tdense.dense_checked_step

    def counted(*args, **kw):
        step = real(*args, **kw)
        made.append(1)

        def run():
            ran.append(1)
            step()
        return run

    monkeypatch.setattr(tdense, "dense_checked_step", counted)
    _, info = tpdhg._solve_impl(cx, cX, pool, index, st, normK, 1.0, 1e-12, 0.95, 500, 100, 300,
                                dense, route="dense")
    assert made == [1] and len(ran) == info["iters"] // 100 == 5
    tpdhg._solve_impl(cx, cX, pool, index, st, normK, 1.0, 1e-12, 0.95, 500, 100, 300, dense,
                      route="plain")
    assert made == [1] and len(ran) == 5

    blocks = []
    real_block = tdense.pdhg_dense_block

    def block(*args, **kw):
        blocks.append(args[8])                 # iters
        return real_block(*args, **kw)

    def refuse(*args, **kw):
        raise AssertionError("steering took the checked form")

    monkeypatch.setattr(tdense, "pdhg_dense_block", block)
    monkeypatch.setattr(tdense, "dense_checked_step", refuse)
    setup = tpdhg.SolveSetup("dense", index, normK)
    sx, SX = tpdhg.rademacher_signs(10, torch.Generator().manual_seed(1), "cpu")
    tpdhg._steer_impl(cx, cX, pool, dense, st, setup, 1.0, 0.95, 1e-3, sx, SX, 40)
    assert blocks == [40]


@pytest.mark.parametrize("checked", [False, True])
@pytest.mark.parametrize("n,m,P", [(125, 2048, 132), (10, 368, 132), (64, 7, 66)])
def test_grid_work_matches_the_kernel_source(n, m, P, checked):
    """The grid plan's global scratch (_work_words) is csrc/pdhg_dense.cu's
    work_words, evaluated from the source; the checked form adds M at the
    average, its rows' partials and each CTA's sums and distances."""
    with open(os.path.join(REPO, "sdpcutsel_tpu_torch", "csrc", "pdhg_dense.cu")) as f:
        text = f.read()
    body = text[text.index(" work_words("):]
    expr = re.search(r"return (.*?);", body, re.S).group(1)
    expr = re.sub(r"static_cast<size_t>\((\w+)\)", r"\1", " ".join(expr.split()))
    expr = re.sub(r"\(checked \? (.*?) : 0\)", r"((\1) if checked else 0)", expr)
    names = dict(n=n, m=m, P=P, NN=n * n, Pm=P * m, checked=checked, kNV=8, kND=6)
    assert tdense._work_words(n, m, P, checked) == eval(expr, {}, names)   # noqa: S307
    assert (tdense._work_words(n, m, P, True) - tdense._work_words(n, m, P, False)
            == n * n + P * m + P * (2 * 8 + 6))


# ---- the norm (K7n) on the block's launch plans: its plumbing on the CPU,
# the launches recorded by a stand-in for the kernel library

class _RecordingLib:
    """The dense route's C entries without a card: the grid plan's CTAs are
    ``P``, every launch's arguments are recorded and it returns 0."""

    def __init__(self, P: int = 132):
        self.P, self.calls = P, []

    def pdhg_dense_block_grid(self, n, m, smem, grid):
        grid._obj.value = self.P
        return 0

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


NORM_SHAPES = [*SANDWICH_SHAPES, (125, 368), (64, 200), (10, 2048), (12, 368), (33, 10), (1, 5)]


@pytest.mark.parametrize("n,m", NORM_SHAPES)
def test_norm_takes_the_blocks_launch_plan(n, m, monkeypatch):
    """The norm launches on the plan and the shared memory that the block
    launches on at the same (n, m), reads the kept start vector in place
    (no copy), and takes the grid plan's scratch of norm_work_words floats;
    its C entry checks them against the block's layout (check_block)."""
    lib = _RecordingLib()
    monkeypatch.setattr(tdense._build, "lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: type("S", (), {"cuda_stream": 0})())
    sizes = []
    real_words = tdense._norm_work_words

    def words(*args):
        sizes.append(args)
        return real_words(*args)

    monkeypatch.setattr(tdense, "_norm_work_words", words)
    cx, cX, pool, index, dense, st = _certifier_lp(n=n, m=m)
    before = tdense.pdhg_dense_norm.launches
    tdense._launch_norm(pool, n, 30, None, dense)
    rec = steps_record([0.1], [0.1], "cpu")[0]
    tdense._launch_block(cx, cX, pool, [st, st], [st, st], rec, 3, dense)
    (norm_name, norm_args), (block_name, block_args) = lib.calls
    assert (norm_name, block_name) == ("pdhg_dense_norm_launch", "pdhg_dense_block_launch")
    plan = tdense.block_plan(n, m)
    assert norm_args[:5] == (n, m, 30, tdense.PLANS.index(plan),
                             4 * tdense._block_words(plan, n, m))
    assert norm_args[3:5] == block_args[3:5]
    y, Y = tpdhg.start_vector(n, None, "cpu")
    assert norm_args[7:9] == (y.data_ptr(), Y.data_ptr())
    assert (norm_args[9] is None) == (plan == "cta") == (sizes == [])
    if plan == "grid":
        assert sizes == [(n, m, lib.P)]
    assert tdense.pdhg_dense_norm.launches == before + 1
    with open(os.path.join(REPO, "sdpcutsel_tpu_torch", "csrc", "pdhg_dense.cu")) as f:
        text = f.read()
    entry = text[text.index('extern "C" int pdhg_dense_norm_launch('):]
    assert "check_block(n, m, iters, plan, smem)" in entry[:entry.index("\n}")]


@pytest.mark.parametrize("n,m,P", [(125, 2048, 132), (125, 368, 132), (64, 7, 66), (1, 5, 132)])
def test_norm_work_matches_the_kernel_source(n, m, P):
    """The norm's grid scratch (_norm_work_words) is csrc/pdhg_dense.cu's
    norm_work_words, evaluated from the source: the iterate, gX, the rows'
    partials, kD and each CTA's four sums, then the barrier's counter."""
    with open(os.path.join(REPO, "sdpcutsel_tpu_torch", "csrc", "pdhg_dense.cu")) as f:
        text = f.read()
    body = text[text.index(" norm_work_words("):]
    expr = re.search(r"return (.*?);", body, re.S).group(1)
    expr = re.sub(r"static_cast<size_t>\((\w+)\)", r"\1", " ".join(expr.split()))
    names = dict(n=n, m=m, P=P, NN=n * n, Pm=P * m)
    assert tdense._norm_work_words(n, m, P) == eval(expr, {}, names)   # noqa: S307
    assert tdense._norm_work_words(n, m, P) == 2 * n * n + n + P * m + m + 4 * P + 1


@pytest.mark.parametrize("n", [10, 64])
def test_dense_norm_on_the_cpu_is_the_twin_and_near_the_reference(n):
    """On the CPU the dense route's norm is estimate_norm_plain bit for bit,
    from a seeded generator and from the kept start vector, and stays within
    the existing 2% of the JAX package's estimate_norm with dense rows, whose
    start vector is another draw (tests/test_torch_pdhg_norm.py's
    tolerance)."""
    from sdpcutsel_tpu.lp import pdhg as jpdhg
    import jax.numpy as jnp

    (_, _, jpool, jd, _), (_, _, pool, index, dense, _) = _reference_lp(n, 40, seed=6)
    before = tdense.pdhg_dense_norm.launches
    for gen in (lambda: torch.Generator().manual_seed(0), lambda: None):
        got = tdense.pdhg_dense_norm(pool, n, 30, gen(), index, dense)
        assert torch.equal(got, tpdhg.estimate_norm_plain(pool, n, 30, gen(), index, dense))
    assert tdense.pdhg_dense_norm.launches == before
    ref = float(jpdhg.estimate_norm(jpool, n, 30, jnp.float32, jd))
    np.testing.assert_allclose(float(got), ref, rtol=2e-2)
