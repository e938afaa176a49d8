"""K6, the power iteration for ||K|| (lp/pdhg_norm.py, csrc/pdhg_norm.cu):
its shared-memory layout summed from the kernel source and held to every
shape the version that kept the iterate in global memory took, and the
start vector a solve's set-up asks for (lp/pdhg.py start_vector: the
seed-0 draw, made once for each (n, device)) against a fresh draw and the
JAX package's estimate_norm.  The kernel itself runs only on the card
(chip_smoke.py holds it to the twin and to the parent build's bits there);
torch runs on one thread here."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpcutsel_tpu.lp import pdhg as jpdhg
from sdpcutsel_tpu.relax import cutbuffer as jcb
from sdpcutsel_tpu.relax import denserows as jdr
from sdpcutsel_tpu_torch.config import LPConfig
from sdpcutsel_tpu_torch.instances import generate_spar, load_or_generate_qcqp
from sdpcutsel_tpu_torch.instances.qcqp import generate_qcqp
from sdpcutsel_tpu_torch.lp import pdhg as tpdhg
from sdpcutsel_tpu_torch.lp import pdhg_kernel as tkernel
from sdpcutsel_tpu_torch.lp import pdhg_norm as tnorm
from sdpcutsel_tpu_torch.relax import batched as rb
from sdpcutsel_tpu_torch.relax import cutbuffer as tcb
from sdpcutsel_tpu_torch.relax import denserows as tdr
from sdpcutsel_tpu_torch.relax.cutbuffer import build_cut_index

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _source_words(n: int, M: int, k: int, m: int, C: int = tkernel.CLUSTER) -> int:
    """The words of csrc/pdhg_norm.cu's make_layout: the sum of its
    TAKE(field, words) lines, ``resident``, ``staged`` and the terms'
    capacity decided as the source does (from what the lines before each
    took)."""
    with open(os.path.join(REPO, "sdpcutsel_tpu_torch", "csrc", "pdhg_norm.cu")) as f:
        text = f.read()
    body = text[text.index(" make_layout("):]
    body = body[:body.index("#undef TAKE")]
    R, Mc, words = -(-n // C), -(-M // C), 232448 // 4
    names = dict(n=n, M=M, k=k, m=m, C=C, R=R, RN=R * n, Mc=Mc, kCols=128, kWarpsPerRow=4,
                 kGroups=4, kThreads=512)
    total = 0
    for line in body.splitlines():
        if "const bool resident" in line:
            names["resident"] = m > 0 and total + m * (R * n + R) <= words
        if "const bool staged" in line:
            names["staged"] = total + Mc * (1 + 2 * k + 2 * k * k) + (R * n + 1) + (R + 1) <= words
        if "L.cap = " in line:
            names["L"] = type("L", (), {"cap": (words - total) // 2 if names["staged"] else 0})
        for expr in re.findall(r"TAKE\(\w+, ([^;]*?)\);", line):
            expr = re.sub(r"^(.*?) \? (.*?) : (.*)$", r"(\2) if (\1) else (\3)", expr)
            total += eval(expr, {}, dict(names))        # noqa: S307 (the repository's own source)
    return total


def _parent_words(n: int, M: int, m: int, C: int = tkernel.CLUSTER) -> int:
    """The layout of the version that kept the iterate in global memory:
    four (R, n) bands, the row and column partials, x, gx, the weights, the
    dense partials and their sums, the norm's sums, block sums."""
    R = -(-n // C)
    return (4 * R * n + 2 * R * 4 + C * 4 * R + 128 + R + M + C * m + m + C * 4 + 32 + 4)


@pytest.mark.parametrize("n,M,k,m", [(125, 1024, 3, 0), (100, 1024, 5, 25), (13, 40, 3, 3),
                                     (30, 1024, 4, 2), (128, 13808, 3, 0), (64, 1024, 2, 200),
                                     (10, 64, 5, 1), (125, 40000, 5, 0)])
def test_norm_layout_matches_the_kernel_source(n, M, k, m):
    """smem_words is csrc/pdhg_norm.cu's make_layout, summed from the source;
    without the dense slice and the staged cut data it is the old layout
    word for word; the slice is resident exactly where its words fit a CTA,
    and the cut data is staged where it fits after it (the terms then take
    the rest)."""
    words, resident, staged = tnorm.smem_words(n, M, k, m)
    assert words == _source_words(n, M, k, m)
    base = _parent_words(n, M, m)
    R, Mc = -(-n // tkernel.CLUSTER), -(-M // tkernel.CLUSTER)
    slice_ = m * (R * n + R) if resident else 0
    assert resident == (m > 0 and 4 * (base + m * (R * n + R)) <= tkernel.SMEM_MAX)
    cut_data = Mc * (1 + 2 * k + 2 * k * k) + (R * n + 1) + (R + 1)
    assert staged == (4 * (base + slice_ + cut_data) <= tkernel.SMEM_MAX)
    if staged:
        assert tkernel.SMEM_MAX - 8 < 4 * words <= tkernel.SMEM_MAX
    else:
        assert words == base + slice_


@pytest.mark.parametrize("n", [2, 13, 30, 64, 100, 125, 128])
@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_norm_takes_every_shape_the_old_kernel_took(n, k):
    """Wherever K2's launch plan takes (n, M, k, m) (the pools and dense
    rows a solve on K2's route can have), K6's layout fits a CTA, as the old
    layout did: the largest pool, the most dense rows, and both together
    where the plan holds them; a pool of the main paths' capacity stages its
    cut data."""
    for M in (40, 1024):
        plan = tkernel.launch_plan(n, M, k, 0)
        for MM, m in ((plan.max_capacity, 0), (M, plan.max_dense), (M, 0), (M, 25)):
            if tkernel.plan_refusal(n, MM, k, m) is not None:
                continue
            words, _, staged = tnorm.smem_words(n, MM, k, m)
            assert 4 * words <= tkernel.SMEM_MAX, (n, MM, k, m)
            # the main paths' pools (capacity 1024) read their cut data on chip
            assert staged or MM > 1024, (n, MM, k, m)
            assert 4 * _parent_words(n, MM, m) <= tkernel.SMEM_MAX


def test_norm_holds_the_registrys_qcqp_rows_resident():
    """Every QCQP shape the main paths solve on K2's route keeps its dense
    slice and its cut data in shared memory: band100 (n = 100, m = 25,
    capacity 1024, k = 5) and the batched family (n = 30, m = 2, k = 4); the
    BoxQP shapes have no slice, and stage their cut data."""
    band = load_or_generate_qcqp("qcqpband100-5-25-1")
    assert tnorm.smem_words(band.n, 1024, 5, band.m)[1:] == (True, True)
    assert tnorm.smem_words(30, 1024, 4, 2)[1:] == (True, True)
    assert tnorm.smem_words(125, 1024, 3, 0)[1:] == (False, True)


def test_start_vector_is_a_fresh_seed0_draw_drawn_once_per_n(monkeypatch):
    """With no generator the start vector equals a fresh seed-0 norm_start
    draw bit for bit; it is drawn once for each (n, device) and then reused
    (the same tensors), and a new n draws anew.  A caller's own generator
    still draws from it, as before."""
    draws = []
    real = tpdhg.norm_start

    def counted(n, generator, device):
        draws.append(n)
        return real(n, generator, device)

    monkeypatch.setattr(tpdhg, "norm_start", counted)
    monkeypatch.setattr(tpdhg, "_START", {})
    fresh = real(17, torch.Generator().manual_seed(0), "cpu")
    a = tpdhg.start_vector(17, None, "cpu")
    assert all(torch.equal(u, v) for u, v in zip(a, fresh))
    b = tpdhg.start_vector(17, None, torch.device("cpu"))
    assert draws == [17] and all(u is v for u, v in zip(a, b))
    c = tpdhg.start_vector(18, None, "cpu")
    assert draws == [17, 18] and c[0].shape == (18,)
    gen = torch.Generator().manual_seed(5)
    own = tpdhg.start_vector(17, gen, "cpu")
    assert draws == [17, 18, 17]
    assert all(torch.equal(u, v) for u, v in zip(own, real(17, torch.Generator().manual_seed(5),
                                                           "cpu")))
    assert not torch.equal(gen.get_state(), torch.Generator().manual_seed(5).get_state())


def _pool(n: int, M: int, k: int, seed: int):
    rng = np.random.default_rng(seed)
    live = M - 5
    idx = rng.integers(0, n, (live, k)).astype(np.int32)
    lin = rng.standard_normal((live, k)).astype(np.float32)
    quad = rng.standard_normal((live, k, k)).astype(np.float32)
    quad = 0.5 * (quad + np.transpose(quad, (0, 2, 1)))
    cuts = (idx, lin, quad, (0.1 * rng.standard_normal(live)).astype(np.float32),
            np.ones(live, np.float32))
    return (jcb.append_cuts(jcb.empty_pool(M, k), *(jnp.asarray(a) for a in cuts)),
            tcb.append_cuts(tcb.empty_pool(M, k, "cpu"), *(torch.as_tensor(a) for a in cuts)))


@pytest.mark.parametrize("kind", ["boxqp", "qcqp"])
def test_setup_norm_keeps_its_bits_and_the_reference(kind):
    """A solve's set-up (generator None: the kept seed-0 start vector) gives
    the bits of the twin from a fresh seed-0 generator, single and batched,
    and stays within the existing 2% of the JAX package's estimate_norm
    (whose start vector is another draw)."""
    if kind == "qcqp":
        inst = generate_qcqp(12, 40, 3, 2)
        n, Q, c = inst.n, inst.Q0, inst.c0
        jd = jdr.dense_from_qcqp(inst.Qs, inst.cs, inst.bs)
        td = tdr.dense_from_qcqp(inst.Qs, inst.cs, inst.bs, "cpu")
    else:
        inst = generate_spar(13, 100, 2)
        n, Q, c = inst.n, inst.Q, inst.c
        jd, td = jdr.empty_dense(n, jnp.float32), None
    jpool, tpool = _pool(n, 30, 3, seed=7)
    index = build_cut_index(tpool, n)
    fresh = tpdhg.estimate_norm_plain(tpool, n, 30, torch.Generator().manual_seed(0), index, td)
    setup = tpdhg.solve_setup(torch.as_tensor(c, dtype=torch.float32), tpool,
                              LPConfig(power_iters=30), td)
    assert setup.route == "plain" and torch.equal(setup.normK, fresh)
    assert torch.equal(tnorm.pdhg_norm(tpool, n, 30, None, index, td), fresh)
    ref = float(jpdhg.estimate_norm(jpool, n, 30, jnp.float32, jd))
    np.testing.assert_allclose(float(fresh), ref, rtol=2e-2)
    one = rb.batch_of_one
    bsetup = tpdhg.solve_setup_batched(torch.as_tensor(c, dtype=torch.float32)[None], one(tpool),
                                       LPConfig(power_iters=30), None if td is None else one(td))
    want = tpdhg.estimate_norm_batched_plain(one(tpool), n, 30, torch.Generator().manual_seed(0),
                                             rb.build_cut_index(one(tpool), n),
                                             None if td is None else one(td))
    assert torch.equal(bsetup.normK, want)
    np.testing.assert_allclose(float(want[0]), float(fresh), rtol=1e-6)
