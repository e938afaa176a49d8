"""Port parity: sdpcutsel_tpu_torch.lp (PDHG block twin, solve, norm
estimate, f64 certificate) against sdpcutsel_tpu.lp on the same numpy
inputs, plus the CPU check of the cut index the CUDA kernel reads."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpcutsel_tpu.lp import pdhg as jpdhg
from sdpcutsel_tpu.relax import cutbuffer as jcb
from sdpcutsel_tpu.relax.denserows import empty_dense
from sdpcutsel_tpu_torch.config import LPConfig
from sdpcutsel_tpu_torch.instances import generate_spar
from sdpcutsel_tpu_torch.lp import pdhg as tpdhg
from sdpcutsel_tpu_torch.lp.pdhg_kernel import (SMEM_MAX, kernel_route, launch_plan,
                                                pdhg_block, plan_refusal)
from sdpcutsel_tpu_torch.relax import cutbuffer as tcb
from sdpcutsel_tpu_torch.relax.cutbuffer import build_cut_index


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's CPU threads share this process; torch's intra-op pool on top of
    them oversubscribes the cores (10x slower on these small tensors)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(n=21, M=64, k=3, seed=0):
    """tests/test_pdhg_kernel.py's setup, built in both packages."""
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n)).astype(np.float32)
    Q = 0.5 * (Q + Q.T)
    c = rng.standard_normal(n).astype(np.float32)
    m = M - 8  # leave some inactive rows
    lin = rng.standard_normal((m, k)).astype(np.float32)
    quad = rng.standard_normal((m, k, k)).astype(np.float32)
    quad = 0.5 * (quad + np.transpose(quad, (0, 2, 1)))
    idx = rng.integers(0, n, (m, k)).astype(np.int32)
    rhs = rng.standard_normal(m).astype(np.float32) * 0.1
    x = rng.random(n).astype(np.float32)
    yA = 0.1 * rng.random((n, n)).astype(np.float32)
    yC = 0.05 * rng.random(M).astype(np.float32)
    cuts = (idx, lin, quad, rhs, np.ones(m, np.float32))

    jpool = jcb.append_cuts(jcb.empty_pool(M, k), *(jnp.asarray(a) for a in cuts))
    jst = jpdhg.init_state(n, M, 0)._replace(
        x=jnp.asarray(x), yA=jnp.asarray(yA), yC=jnp.asarray(yC))
    tpool = tcb.append_cuts(tcb.empty_pool(M, k, "cpu"),
                            *(torch.as_tensor(a) for a in cuts))
    tst = tpdhg.init_state(n, M, "cpu")
    tst.x, tst.yA, tst.yC = (torch.as_tensor(a) for a in (x, yA, yC))
    return (jnp.asarray(-c), jnp.asarray(-0.5 * Q), jpool, jst,
            torch.as_tensor(-c), torch.as_tensor(-0.5 * Q), tpool, tst)


def _jstate_np(st):
    return [np.asarray(a) for a in (st.x, st.X, st.yA, st.yB, st.yC)]


def test_pdhg_block_twin_matches_one_iter_loop():
    n, M, iters = 21, 64, 7
    jcx, jcX, jpool, jst, tcx, tcX, tpool, tst = _setup(n, M)
    tau, sigma = 0.013, 0.07
    dense = empty_dense(n, jnp.float32)
    ref, acc = jst, jax.tree.map(jnp.zeros_like, jst)
    for _ in range(iters):
        ref = jpdhg._one_iter(jcx, jcX, jpool, dense, n, ref, tau, sigma)
        acc = jax.tree.map(lambda a, b: a + b, acc, ref)

    st, sacc = pdhg_block(tcx, tcX, tpool, build_cut_index(tpool, n), tst,
                          tst.map(torch.zeros_like), tau, sigma, iters)
    tol = dict(rtol=2e-5, atol=2e-5)
    for got, want in zip(st.fields(), _jstate_np(ref)):
        np.testing.assert_allclose(got.numpy(), want, **tol)
    for got, want in zip(sacc.fields(), _jstate_np(acc)):
        np.testing.assert_allclose(got.numpy(), want, **tol)


def test_cut_index_sums_to_cut_adjoint():
    """The kernel sums each x / X entry's segment of the inverse index in
    order; those segment sums must equal cut_adjoint."""
    n, M = 21, 64
    *_, tpool, _ = _setup(n, M, seed=5)
    tpool.active[::7] = 0.0                     # some inactive rows
    yC = torch.rand(M, generator=torch.Generator().manual_seed(0))
    ix = build_cut_index(tpool, n)
    w = yC * tpool.active

    def seg_sums(off, cut, coef, size):
        out = torch.zeros(size)
        for d in range(size):
            for q in range(int(off[d]), int(off[d + 1])):
                out[d] += w[cut[q]] * coef[q]
        return out

    gx, gX = tcb.cut_adjoint(yC, tpool, n, ix)
    np.testing.assert_allclose(seg_sums(ix.xoff, ix.xcut, ix.xcoef, n).numpy(),
                               gx.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        seg_sums(ix.Xoff, ix.Xcut, ix.Xcoef, n * n).reshape(n, n).numpy(),
        gX.numpy(), rtol=1e-6, atol=1e-6)
    live = int((tpool.active > 0).sum())
    assert ix.xcut.numel() == 3 * live and ix.Xcut.numel() == 9 * live
    assert ix.idx.dtype == torch.int32 and ix.Xoff.dtype == torch.int32


def test_solve_matches_reference_with_same_normK():
    inst = generate_spar(13, 100, 2)
    n, M = inst.n, 32
    *_, jpool, jst, _, _, tpool, tst = _setup(n, M, seed=4)
    Q32, c32 = inst.Q.astype(np.float32), inst.c.astype(np.float32)
    normK = float(jpdhg.estimate_norm(jpool, n, 30))
    args = dict(omega0=1.0, tol=1e-7, step_scale=0.95, max_iters=600,
                check_every=100, restart_period=500)
    st_j, info_j = jpdhg._solve_impl(
        jnp.asarray(-c32), jnp.asarray(-0.5 * Q32), jpool, empty_dense(n, jnp.float32),
        jst, normK, args["omega0"], args["tol"], 1e-6, args["step_scale"],
        args["max_iters"], args["check_every"], args["restart_period"])
    st_t, info_t = tpdhg._solve_impl(
        torch.as_tensor(-c32), torch.as_tensor(-0.5 * Q32), tpool,
        build_cut_index(tpool, n), tst, normK, **args)
    assert info_t["iters"] == int(info_j["iters"])
    np.testing.assert_allclose(info_t["dual_obj"], float(info_j["dual_obj"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st_t.x.numpy(), np.asarray(st_j.x), rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(st_t.X.numpy(), np.asarray(st_j.X), rtol=3e-5, atol=3e-5)


def test_estimate_norm_close_to_reference():
    """Different start vectors (jax.random vs torch.Generator): both power
    iterations approach ||K|| from below, so they agree only loosely; 2%
    covers 30 iterations from unrelated starts."""
    n, M = 21, 64
    *_, jpool, _, _, _, tpool, _ = _setup(n, M)
    nj = float(jpdhg.estimate_norm(jpool, n, 30))
    ix = build_cut_index(tpool, n)
    nt = tpdhg.estimate_norm(tpool, n, 30, torch.Generator().manual_seed(0), ix)
    np.testing.assert_allclose(nt, nj, rtol=2e-2)
    assert nt == tpdhg.estimate_norm(tpool, n, 30, torch.Generator().manual_seed(0), ix)


def test_dual_bound_f64_identical_duals():
    inst = generate_spar(13, 100, 2)
    n, M = inst.n, 32
    *_, jpool, jst, _, _, tpool, tst = _setup(n, M, seed=6)
    rng = np.random.default_rng(6)
    yB = 0.1 * rng.random((n, n)).astype(np.float32)
    jst = jst._replace(yB=jnp.asarray(yB))
    tst.yB = torch.as_tensor(yB)
    bj = jpdhg.dual_bound_f64(inst.Q, inst.c, jpool, jst)
    bt = tpdhg.dual_bound_f64(inst.Q, inst.c, tpool, tst)
    np.testing.assert_allclose(bt, bj, rtol=1e-12)


def test_pdhg_block_refuses_devices_without_kernel():
    n, M = 5, 8
    pool = tcb.empty_pool(M, 3, "meta")
    st = tpdhg.init_state(n, M, "meta")
    cx = torch.zeros(n, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pdhg_block(cx, torch.zeros(n, n, device="meta"), pool, None, st, st,
                   0.1, 0.1, 3)


@pytest.mark.parametrize("n,M,k,m", [(125, 1024, 3, 0), (100, 1024, 5, 25),
                                     (125, 2048, 3, 0), (128, 2048, 5, 25)])
def test_launch_plan_covers_every_row_once(n, M, k, m):
    """The cluster plan of the PDHG block kernel at the main paths' shapes,
    the certifier's 2048-row buffer, and the widest case: every row of X in
    exactly one CTA's band, every pool slot in exactly one CTA, and one
    CTA's shared memory within the H100's 232,448 bytes."""
    plan = launch_plan(n, M, k, m)
    assert plan.cluster >= 8
    rows = [i for start, stop in plan.bands(n) for i in range(start, stop)]
    assert rows == list(range(n))
    assert plan.slots * plan.cluster >= M > plan.slots * (plan.cluster - 1)
    assert plan.smem_bytes <= SMEM_MAX and plan.term_cap > 0
    assert plan.max_capacity >= max(M, 2048) and plan.max_dense >= m
    with pytest.raises(ValueError):
        launch_plan(n, plan.max_capacity + 1, k, m)
    with pytest.raises(ValueError):
        launch_plan(n, M, k, plan.max_dense + 1)


@pytest.mark.parametrize("n", [0, 129])
def test_launch_plan_refuses_n_outside_the_kernel(n):
    with pytest.raises(ValueError, match="n <= 128"):
        launch_plan(n, 1024, 3, 0)


@pytest.mark.parametrize("use_kernel,n,M,k,m,kernel", [
    ("auto", 125, 1024, 3, 0, True),      # the BoxQP main paths
    ("auto", 100, 1024, 5, 25, True),     # the QCQP main path
    ("auto", 150, 1024, 3, 0, False),     # n > 128: raises, K2 not launched
    ("auto", 128, 1 << 16, 5, 25, False),  # a pool that does not fit shared memory
    ("on", 125, 1024, 3, 0, True),
    ("off", 125, 1024, 3, 0, False),
    ("off", 150, 1024, 3, 0, False),
])
def test_kernel_route_on_cuda(use_kernel, n, M, k, m, kernel):
    """LPConfig.use_kernel with launch_plan's rule for what the kernel
    takes: on CUDA, "auto" runs K2 or raises with the plan's reason, and the
    plain loop runs on the card only with "off"."""
    why = plan_refusal(n, M, k, m)
    if use_kernel == "auto":
        assert (why is None) is kernel
    if use_kernel == "auto" and why is not None:
        with pytest.raises(ValueError, match=re.escape(why)):
            kernel_route(use_kernel, torch.device("cuda"), n, M, k, m)
    else:
        assert kernel_route(use_kernel, torch.device("cuda"), n, M, k, m) is kernel


def test_kernel_route_auto_is_plain_off_cuda():
    assert kernel_route("auto", torch.device("cpu"), 125, 1024, 3, 0) is False


@pytest.mark.parametrize("n,M,k,m", [(150, 1024, 3, 0), (128, 1 << 16, 5, 25)])
def test_kernel_route_auto_outside_the_plan(n, M, k, m):
    """Outside the plan "auto" is the plain loop on the CPU (the twin's
    arithmetic either way) and refuses on CUDA, naming "off"."""
    assert kernel_route("auto", torch.device("cpu"), n, M, k, m) is False
    with pytest.raises(ValueError, match="use_kernel='off'"):
        kernel_route("auto", torch.device("cuda"), n, M, k, m)


@pytest.mark.parametrize("n,M,k,m,why", [(150, 1024, 3, 0, "n <= 128"),
                                         (128, 1 << 16, 5, 25, "shared memory")])
def test_kernel_route_on_raises_outside_the_plan(n, M, k, m, why):
    for device in ("cuda", "cpu"):
        with pytest.raises(ValueError, match=why):
            kernel_route("on", torch.device(device), n, M, k, m)
    with pytest.raises(ValueError, match=why):
        launch_plan(n, M, k, m)


def test_solve_lp_on_refuses_n150_before_solving():
    inst = generate_spar(150, 100, 1)
    Q, c = (torch.as_tensor(a, dtype=torch.float32) for a in (inst.Q, inst.c))
    pool = tcb.empty_pool(64, 3, "cpu")
    with pytest.raises(ValueError, match="use_kernel='on'"):
        tpdhg.solve_lp(Q, c, pool, tpdhg.init_state(150, 64, "cpu"),
                       LPConfig(use_kernel="on"))


def test_solve_lp_counts_plain_blocks_only_on_cuda():
    """On the CPU the route's plain loop is the twin itself: no plain block
    on the card is counted."""
    inst = generate_spar(13, 100, 2)
    Q, c = (torch.as_tensor(a, dtype=torch.float32) for a in (inst.Q, inst.c))
    pool = tcb.empty_pool(32, 3, "cpu")
    pdhg_block.plain_launches = 0
    _, info = tpdhg.solve_lp(Q, c, pool, tpdhg.init_state(13, 32, "cpu"),
                             LPConfig(max_iters=300, tol=1e-12, use_kernel="off"))
    assert info["iters"] == 300 and pdhg_block.plain_launches == 0
