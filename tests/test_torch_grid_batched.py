"""The grid route's instance axis (lp/pdhg_grid.py, csrc/pdhg_grid.cu) on the
CPU: a batch past K2's cluster sets up on the grid route and its batched
norm, and refuses only where the route does; the batched wrappers marshal
what the batched C entries take (a stand-in library records the launches:
B or ids, the records, the instance strides, G's stride padded where m n n
is not a multiple of 4, one launch a checked step); the batched solve on the
grid route is each instance's own solve; and the slice as a whole, one
batched round of QCQP band instances past K2's dense rows, against the JAX
package.  The kernels run only on the card (chip_smoke.py phase 20 holds
them to their twins and to the single-instance entries there); torch runs
on one thread here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpcutsel_tpu.parallel.mesh import make_mesh as j_make_mesh
from sdpcutsel_tpu.parallel.round import certify_batched_f64 as j_certify
from sdpcutsel_tpu.parallel.round import init_batched_state as j_init
from sdpcutsel_tpu.parallel.round import make_sharded_round_step as j_step
from sdpcutsel_tpu.parallel.sharding import shard_candidates as j_shard
from sdpcutsel_tpu.relax.denserows import batched_dense_from_qcqp as j_batched_dense
from sdpcutsel_tpu_torch.config import LPConfig, RunConfig
from sdpcutsel_tpu_torch.instances import generate_spar
from sdpcutsel_tpu_torch.instances.qcqp import generate_qcqp_band
from sdpcutsel_tpu_torch.lp import pdhg as tpdhg
from sdpcutsel_tpu_torch.lp import pdhg_grid as tgrid
from sdpcutsel_tpu_torch.lp.pdhg_kernel import (columns, plan_refusal, route_refusal,
                                                steps_record)
from sdpcutsel_tpu_torch.parallel import make_mesh, shard_candidates
from sdpcutsel_tpu_torch.parallel import round as R
from sdpcutsel_tpu_torch.qcqp.chordal import chordal_decomposition, clique_candidates
from sdpcutsel_tpu_torch.relax import batched as rb
from sdpcutsel_tpu_torch.relax import cutbuffer as tcb
from sdpcutsel_tpu_torch.relax.denserows import DenseRows, batched_dense_from_qcqp
from test_torch_grid import _fake_card

CAP = 1024


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's CPU threads share this process; torch's intra-op pool on top of
    them oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(n: int, k: int, m: int, B: int = 2, M: int = CAP, live: int = 40, seed: int = 3):
    """(cx, cX, pool, index, state, dense) of a batch of B at (n, M, k, m):
    generate_qcqp_band(n, 5, m, s + 1)'s objectives and dense rows (m > 0)
    or generate_spar(n, 100, s + 1)'s, each instance's pool holding its own
    ``live`` unit cuts of width k, and a small random state."""
    rng = np.random.default_rng(seed)
    if m:
        insts = [generate_qcqp_band(n, 5, m, s + 1) for s in range(B)]
        Q = np.stack([i.Q0 for i in insts])
        c = np.stack([i.c0 for i in insts])
        dense = batched_dense_from_qcqp(insts, "cpu")
    else:
        insts = [generate_spar(n, 100, s + 1) for s in range(B)]
        Q, c, dense = np.stack([i.Q for i in insts]), np.stack([i.c for i in insts]), None
    Q, c = torch.as_tensor(Q, dtype=torch.float32), torch.as_tensor(c, dtype=torch.float32)
    pool = rb.empty_pool(B, M, k, "cpu")
    idx = torch.as_tensor(np.stack([np.stack([np.sort(rng.choice(n, k, replace=False))
                                              for _ in range(live)]) for _ in range(B)]))
    lin = torch.as_tensor(rng.standard_normal((B, live, k)), dtype=torch.float32)
    quad = torch.as_tensor(rng.standard_normal((B, live, k, k)), dtype=torch.float32)
    quad = 0.5 * (quad + quad.transpose(-1, -2))
    nrm = torch.sqrt((lin ** 2).sum(-1) + (quad ** 2).sum((-2, -1)))
    rhs = torch.as_tensor(-0.1 * rng.random((B, live)), dtype=torch.float32) / nrm
    pool = rb.append_cuts(pool, idx, lin / nrm[..., None], quad / nrm[..., None, None], rhs,
                          torch.ones(B, live))
    st = tpdhg.init_state(n, M, "cpu", m)
    st = st.map(lambda t: t.expand(B, *t.shape).clone())
    return -c, -0.5 * Q, pool, rb.build_cut_index(pool, n), st, dense, Q, c


# ---- the routes: a batch past K2's cluster sets up on the grid route -----------

@pytest.mark.parametrize("n,M,k,m", [(257, CAP, 3, 0), (200, CAP, 5, 25), (150, CAP, 5, 26)])
def test_batched_setup_takes_the_grid_route(n, M, k, m, monkeypatch):
    """With "on", a batch at a shape K2's cluster refuses takes the grid
    route, and its norm is the grid route's batched norm: on the CPU its twin
    estimate_norm_batched_plain, bit for bit."""
    assert plan_refusal(n, M, k, m) is not None and route_refusal(n, M, k, m) == ("grid", None)
    cx, cX, pool, index, st, dense, Q, c = _batch(n, k, m)
    calls = []
    real = tgrid.pdhg_grid_norm_batched

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tgrid, "pdhg_grid_norm_batched", counted)
    setup = tpdhg.solve_setup_batched(c, pool, LPConfig(use_kernel="on"), dense)
    assert setup.route == "grid" and calls == [1]
    assert setup.normK.shape == (2,)
    assert torch.equal(setup.normK, tpdhg.estimate_norm_batched_plain(pool, n, 30, None,
                                                                      setup.index, dense))


def test_batched_setup_still_refuses_the_certifier_and_n513():
    """A batch of the certifier's pools raises (both packages solve it one
    instance at a time), and so does n = 46,341, past the open form's
    32-bit bound, with the routes' reason; n = 1025 and 2049 are the grid
    route's."""
    n, m = 300, 4
    pool = rb.empty_pool(2, 1, 1, "cpu")
    dense = DenseRows(torch.zeros(2, m, n, n), torch.zeros(2, m, n), torch.zeros(2, m))
    with pytest.raises(ValueError, match="dense route solves one instance"):
        tpdhg.solve_setup_batched(torch.zeros(2, n), pool, LPConfig(use_kernel="on"), dense)
    with pytest.raises(ValueError, match="n <= 46340"):
        tpdhg.solve_setup_batched(torch.zeros(2, 46341), rb.empty_pool(2, CAP, 3, "cpu"),
                                  LPConfig(use_kernel="on"))
    assert route_refusal(1025, CAP, 3, 0) == ("grid", None)
    assert route_refusal(2049, CAP, 3, 0) == ("grid", None)


# ---- the batched wrappers against the library's signatures ---------------------

@pytest.mark.parametrize("n,k,m", [(201, 5, 25), (200, 5, 25), (300, 3, 0)])
def test_batched_launches_match_the_library(n, k, m, monkeypatch):
    """The batched block (the instances ids), its in-place steps form, the
    checked step and the norm marshal what the batched C entries take:
    count and ids or B, the (B, REC_WORDS) records, the cut index's term
    strides, G's and g's instance strides rounded up to 4 floats (a padded
    copy where the batch's own stride is not, made once a step function and
    kept across its launches), the layout's shared bytes and the scratch on
    the grid; one launch counted a call, a checked step once whatever B."""
    lib = _fake_card(monkeypatch)
    cx, cX, pool, index, st, dense, _, _ = _batch(n, k, m, B=3, live=8)
    M = pool.idx.shape[1]
    acc, anc = st.map(torch.zeros_like), st.map(torch.clone)
    rec = steps_record([0.1] * 3, [0.1] * 3, "cpu")
    smem = 4 * tgrid.block_words(n, M, m, True)
    sG, sg = -(-m * n * n // 4) * 4, -(-m * n // 4) * 4
    ex, eX = index.xcut.shape[-1], index.Xcut.shape[-1]
    before = (tgrid.pdhg_grid_block.launches, tgrid.pdhg_grid_block_checked.launches,
              tgrid.pdhg_grid_norm.launches)

    ids = np.array([0, 2])
    tgrid._launch_block_batched(cx, cX, pool, index, [st, acc], [st, acc], rec, 3, ids, dense)
    step = tgrid._checked_batched_launcher(cx, cX, pool, index, st, acc, anc, rec, 100, 500,
                                           1000, 1e-6, dense)
    step()
    step()
    names = [c[0] for c in lib.calls]
    assert names == ["pdhg_grid_ctas", "pdhg_grid_block_batched_launch", "pdhg_grid_ctas",
                     "pdhg_grid_block_checked_batched_launch",
                     "pdhg_grid_block_checked_batched_launch"]
    blk, chk, chk2 = lib.calls[1][1], lib.calls[3][1], lib.calls[4][1]
    assert blk[:9] == (n, M, k, m, 3, columns(n), 1, smem, 2)
    assert list(blk[9]) == [0, 2] and blk[10] == rec.data_ptr()
    assert blk[11:15] == (ex, eX, sG, sg)
    assert chk[:9] == (n, M, k, m, 100, columns(n), 1, smem, 3)
    assert chk[9:17] == (500, 1000, float(np.float32(1e-6)), rec.data_ptr(), ex, eX, sG, sg)
    assert chk == chk2                       # the pointers, copies included, taken once
    G_ptr = chk[19]
    if m:
        aligned = (m * n * n) % 4 == 0 and (m * n) % 4 == 0
        assert (G_ptr == dense.G.data_ptr()) == aligned
        assert G_ptr % 16 == 0 and sG % 4 == 0 and sg % 4 == 0
    else:
        assert G_ptr is None and (sG, sg) == (0, 0)
    assert lib.calls[0][1][:7] == (n, M, k, m, columns(n), 1, smem)

    norm = tgrid._launch_norm_batched(pool, n, 30, None, index, dense)
    call = lib.calls[-1]
    assert call[0] == "pdhg_grid_norm_batched_launch"
    assert call[1][:13] == (n, M, k, m, 3, 30, columns(n), 1, smem, ex, eX, sG, sg)
    assert norm.shape == (3,)
    after = (tgrid.pdhg_grid_block.launches, tgrid.pdhg_grid_block_checked.launches,
             tgrid.pdhg_grid_norm.launches)
    assert after == (before[0] + 3, before[1] + 2, before[2] + 1)


def test_dense_layout_pads_only_unaligned_strides():
    """dense_layout keeps a batch whose m n n and m n are multiples of 4 as
    it is, and copies one whose are not into rows of the rounded strides,
    zeros past each instance's rows."""
    for n, m, copied in ((200, 25, False), (201, 25, True), (151, 26, True), (300, 0, False)):
        dense = None if m == 0 else DenseRows(torch.rand(2, m, n, n), torch.rand(2, m, n),
                                              torch.rand(2, m))
        G, g, h, sG, sg = tgrid.dense_layout(dense)
        if m == 0:
            assert (G, g, h, sG, sg) == (None, None, None, 0, 0)
            continue
        assert sG % 4 == sg % 4 == 0 and sG - m * n * n < 4 and sg - m * n < 4
        assert (G.data_ptr() != dense.G.data_ptr()) == ((m * n * n) % 4 != 0)
        assert (g.data_ptr() != dense.g.data_ptr()) == ((m * n) % 4 != 0)
        assert copied == ((m * n * n) % 4 != 0 or (m * n) % 4 != 0)
        for b in range(2):
            assert torch.equal(G.reshape(2, -1)[b, :m * n * n], dense.G[b].reshape(-1))
            assert not G.reshape(2, -1)[b, m * n * n:].any()
            assert torch.equal(g.reshape(2, -1)[b, :m * n], dense.g[b].reshape(-1))


def test_batched_wrappers_refuse_other_devices_and_shapes():
    """The batched wrappers raise on a device without a kernel, and on CUDA
    for a batch of the certifier's pools (the grid route's refusal)."""
    cx, cX, pool, index, st, dense, _, _ = _batch(150, 5, 26, live=4)
    meta = lambda t: t.to("meta")      # noqa: E731
    mst = st.map(meta)
    mpool = tcb.CutPool(*(meta(t) for t in (pool.idx, pool.lin, pool.quad, pool.rhs,
                                            pool.active, pool.count)))
    mdense = DenseRows(*(meta(t) for t in (dense.G, dense.g, dense.h)))
    rec = torch.zeros(2, tpdhg.REC_WORDS, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tgrid.pdhg_grid_block_batched(meta(cx), meta(cX), mpool, index, mst, mst, [0.1] * 2,
                                      [0.1] * 2, 3, [0, 1], mdense)
    with pytest.raises(ValueError, match="no kernel"):
        tgrid.pdhg_grid_block_steps_batched(meta(cx), meta(cX), mpool, index, mst, mst, rec, 3,
                                            mdense)
    with pytest.raises(ValueError, match="no kernel"):
        tgrid.pdhg_grid_block_checked_batched(meta(cx), meta(cX), mpool, index, mst, mst, mst,
                                              rec, 100, 300, 1000, 1e-6, mdense)
    with pytest.raises(ValueError, match="no kernel"):
        tgrid.pdhg_grid_norm_batched(mpool, 150, 30, None, index, mdense)
    n, m = 300, 3
    cpool = rb.empty_pool(2, 1, 1, "cpu")
    cst = tpdhg.init_state(n, 1, "cpu", m)
    cst = cst.map(lambda t: t.expand(2, *t.shape).clone())
    cdense = DenseRows(torch.zeros(2, m, n, n), torch.zeros(2, m, n), torch.zeros(2, m))
    with pytest.raises(ValueError, match="k = 2..5"):
        tgrid._batched_args(torch.zeros(2, n), torch.zeros(2, n, n), cpool,
                            rb.build_cut_index(cpool, n), (cst,), cdense, "pdhg_grid_block")


# ---- the batched solve on the grid route: each instance's own solve ------------

def test_grid_batched_solve_matches_single_solves():
    """_solve_batched on the grid route (its twins on the CPU) stops each
    instance where its own solve_lp on the grid route stops, at the
    tolerances of tests/test_torch_batched.py's batched solve; a stopped
    instance stays frozen while the other runs."""
    cx, cX, pool, index, st, dense, Q, c = _batch(150, 5, 26)
    cfg = LPConfig(max_iters=1500, tol=1e-4, use_kernel="on")
    setup = tpdhg.solve_setup_batched(c, pool, cfg, dense)
    assert setup.route == "grid"
    got, info = tpdhg._solve_batched(cx, cX, pool, setup.index, st, setup.normK, cfg.omega0,
                                     cfg.tol, cfg.step_scale, cfg.max_iters, cfg.check_every,
                                     cfg.restart_period, dense, setup.route)
    for b in range(2):
        one, one_info = tpdhg.solve_lp(Q[b], c[b], rb.instance(pool, b), rb.instance(st, b), cfg,
                                       rb.instance(dense, b))
        assert one_info["iters"] == info["iters"][b]
        np.testing.assert_allclose(info["kkt_error"][b], one_info["kkt_error"], rtol=1e-3)
        np.testing.assert_allclose(got.X[b].numpy(), one.X.numpy(), atol=1e-4)


# ---- the slice: a batched round past K2's dense rows against the JAX package ----

BAND = (150, 5, 26)                 # generate_qcqp_band(n, bandwidth, m, s): K2 holds 25 rows
BAND_B, BAND_K, BAND_ITERS, BAND_SEL = 2, 5, 300, 16


def test_band_batched_round_matches_reference(monkeypatch):
    """One batched round of 2 x generate_qcqp_band(150, 5, 26, s), whose 26
    dense rows K2's cluster does not hold at capacity 1024, through the grid
    route ("on"; its twins on the CPU) against the JAX package's
    make_sharded_round_step on the CPU: the same cuts in every pool and the
    f64 certificates at rtol 2e-3 (tests/test_torch_batched_qcqp.py's
    tolerances)."""
    n, bw, m = BAND
    fam = [generate_qcqp_band(n, bw, m, s + 1) for s in range(BAND_B)]
    cliques, _ = chordal_decomposition(n, fam[0].sparsity_graph())
    table_np = clique_candidates(cliques, BAND_K)
    Qb = np.stack([i.Q0 for i in fam]).astype(np.float32)
    cb = np.stack([i.c0 for i in fam]).astype(np.float32)
    assert route_refusal(n, CAP, BAND_K, m) == ("grid", None)

    routes = []
    real = R.solve_setup_batched

    def recorded(*a, **kw):
        out = real(*a, **kw)
        routes.append(out.route)
        return out

    monkeypatch.setattr(R, "solve_setup_batched", recorded)
    mesh = make_mesh(1, 2)
    dense = batched_dense_from_qcqp(fam, "cpu")
    state = R.init_batched_state(Qb, cb, CAP, BAND_K, m_dense=m, device="cpu")
    table, valid = shard_candidates(table_np, mesh, device="cpu")
    knobs = dict(lp_iters=BAND_ITERS, sel_size=BAND_SEL, strategy="neural", kmax=BAND_K,
                 m_dense=m)
    ours, _ = R.make_sharded_round_step(mesh, RunConfig(lp=LPConfig(use_kernel="on")),
                                        **knobs)(state, table, valid, dense)
    assert routes == ["grid"]

    jmesh = j_make_mesh(data=1, cand=2)
    jdense = j_batched_dense(fam)
    jstate = j_init(jnp.asarray(Qb), jnp.asarray(cb), capacity=CAP, kmax=BAND_K, m_dense=m)
    jtable, jvalid = j_shard(table_np, jmesh)
    theirs, _ = j_step(jmesh, **knobs)(jstate, jtable, jvalid, jdense)
    np.testing.assert_array_equal(ours.pool.count.numpy(), np.asarray(theirs.pool.count))
    for got, want in zip(ours.pool.idx.numpy(), np.asarray(theirs.pool.idx)):
        assert sorted(map(tuple, got)) == sorted(map(tuple, want))
    assert ours.pool.count.min() > 0
    np.testing.assert_allclose(R.certify_batched_f64(ours, dense), j_certify(theirs, jdense),
                               rtol=2e-3)
