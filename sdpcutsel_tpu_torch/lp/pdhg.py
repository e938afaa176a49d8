"""Restarted, averaged PDHG for the McCormick + cuts LP (port of
``sdpcutsel_tpu/lp/pdhg.py``).

    min  cobj' z   s.t.  K z >= h,  z in Z
    Z    = {x in [0,1]^n} x {X symmetric, entries in [0,1]}
    K    = scaled McCormick rows + unit-norm cut rows (relax/)
           + for a QCQP, the normalized dense constraint rows (``dense``)
    cobj = (-c, -Q/2)

``dense=None`` (BoxQP) leaves every dense term out; the state's yD is then
empty.

The solve runs on the device as the reference's ``lax.while_loop`` does.
Each checked block is one launch (``pdhg_check.checked_step``):
``check_every`` iterations of K2 in place, then, in the same launch, K5's
control: the ergodic average, the KKT errors of the iterate and of the
average, restart-to-average, primal-weight (omega) rebalancing, the stop
test and the next block's steps, in place on the state and on the solve's
control record (``new_record``: one int32 row of
``REC_WORDS`` words per instance).  K2 takes its steps and the stop flag
from that record, so a block enqueued after its instance stopped does
nothing.  ``_run_groups`` enqueues groups of ``GROUP_BLOCKS`` blocks and
reads the record to the host once after each group (``read_record``);
``iters`` and every bit equal those of a loop that read after each block.
||K|| comes from K6 (``pdhg_norm.pdhg_norm``) in one launch and stays on the
device.  The certifier's LP (a pool without cuts, up to thousands of dense
rows) takes the dense route instead: the same loop over the kernels of
``csrc/pdhg_dense.cu`` (``pdhg_dense.dense_checked_step``: K7's block with
its check in one launch; ``pdhg_dense_norm``); a pool of cuts that K2's
cluster does not hold (n > 256, a large pool, many dense rows) the grid
route's (``pdhg_grid.grid_checked_step``, ``pdhg_grid_norm``).  On the CPU the wrappers take
their plain twins (``pdhg_block_plain``, ``pdhg_check_plain``,
``estimate_norm_plain``), with the same loop; ``LPConfig.use_kernel="off"``
(``kernel_route``) takes the twins on any device, counted on CUDA.  Scalars
are float32, as on the device in the reference.  Everything outside the kernels sums the cut adjoint over the
pool's cut index too (relax/cutbuffer.py), so a solve repeats bit for bit.

``steer_to_vertex`` (vertex steering) runs one more block from a solved
state on a perturbed objective, with the solve's route, cut index and ||K||
(``SolveSetup``).

``dual_bound_f64`` recomputes the Lagrangian certificate in float64 numpy, so
a reported bound never depends on f32 convergence.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..relax.cutbuffer import CutIndex, CutPool, build_cut_index
from ..relax.denserows import DenseRows
from ..relax.mccormick import SA, SB, apply_K, apply_KT, project_primal

_f32 = np.float32


@dataclasses.dataclass
class PDHGState:
    x: torch.Tensor    # (n,)
    X: torch.Tensor    # (n, n)
    yA: torch.Tensor   # (n, n)
    yB: torch.Tensor   # (n, n)
    yC: torch.Tensor   # (M,) cut-row duals
    yD: torch.Tensor   # (m,) dense-row duals (QCQP; m = 0 for BoxQP)

    def fields(self) -> tuple:
        return (self.x, self.X, self.yA, self.yB, self.yC, self.yD)

    def map(self, fn) -> "PDHGState":
        return PDHGState(*(fn(t) for t in self.fields()))

    def add(self, other: "PDHGState") -> "PDHGState":
        return PDHGState(*(a + b for a, b in zip(self.fields(), other.fields())))


def init_state(n: int, capacity: int, device, m: int = 0) -> PDHGState:
    return PDHGState(
        x=torch.full((n,), 0.5, device=device),
        X=torch.full((n, n), 0.25, device=device),
        yA=torch.zeros((n, n), device=device),
        yB=torch.zeros((n, n), device=device),
        yC=torch.zeros((capacity,), device=device),
        yD=torch.zeros((m,), device=device),
    )


def _sym(X):
    return 0.5 * (X + X.T)


def norm_start(n: int, generator: torch.Generator, device):
    """The power iteration's start vector (x, sym(X)): drawn on the CPU from
    ``generator`` and moved to ``device``, so CPU and CUDA runs start alike
    (the reference draws it from jax.random.PRNGKey(0), which torch cannot
    reproduce)."""
    x = torch.randn((n,), generator=generator).to(device)
    return x, _sym(torch.randn((n, n), generator=generator).to(device))


_START = {}        # (n, device): the seed-0 start vector, drawn once


def start_vector(n: int, generator: torch.Generator | None, device):
    """The power iteration's start vector: ``norm_start``'s draw from
    ``generator``; with None, the draw of a fresh
    ``torch.Generator().manual_seed(0)`` (what every solve's set-up asks
    for), made once for each (n, device) and kept there.  The tensors are
    shared: callers do not write them."""
    if generator is not None:
        return norm_start(n, generator, device)
    key = (n, torch.device(device))
    if key not in _START:
        _START[key] = norm_start(n, torch.Generator().manual_seed(0), device)
    return _START[key]


def estimate_norm_plain(pool: CutPool, n: int, iters: int,
                        generator: torch.Generator | None, index: CutIndex,
                        dense: DenseRows | None = None):
    """Twin of K6 (``pdhg_norm.pdhg_norm``): power iteration for ||K|| on
    the symmetric-X primal subspace from ``start_vector`` (``generator``
    None: the seed-0 draw).  Returns ||K|| 1.02 + 1e-12 as a 0-d float32
    tensor on the pool's device."""
    x, X = start_vector(n, generator, pool.lin.device)
    for _ in range(iters):
        kA, kB, kC, *kD = apply_K(x, X, pool, dense)
        gx, gX = apply_KT(kA, kB, kC * pool.active, pool, n, index,
                          kD[0] if kD else None, dense)
        gX = _sym(gX)
        nrm = torch.sqrt((gx * gx).sum() + (gX * gX).sum()) + 1e-30
        x, X = gx / nrm, gX / nrm
    kA, kB, kC, *kD = apply_K(x, X, pool, dense)
    lam2 = (kA * kA).sum() + (kB * kB).sum() + ((kC * pool.active) ** 2).sum()
    if dense is not None:
        lam2 = lam2 + (kD[0] * kD[0]).sum()
    return torch.sqrt(lam2) * 1.02 + 1e-12


def _objective(cx, cX, x, X):
    return torch.dot(cx, x) + (cX * X).sum()


def _dual_bound(cx, cX, pool: CutPool, dense: DenseRows | None, st: PDHGState,
                n: int, index: CutIndex):
    """Box-form Lagrangian lower bound on the min LP; valid for any y >= 0."""
    gx, gX = apply_KT(st.yA, st.yB, st.yC, pool, n, index, st.yD, dense)
    hy = -SB * st.yB.sum() + (pool.rhs * pool.active * st.yC).sum()
    if dense is not None:
        hy = hy + (dense.h * st.yD).sum()
    rx = cx - gx
    S = (cX - gX) + (cX - gX).T
    return hy + rx.clamp(max=0.0).sum() + 0.5 * S.clamp(max=0.0).sum()


def _infeas(x, X, pool: CutPool, dense: DenseRows | None):
    kA, kB, kC, *kD = apply_K(x, X, pool, dense)
    vA = (-kA).clamp(min=0.0)
    vB = (-SB - kB).clamp(min=0.0)
    vC = (pool.rhs * pool.active - kC).clamp(min=0.0) * pool.active
    v2 = (vA ** 2).sum() + (vB ** 2).sum() + (vC ** 2).sum()
    if dense is not None:
        v2 = v2 + ((dense.h - kD[0]).clamp(min=0.0) ** 2).sum()
    return torch.sqrt(v2)


def _kkt_error(cx, cX, pool: CutPool, dense: DenseRows | None, st: PDHGState,
               n: int, index: CutIndex):
    p = _objective(cx, cX, st.x, st.X)
    d = _dual_bound(cx, cX, pool, dense, st, n, index)
    gap = (p - d).clamp(min=0.0)
    return _infeas(st.x, st.X, pool, dense) + gap, p, d


def _one_iter(cx, cX, pool: CutPool, index: CutIndex, n: int, st: PDHGState,
              tau, sigma, dense: DenseRows | None = None):
    gx, gX = apply_KT(st.yA, st.yB, st.yC, pool, n, index, st.yD, dense)
    xn, Xn = project_primal(st.x - tau * (cx - gx), st.X - tau * (cX - gX))
    xb, Xb = 2.0 * xn - st.x, 2.0 * Xn - st.X
    kA, kB, kC, *kD = apply_K(xb, Xb, pool, dense)
    yA = (st.yA - sigma * kA).clamp(min=0.0)
    yB = (st.yB + sigma * (-SB - kB)).clamp(min=0.0)
    yC = (st.yC + sigma * (pool.rhs * pool.active - kC)).clamp(min=0.0) * pool.active
    yD = st.yD if dense is None else (st.yD + sigma * (dense.h - kD[0])).clamp(min=0.0)
    return PDHGState(xn, Xn, yA, yB, yC, yD)


def _dist2(a: PDHGState, b: PDHGState, primal: bool):
    if primal:
        return ((a.x - b.x) ** 2).sum() + ((a.X - b.X) ** 2).sum()
    d2 = (((a.yA - b.yA) ** 2).sum() + ((a.yB - b.yB) ** 2).sum()
          + ((a.yC - b.yC) ** 2).sum())
    if a.yD.numel():
        d2 = d2 + ((a.yD - b.yD) ** 2).sum()
    return d2


# ---- the solve's control record (csrc/pdhg_common.cuh kRec*) ----
REC_IT, REC_WLEN, REC_STOP, REC_RESTART, REC_USE_AVG = 0, 1, 2, 3, 4      # int32 words
REC_OMEGA, REC_ERR, REC_P, REC_D, REC_TAU, REC_SIGMA, REC_ETA, REC_DP, REC_DD = range(5, 14)
REC_WORDS = 16
GROUP_BLOCKS = 8        # checked blocks enqueued between two reads of the record


def new_record(normK, omega0: float, step_scale: float, max_iters: int, tol: float, device,
               batch: int | None = None):
    """The control record of a solve from its start: int32 (REC_WORDS,), or
    (batch, REC_WORDS) per instance, on ``device``, the float words by their
    bits: omega = omega0, err = inf, eta = step_scale / normK (normK a float,
    or a tensor of shape () or (batch,) that stays on the device), tau = eta
    / omega, sigma = eta omega, the stop flag set when no block is to run."""
    shape = (REC_WORDS,) if batch is None else (batch, REC_WORDS)
    rec = torch.zeros(shape, dtype=torch.int32, device=device)
    f = rec.view(torch.float32)
    eta = torch.as_tensor(_f32(step_scale), device=device) / torch.as_tensor(
        normK, dtype=torch.float32, device=device)
    omega = torch.as_tensor(_f32(omega0), device=device)
    f[..., REC_OMEGA] = omega
    f[..., REC_ERR] = float("inf")
    f[..., REC_ETA] = eta
    f[..., REC_TAU] = eta / omega
    f[..., REC_SIGMA] = eta * omega
    rec[..., REC_STOP] = 0 if (max_iters > 0 and np.inf > _f32(tol)) else 1
    return rec


def record_floats(r: np.ndarray) -> np.ndarray:
    """The float32 words of a host copy of records (the same memory)."""
    return r.view(np.float32)


# the solve loops run (``_run_groups`` calls) and their reads of the record
SOLVE_COUNTS = {"solves": 0, "reads": 0}


def read_record(rec) -> np.ndarray:
    """The records on the host (int32; ``record_floats`` views the floats):
    the solve loop's one host read a group, counted in SOLVE_COUNTS."""
    SOLVE_COUNTS["reads"] += 1
    return rec.cpu().numpy()


def _run_groups(step, rec, max_iters: int, check_every: int) -> np.ndarray:
    """Run ``step()`` (one checked block of every instance still running)
    in groups of GROUP_BLOCKS with one read of ``rec`` after each group,
    until every instance has stopped; no group runs past the blocks that
    ``max_iters`` leaves.  Returns the last host copy of the records."""
    SOLVE_COUNTS["solves"] += 1
    r = rec.cpu().numpy() if rec.device.type == "cpu" else None
    left = -(-max_iters // check_every)
    while r is None or (r.reshape(-1, REC_WORDS)[:, REC_STOP] == 0).any():
        for _ in range(min(GROUP_BLOCKS, left)):
            step()
        r = read_record(rec)
        rows = r.reshape(-1, REC_WORDS)
        run = rows[:, REC_STOP] == 0
        if run.any():
            left = int(-(-(max_iters - rows[run, REC_IT].min()) // check_every))
    return r


def pdhg_check_plain(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState, acc: PDHGState,
                     anchor: PDHGState, rec, check_every: int, restart_period: int,
                     max_iters: int, tol: float, dense: DenseRows | None = None):
    """Twin of K5 (the epilogue of ``pdhg_check.pdhg_block_checked``): the
    checked block's control, as the reference's loop body, in place on (st, acc, anchor) and the
    record ``rec`` (REC_WORDS,), read to the host and written back.  Does
    nothing when the record has stopped."""
    r = rec.cpu().numpy()
    f = record_floats(r)
    if r[REC_STOP]:
        return
    n = cx.shape[0]
    wlen = int(r[REC_WLEN]) + check_every
    avg = acc.map(lambda t: t * float(_f32(1.0) / _f32(wlen)))
    kc = _kkt_error(cx, cX, pool, dense, st, n, index)
    ka = _kkt_error(cx, cX, pool, dense, avg, n, index)
    e_c, p_c, d_c, e_a, p_a, d_a = torch.stack([*kc, *ka]).cpu().numpy()
    use_avg = e_a < e_c
    cand = avg if use_avg else st
    err, p, d = (e_a, p_a, d_a) if use_avg else (e_c, p_c, d_c)
    omega = f[REC_OMEGA]
    restart = use_avg or wlen >= restart_period
    if restart:
        # primal-weight rebalancing between restarts (PDLP, theta = 0.5)
        dp, dd = (torch.stack([torch.sqrt(_dist2(cand, anchor, True)),
                               torch.sqrt(_dist2(cand, anchor, False))])
                  .cpu().numpy() + _f32(1e-12))
        omega = np.clip(np.exp(_f32(0.5) * np.log(dd / dp) + _f32(0.5) * np.log(omega)),
                        _f32(1e-4), _f32(1e4)).astype(_f32)
        for a_, b_, t in zip(st.fields(), anchor.fields(), cand.fields()):
            if t is not a_:
                a_.copy_(t)
            b_.copy_(t)
        for t in acc.fields():
            t.zero_()
        f[REC_DP], f[REC_DD] = dp, dd
        wlen = 0
    it = int(r[REC_IT]) + check_every
    r[REC_IT], r[REC_WLEN] = it, wlen
    r[REC_STOP] = it >= max_iters or not err / (_f32(1.0) + abs(p) + abs(d)) > _f32(tol)
    r[REC_RESTART], r[REC_USE_AVG] = restart, use_avg
    f[REC_OMEGA], f[REC_ERR], f[REC_P], f[REC_D] = omega, err, p, d
    f[REC_TAU], f[REC_SIGMA] = f[REC_ETA] / omega, f[REC_ETA] * omega
    if rec.device.type != "cpu":          # on the CPU, r is rec's own memory
        rec.copy_(torch.from_numpy(r))


def _buffers(st0: PDHGState):
    """A solve's state, anchor and sums: contiguous copies of ``st0``
    (which the solve leaves as it is) and zeros, updated in place."""
    def copy(t):
        return t.clone(memory_format=torch.contiguous_format)
    return st0.map(copy), st0.map(copy), st0.map(lambda t: torch.zeros(
        t.shape, dtype=t.dtype, device=t.device))


def _copy_into(dst: PDHGState, src: PDHGState):
    for a, b in zip(dst.fields(), src.fields()):
        a.copy_(b)


def _solve_impl(cx, cX, pool: CutPool, index: CutIndex, st0: PDHGState,
                normK, omega0: float, tol: float, step_scale: float,
                max_iters: int, check_every: int, restart_period: int,
                dense: DenseRows | None = None, route: str = "k2"):
    """Checked-block PDHG solve from ``st0`` (left as it is) with a given
    ``normK`` (a float or a 0-d tensor); ``index`` is
    ``build_cut_index(pool, n)``; ``route`` (``kernel_route``): "k2" each
    block and its check in one launch (``pdhg_check.checked_step``), "grid"
    and "dense" likewise on the grid route (``pdhg_grid.grid_checked_step``)
    and the dense route (``pdhg_dense.dense_checked_step``), "plain" their
    plain twins on the tensors' device.  Returns (state, info) with python
    scalars in info."""
    from .pdhg_check import checked_step, pdhg_block_checked
    from .pdhg_dense import dense_checked_step
    from .pdhg_grid import grid_checked_step
    from .pdhg_kernel import pdhg_block, pdhg_block_steps_plain

    st, anchor, acc = _buffers(st0)
    rec = new_record(normK, omega0, step_scale, max_iters, tol, cx.device)
    args = (cx, cX, pool, index, st, acc)
    control = (anchor, rec, check_every, restart_period, max_iters, tol, dense)
    if route == "k2":
        step = checked_step(*args, *control)
    elif route == "grid":
        step = grid_checked_step(*args, *control)
    elif route == "dense":
        step = dense_checked_step(*args, *control)
    else:
        on_card = cx.device.type == "cuda"

        def step():
            if pdhg_block_steps_plain(*args, rec, check_every, dense) and on_card:
                pdhg_block.plain_launches += 1
                pdhg_block_checked.plain_launches += 1
            pdhg_check_plain(*args, *control)

    r = _run_groups(step, rec, max_iters, check_every)
    f = record_floats(r)
    return st, {"iters": int(r[REC_IT]), "kkt_error": float(f[REC_ERR]),
                "primal_obj": float(f[REC_P]), "dual_obj": float(f[REC_D]),
                "omega": float(f[REC_OMEGA])}


@dataclasses.dataclass
class SolveSetup:
    """What a solve derives from its pool once: the blocks' route, the cut
    index and ||K||.  Steering reuses the solve's, as the pool is the same."""
    route: str            # "k2", "grid", "dense" or "plain" (lp/pdhg_kernel.py::kernel_route)
    index: CutIndex
    normK: object         # a 0-d float32 tensor on the device; a batch's: (B,)


def solve_setup(c, pool: CutPool, cfg, dense: DenseRows | None = None) -> SolveSetup:
    """The route by ``cfg.use_kernel`` (``lp/pdhg_kernel.py::kernel_route``),
    ``build_cut_index`` and ||K|| of a solve over ``pool``: K6
    (``pdhg_norm``) on K2's route, ``pdhg_grid_norm`` on the grid route,
    ``pdhg_dense_norm`` on the dense route, ``estimate_norm_plain`` on the
    plain one; it stays on the device."""
    from .pdhg_dense import pdhg_dense_norm
    from .pdhg_grid import pdhg_grid_norm
    from .pdhg_kernel import kernel_route
    from .pdhg_norm import pdhg_norm

    n = int(c.shape[0])
    M, k = pool.idx.shape
    route = kernel_route(cfg.use_kernel, c.device, n, M, k,
                         0 if dense is None else dense.m)
    index = build_cut_index(pool, n)        # the pool is constant in a solve
    norm = {"k2": pdhg_norm, "grid": pdhg_grid_norm, "dense": pdhg_dense_norm,
            "plain": estimate_norm_plain}[route]
    normK = norm(pool, n, cfg.power_iters, None, index, dense)   # the seed-0 start vector
    if route == "plain" and c.device.type == "cuda":
        pdhg_norm.plain_launches += 1
    return SolveSetup(route, index, normK)


def solve_lp(Q, c, pool: CutPool, state: PDHGState, cfg,
             dense: DenseRows | None = None, setup: SolveSetup | None = None):
    """Solve the current relaxation from the warm start ``state``.

    Q, c: float32 tensors on the state's device; cfg: ``LPConfig``; dense:
    the QCQP's constraint rows, whose duals are ``state.yD``; setup:
    ``solve_setup(c, pool, cfg, dense)``, computed here when None.
    ``cfg.use_kernel`` chooses the blocks (``lp/pdhg_kernel.py::
    kernel_route``): with "auto", on CUDA the iteration kernel K2 for a pool
    of cuts (dense rows or not) that its cluster holds, the grid route for
    the other pools of cuts (n <= 46,340: the open form past n = 2048), the
    dense route for the certifier's
    pool without cuts, raising where none takes (n, capacity, k, m); the
    plain loop on the CPU, or on any device with "off".  Returns (state, info); the max-form
    bound estimate is -info['dual_obj'], the certified one dual_bound_f64.
    """
    if setup is None:
        setup = solve_setup(c, pool, cfg, dense)
    return _solve_impl(-c, -0.5 * Q, pool, setup.index, state, setup.normK, cfg.omega0,
                       cfg.tol, cfg.step_scale, cfg.max_iters, cfg.check_every,
                       cfg.restart_period, dense, setup.route)


# ---- the instance axis: a batch of solves of one shape (parallel/round.py) ----

def estimate_norm_batched_plain(pool: CutPool, n: int, iters: int,
                                generator: torch.Generator | None, index: CutIndex,
                                dense: DenseRows | None = None):
    """Twin of K6's batched launch (``pdhg_norm.pdhg_norm_batched``):
    ``estimate_norm_plain`` of every instance of a batch (``relax/batched.py``
    shapes) in one power iteration; each instance starts from the vector a
    single solve starts from (``start_vector``, broadcast).  Returns ||K|| of
    each instance, (B,) float32 on the device."""
    from ..relax import batched as rb

    B = pool.lin.shape[0]
    x, X = start_vector(n, generator, pool.lin.device)
    x, X = x.expand(B, n), X.expand(B, n, n)
    for _ in range(iters):
        kA, kB, kC, *kD = rb.apply_K(x, X, pool, dense)
        gx, gX = rb.apply_KT(kA, kB, kC * pool.active, pool, n, index,
                             kD[0] if kD else None, dense)
        gX = rb.sym(gX)
        nrm = torch.sqrt((gx * gx).sum(-1) + (gX * gX).sum((-2, -1))) + 1e-30
        x, X = gx / nrm[:, None], gX / nrm[:, None, None]
    kA, kB, kC, *kD = rb.apply_K(x, X, pool, dense)
    lam2 = (kA * kA).sum((-2, -1)) + (kB * kB).sum((-2, -1)) + ((kC * pool.active) ** 2).sum(-1)
    if dense is not None:
        lam2 = lam2 + (kD[0] * kD[0]).sum(-1)
    return torch.sqrt(lam2) * 1.02 + 1e-12


def _dual_bound_batched(cx, cX, pool: CutPool, dense: DenseRows | None, st: PDHGState,
                        n: int, index: CutIndex):
    """``_dual_bound`` of every instance: (B,)."""
    from ..relax import batched as rb

    gx, gX = rb.apply_KT(st.yA, st.yB, st.yC, pool, n, index, st.yD, dense)
    hy = -SB * st.yB.sum((-2, -1)) + (pool.rhs * pool.active * st.yC).sum(-1)
    if dense is not None:
        hy = hy + (dense.h * st.yD).sum(-1)
    rx = cx - gx
    S = (cX - gX) + (cX - gX).transpose(-1, -2)
    return hy + rx.clamp(max=0.0).sum(-1) + 0.5 * S.clamp(max=0.0).sum((-2, -1))


def _kkt_error_batched(cx, cX, pool: CutPool, dense: DenseRows | None, st: PDHGState,
                       n: int, index: CutIndex):
    """``_kkt_error`` of every instance: (err, primal, dual), each (B,)."""
    from ..relax import batched as rb

    p = (cx * st.x).sum(-1) + (cX * st.X).sum((-2, -1))
    d = _dual_bound_batched(cx, cX, pool, dense, st, n, index)
    kA, kB, kC, *kD = rb.apply_K(st.x, st.X, pool, dense)
    v2 = ((-kA).clamp(min=0.0) ** 2).sum((-2, -1)) + ((-SB - kB).clamp(min=0.0) ** 2).sum((-2, -1))
    v2 = v2 + (((pool.rhs * pool.active - kC).clamp(min=0.0) * pool.active) ** 2).sum(-1)
    if dense is not None:
        v2 = v2 + ((dense.h - kD[0]).clamp(min=0.0) ** 2).sum(-1)
    return torch.sqrt(v2) + (p - d).clamp(min=0.0), p, d


def block_check(cx, cX, pool: CutPool, dense: DenseRows | None, st: PDHGState,
                avg: PDHGState, n: int, index: CutIndex) -> np.ndarray:
    """The checked block's KKT errors of every instance, current iterate and
    average, read to the host in one (B, 6) float32 array:
    (err, primal, dual) of the current, then of the average."""
    kc = _kkt_error_batched(cx, cX, pool, dense, st, n, index)
    ka = _kkt_error_batched(cx, cX, pool, dense, avg, n, index)
    return torch.stack([*kc, *ka], 1).cpu().numpy()


def _restart_distances(cand: PDHGState, anchor: PDHGState) -> np.ndarray:
    """(B, 2): the primal and dual distances of ``cand`` from ``anchor``,
    read to the host in one array."""
    dp = ((cand.x - anchor.x) ** 2).sum(-1) + ((cand.X - anchor.X) ** 2).sum((-2, -1))
    dd = (((cand.yA - anchor.yA) ** 2).sum((-2, -1)) + ((cand.yB - anchor.yB) ** 2).sum((-2, -1))
          + ((cand.yC - anchor.yC) ** 2).sum(-1))
    if cand.yD.shape[-1]:
        dd = dd + ((cand.yD - anchor.yD) ** 2).sum(-1)
    return torch.stack([torch.sqrt(dp), torch.sqrt(dd)], 1).cpu().numpy()


def pdhg_check_batched_plain(cx, cX, pool: CutPool, index: CutIndex, st: PDHGState,
                             acc: PDHGState, anchor: PDHGState, rec, check_every: int,
                             restart_period: int, max_iters: int, tol: float,
                             dense: DenseRows | None = None):
    """Twin of K5 in the batched checked launch
    (``pdhg_check.pdhg_block_checked_batched``): ``pdhg_check_plain`` of every
    instance whose record (``rec``: (B, REC_WORDS)) has not stopped, with the reference's vmapped semantics, in
    place: one (B, 6) host read of the KKT errors (``block_check``) and,
    when an instance restarts, one (B, 2) read of its distances."""
    from ..relax import batched as rb

    r = rec.cpu().numpy()
    f = record_floats(r)
    running = r[:, REC_STOP] == 0
    if not running.any():
        return
    n = cx.shape[1]
    dev = cx.device
    wlen = r[:, REC_WLEN].astype(np.int64)
    wlen[running] += check_every
    inv = np.where(wlen > 0, _f32(1.0) / np.maximum(wlen, 1).astype(_f32), _f32(0.0))
    inv_t = torch.as_tensor(inv.astype(_f32)).to(dev)
    avg = acc.map(lambda t: t * inv_t.view(-1, *[1] * (t.dim() - 1)))
    e_c, p_c, d_c, e_a, p_a, d_a = block_check(cx, cX, pool, dense, st, avg, n, index).T
    use_avg = e_a < e_c
    err, p, d = (np.where(running, np.where(use_avg, va, vc), f[:, w])
                 for va, vc, w in ((e_a, e_c, REC_ERR), (p_a, p_c, REC_P), (d_a, d_c, REC_D)))
    omega = f[:, REC_OMEGA].copy()
    restart = running & (use_avg | (wlen >= restart_period))
    if restart.any():
        masks = torch.as_tensor(np.stack([use_avg, restart])).to(dev)
        cand = rb.where(masks[0], avg, st)
        dist = _restart_distances(cand, anchor) + _f32(1e-12)
        # primal-weight rebalancing between restarts (PDLP, theta = 0.5)
        new_omega = np.clip(np.exp(_f32(0.5) * np.log(dist[:, 1] / dist[:, 0])
                                   + _f32(0.5) * np.log(omega)),
                            _f32(1e-4), _f32(1e4)).astype(_f32)
        omega = np.where(restart, new_omega, omega).astype(_f32)
        _copy_into(st, rb.where(masks[1], cand, st))
        _copy_into(anchor, rb.where(masks[1], cand, anchor))
        _copy_into(acc, rb.where(masks[1], acc.map(torch.zeros_like), acc))
        wlen[restart] = 0
        f[restart, REC_DP], f[restart, REC_DD] = dist[restart, 0], dist[restart, 1]
    it = r[:, REC_IT].astype(np.int64) + np.where(running, check_every, 0)
    stop = (it >= max_iters) | ~(err / (_f32(1.0) + np.abs(p) + np.abs(d)) > _f32(tol))
    r[:, REC_IT] = it
    r[:, REC_WLEN] = wlen
    r[:, REC_STOP] = np.where(running, stop, True)
    r[running, REC_RESTART] = restart[running]
    r[running, REC_USE_AVG] = use_avg[running]
    f[:, REC_OMEGA], f[:, REC_ERR], f[:, REC_P], f[:, REC_D] = omega, err, p, d
    f[:, REC_TAU], f[:, REC_SIGMA] = f[:, REC_ETA] / omega, f[:, REC_ETA] * omega
    if rec.device.type != "cpu":          # on the CPU, r is rec's own memory
        rec.copy_(torch.from_numpy(r))


def _solve_batched(cx, cX, pool: CutPool, index: CutIndex, st0: PDHGState, normK,
                   omega0: float, tol: float, step_scale: float, max_iters: int,
                   check_every: int, restart_period: int,
                   dense: DenseRows | None = None, route: str = "k2"):
    """``_solve_impl`` for a batch of B instances of one shape: cx (B, n),
    cX (B, n, n), the other arguments with the instance axis first
    (``relax/batched.py``; ``index`` from its ``build_cut_index``), normK
    (B,) on the device or the host.  The semantics of the reference's
    vmapped ``lax.while_loop``: every instance stops at its own tolerance or
    at ``max_iters`` and is frozen from then on; omega, the restart anchor,
    the window and the error are per instance (a row of the control record
    each); the loop runs while any instance runs.  Each checked block is one
    batched checked launch for every instance, a stopped one doing nothing:
    on route "k2" K2 with K5 (``pdhg_check.checked_step``), one cluster an
    instance; on route "grid" the grid route's checked block
    (``pdhg_grid.grid_checked_step``), which walks the instances one after
    another over the whole card.  One read of the records a group.  With
    ``route`` "plain" the twins run instead (the block for the instances
    still running, counted in ``pdhg_block.plain_launches`` on CUDA); the
    dense route solves one instance.  Returns (state, info) with (B,) numpy
    arrays in info."""
    from .pdhg_check import checked_step, pdhg_block_checked
    from .pdhg_grid import grid_checked_step
    from .pdhg_kernel import pdhg_block, pdhg_block_steps_batched_plain

    B = cx.shape[0]
    st, anchor, acc = _buffers(st0)
    rec = new_record(normK, omega0, step_scale, max_iters, tol, cx.device, batch=B)
    args = (cx, cX, pool, index, st, acc)
    control = (anchor, rec, check_every, restart_period, max_iters, tol, dense)
    if route in ("k2", "grid"):
        step = (checked_step if route == "k2" else grid_checked_step)(*args, *control,
                                                                      batched=True)
    elif route != "plain":
        raise ValueError(f"a batched solve takes the 'k2', 'grid' or 'plain' route, got {route!r}")
    else:
        on_card = cx.device.type == "cuda"

        def step():
            if pdhg_block_steps_batched_plain(*args, rec, check_every, dense) and on_card:
                pdhg_block.plain_launches += 1
                pdhg_block_checked.plain_launches += 1
            pdhg_check_batched_plain(*args, *control)

    r = _run_groups(step, rec, max_iters, check_every)
    f = record_floats(r)
    return st, {"iters": r[:, REC_IT].astype(np.int64), "kkt_error": f[:, REC_ERR].astype(np.float64),
                "primal_obj": f[:, REC_P].copy(), "dual_obj": f[:, REC_D].copy(),
                "omega": f[:, REC_OMEGA].copy()}


def solve_setup_batched(c, pool: CutPool, cfg, dense: DenseRows | None = None) -> SolveSetup:
    """``solve_setup`` of a batch (c (B, n)): the route by ``cfg.use_kernel``
    at the batch's shape, ``relax.batched.build_cut_index`` and ||K|| of
    every instance, (B,) on the device (K6's batched launch on K2's route,
    the grid route's batched norm on the grid route, which takes the shapes
    K2's cluster refuses, ``estimate_norm_batched_plain`` on the plain one).
    The dense route has no instance axis: a batch of the certifier's pools
    raises, as a shape no route takes does (``kernel_route``)."""
    from ..relax import batched as rb
    from .pdhg_grid import pdhg_grid_norm_batched
    from .pdhg_kernel import kernel_route
    from .pdhg_norm import pdhg_norm, pdhg_norm_batched

    n = int(c.shape[1])
    M, k = pool.idx.shape[1:]
    m = 0 if dense is None else dense.G.shape[1]
    route = kernel_route(cfg.use_kernel, c.device, n, M, k, m)
    if route == "dense":
        raise ValueError("the dense route solves one instance; batches take pools of cuts")
    index = rb.build_cut_index(pool, n)
    norm = {"k2": pdhg_norm_batched, "grid": pdhg_grid_norm_batched,
            "plain": estimate_norm_batched_plain}[route]
    normK = norm(pool, n, cfg.power_iters, None, index, dense)   # the seed-0 start vector
    if route == "plain" and c.device.type == "cuda":
        pdhg_norm.plain_launches += 1
    return SolveSetup(route, index, normK)


def rademacher_signs(n: int, generator: torch.Generator, device):
    """Steering's perturbation signs (sx: (n,), SX: (n, n)), +-1 in float32,
    drawn on the CPU from ``generator`` (x first) and moved to ``device``, so
    that both devices steer alike."""
    sx = torch.randint(0, 2, (n,), generator=generator)
    SX = torch.randint(0, 2, (n, n), generator=generator)
    return ((2 * sx - 1).to(torch.float32).to(device),
            (2 * SX - 1).to(torch.float32).to(device))


def _steer_impl(cx, cX, pool: CutPool, dense: DenseRows | None, st: PDHGState,
                setup: SolveSetup, omega: float, step_scale: float, eps: float,
                sx, SX, iters: int):
    """``iters`` PDHG iterations from ``st`` on the objective perturbed by
    eps (mean |cX| + mean |cx|) (sx, sym(SX)), at the fixed steps tau =
    eta / omega, sigma = eta omega, eta = step_scale / normK: one block,
    through the solve's route (K2 on CUDA, or the grid or dense route's
    block; its ergodic sums are discarded).  Returns (x, X)."""
    from .pdhg_dense import pdhg_dense_block
    from .pdhg_grid import pdhg_grid_block
    from .pdhg_kernel import pdhg_block, pdhg_block_plain

    scale = float(eps) * (cX.abs().mean() + cx.abs().mean())
    cx_p = cx + scale * sx
    cX_p = cX + scale * _sym(SX)
    eta = _f32(step_scale) / _f32(float(setup.normK))      # a host float: one read
    tau, sigma = eta / _f32(omega), eta * _f32(omega)
    block = {"k2": pdhg_block, "grid": pdhg_grid_block, "dense": pdhg_dense_block,
             "plain": pdhg_block_plain}[setup.route]
    if setup.route == "plain" and cx.device.type == "cuda":
        pdhg_block.plain_launches += 1
    st, _ = block(cx_p, cX_p, pool, setup.index, st, st.map(torch.zeros_like),
                  float(tau), float(sigma), iters, dense)
    return st.x, st.X


def steer_to_vertex(Q, c, pool: CutPool, state: PDHGState, cfg, generator: torch.Generator,
                    eps: float, iters: int, dense: DenseRows | None = None,
                    setup: SolveSetup | None = None):
    """Vertex steering: a scoring-only re-solve on an objective perturbed by
    a small Rademacher vector, warm-started from the converged ``state``.

    At a McCormick LP optimum the optimal face is typically large and the
    candidates' violations tie; a simplex backend lands on a vertex of that
    face, PDHG on an interior point of it.  The perturbation makes the
    optimum (generically) a single vertex of the original face, so a short
    warm-started run drives the iterate toward it.  The steered point is for
    scoring and cut generation only: the certified bound stays the
    unperturbed solve's.  ``setup``: the solve's (``solve_setup``), since
    the pool is the same; ``generator``: a CPU generator (``rademacher_signs``).
    Returns (x, X)."""
    if setup is None:
        setup = solve_setup(c, pool, cfg, dense)
    sx, SX = rademacher_signs(int(c.shape[0]), generator, c.device)
    return _steer_impl(-c, -0.5 * Q, pool, dense, state, setup, cfg.omega0,
                       cfg.step_scale, eps, sx, SX, iters)


def dual_bound_f64(Q, c, pool: CutPool, state: PDHGState,
                   dense_np=None) -> float:
    """Certified max-form upper bound from the current duals, in float64
    numpy, with the per-block scaling polish of the reference: any block
    scalings t >= 0 give a valid bound, so coordinate ascent over a grid
    only tightens it.

    ``dense_np=(G, g, h)``: a host copy of the dense rows (the QCQP solver
    keeps one, so no round copies G off the device); it adds the fourth
    block, with duals ``state.yD``."""

    def host(t):
        return t.detach().cpu().numpy().astype(np.float64)

    n = int(np.asarray(c).shape[0])
    Q = np.asarray(Q, np.float64)
    c = np.asarray(c, np.float64)
    yA = np.maximum(host(state.yA), 0.0)
    yB = np.maximum(host(state.yB), 0.0)
    act = host(pool.active)
    yC = np.maximum(host(state.yC), 0.0) * act
    idx = pool.idx.detach().cpu().numpy()
    lin, quad, rhs = host(pool.lin), host(pool.quad), host(pool.rhs)

    cx = -c
    cX = -0.5 * Q
    gxA = SA * yA.sum(1)
    gXA = -SA * yA
    gxB = -SB * (yB.sum(1) + yB.sum(0))
    gXB = SB * yB
    hyB = -SB * yB.sum()
    gxC = np.zeros(n)
    np.add.at(gxC, idx.ravel(), (yC[:, None] * lin).ravel())
    flat = np.zeros(n * n)
    np.add.at(flat, (idx[:, :, None] * n + idx[:, None, :]).ravel(),
              (yC[:, None, None] * quad).ravel())
    gXC = flat.reshape(n, n)
    hyC = float((rhs * act) @ yC)
    blocks = [(0.0, gxA, gXA), (hyB, gxB, gXB), (hyC, gxC, gXC)]
    if dense_np is not None:
        G, g, hD = (np.asarray(a, np.float64) for a in dense_np)
        yD = np.maximum(host(state.yD), 0.0)[: hD.shape[0]]
        blocks.append((float(hD @ yD), g.T @ yD, np.einsum("m,mij->ij", yD, G)))

    Ssym = cX + cX.T
    hys = np.array([b[0] for b in blocks])
    gxs = np.stack([b[1] for b in blocks])
    gSs = np.stack([b[2] + b[2].T for b in blocks])

    def D(ts):
        rx_t = cx - np.tensordot(ts, gxs, axes=1)
        S_t = Ssym - np.tensordot(ts, gSs, axes=1)
        return (float(ts @ hys) + np.minimum(rx_t, 0.0).sum()
                + 0.5 * np.minimum(S_t, 0.0).sum())

    ts = np.ones(len(blocks))
    best = D(ts)
    grid = np.concatenate([[1.0], np.geomspace(0.5, 2.0, 7)])
    for _ in range(2):  # coordinate-ascent passes
        for b in range(len(blocks)):
            for t in grid:
                cand = ts.copy()
                cand[b] = ts[b] * t
                v = D(cand)
                if v > best:
                    best, ts = v, cand
    return float(-best)  # max-form upper bound
