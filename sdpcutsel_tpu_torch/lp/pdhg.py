"""Restarted, averaged PDHG for the McCormick + cuts LP (port of
``sdpcutsel_tpu/lp/pdhg.py``).

    min  cobj' z   s.t.  K z >= h,  z in Z
    Z    = {x in [0,1]^n} x {X symmetric, entries in [0,1]}
    K    = scaled McCormick rows + unit-norm cut rows (relax/)
           + for a QCQP, the normalized dense constraint rows (``dense``)
    cobj = (-c, -Q/2)

``dense=None`` (BoxQP) leaves every dense term out; the state's yD is then
empty.

Each checked block runs ``check_every`` iterations through the iteration-block
kernel wrapper (lp/pdhg_kernel.py), or through the plain ``_one_iter`` loop
where ``LPConfig.use_kernel`` says so (``kernel_route``), then, in plain torch once per block: the
ergodic average, restart-to-average when the average's KKT error is lower,
and primal-weight (omega) rebalancing.  The JAX ``lax.while_loop`` condition
becomes one host read per block.  Host-side scalars (step sizes, omega, the
stopping test) are float32, as they are on the device in the reference.
Everything outside the kernel sums the cut adjoint over the pool's cut
index too (relax/cutbuffer.py), so a solve on CUDA repeats bit for bit.

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


def estimate_norm(pool: CutPool, n: int, iters: int,
                  generator: torch.Generator, index: CutIndex,
                  dense: DenseRows | None = None) -> float:
    """Power iteration for ||K|| on the symmetric-X primal subspace.  The
    start vector is drawn on the CPU from ``generator``, so CPU and CUDA runs
    start alike (the reference draws it from jax.random.PRNGKey(0), which
    torch cannot reproduce)."""
    dev = pool.lin.device
    x = torch.randn((n,), generator=generator).to(dev)
    X = _sym(torch.randn((n, n), generator=generator).to(dev))
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
    return float(torch.sqrt(lam2) * 1.02 + 1e-12)


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


def _solve_impl(cx, cX, pool: CutPool, index: CutIndex, st0: PDHGState,
                normK: float, omega0: float, tol: float, step_scale: float,
                max_iters: int, check_every: int, restart_period: int,
                dense: DenseRows | None = None, kernel: bool = True):
    """Checked-block PDHG solve from ``st0`` with a given ``normK``; ``index``
    is ``build_cut_index(pool, n)``; ``kernel``: blocks through
    ``pdhg_block``, else the plain loop (``kernel_route``).  Returns (state,
    info) with python scalars in info."""
    from .pdhg_kernel import pdhg_block, pdhg_block_plain

    block = pdhg_block if kernel else pdhg_block_plain
    plain_on_card = not kernel and cx.device.type == "cuda"
    n = cx.shape[0]
    eta = _f32(step_scale) / _f32(normK)
    zeros = st0.map(torch.zeros_like)
    st, acc, anchor, wlen, it = st0, zeros, st0, 0, 0
    omega = _f32(omega0)
    err, p, d = _f32(np.inf), _f32(0.0), _f32(0.0)
    while it < max_iters and err / (_f32(1.0) + abs(p) + abs(d)) > _f32(tol):
        tau, sigma = eta / omega, eta * omega
        st, acc = block(cx, cX, pool, index, st, acc, float(tau), float(sigma),
                        check_every, dense)
        if plain_on_card:
            pdhg_block.plain_launches += 1
        wlen += check_every
        avg = acc.map(lambda t: t * float(_f32(1.0) / _f32(wlen)))

        kc = _kkt_error(cx, cX, pool, dense, st, n, index)
        ka = _kkt_error(cx, cX, pool, dense, avg, n, index)
        e_c, p_c, d_c, e_a, p_a, d_a = torch.stack([*kc, *ka]).cpu().numpy()
        use_avg = e_a < e_c
        cand = avg if use_avg else st
        err, p, d = (e_a, p_a, d_a) if use_avg else (e_c, p_c, d_c)
        if use_avg or wlen >= restart_period:
            # primal-weight rebalancing between restarts (PDLP, theta = 0.5)
            dp, dd = (torch.stack([torch.sqrt(_dist2(cand, anchor, True)),
                                   torch.sqrt(_dist2(cand, anchor, False))])
                      .cpu().numpy() + _f32(1e-12))
            omega = np.clip(np.exp(_f32(0.5) * np.log(dd / dp)
                                   + _f32(0.5) * np.log(omega)),
                            _f32(1e-4), _f32(1e4)).astype(_f32)
            st = anchor = cand
            acc, wlen = zeros, 0
        it += check_every
    return st, {"iters": it, "kkt_error": float(err), "primal_obj": float(p),
                "dual_obj": float(d), "omega": float(omega)}


@dataclasses.dataclass
class SolveSetup:
    """What a solve derives from its pool once: the blocks' route, the cut
    index and ||K||.  Steering reuses the solve's, as the pool is the same."""
    kernel: bool          # blocks through pdhg_block (else the plain loop)
    index: CutIndex
    normK: float          # a batch's: (B,) float32 numpy (solve_setup_batched)


def solve_setup(c, pool: CutPool, cfg, dense: DenseRows | None = None) -> SolveSetup:
    """The route by ``cfg.use_kernel`` (``lp/pdhg_kernel.py::kernel_route``),
    ``build_cut_index`` and ``estimate_norm`` of a solve over ``pool``."""
    from .pdhg_kernel import kernel_route

    n = int(c.shape[0])
    M, k = pool.idx.shape
    kernel = kernel_route(cfg.use_kernel, c.device, n, M, k,
                          0 if dense is None else dense.m)
    index = build_cut_index(pool, n)        # the pool is constant in a solve
    normK = estimate_norm(pool, n, cfg.power_iters,
                          torch.Generator(device="cpu").manual_seed(0), index,
                          dense)
    return SolveSetup(kernel, index, normK)


def solve_lp(Q, c, pool: CutPool, state: PDHGState, cfg,
             dense: DenseRows | None = None, setup: SolveSetup | None = None):
    """Solve the current relaxation from the warm start ``state``.

    Q, c: float32 tensors on the state's device; cfg: ``LPConfig``; dense:
    the QCQP's constraint rows, whose duals are ``state.yD``; setup:
    ``solve_setup(c, pool, cfg, dense)``, computed here when None.
    ``cfg.use_kernel`` chooses the blocks (``lp/pdhg_kernel.py::
    kernel_route``): with "auto", the iteration kernel on CUDA, dense rows or
    not, raising where its launch plan does not take (n, capacity, k, m); the
    plain loop on the CPU, or on any device with "off".  Returns (state, info); the max-form
    bound estimate is -info['dual_obj'], the certified one dual_bound_f64.
    """
    if setup is None:
        setup = solve_setup(c, pool, cfg, dense)
    return _solve_impl(-c, -0.5 * Q, pool, setup.index, state, setup.normK, cfg.omega0,
                       cfg.tol, cfg.step_scale, cfg.max_iters, cfg.check_every,
                       cfg.restart_period, dense, setup.kernel)


# ---- the instance axis: a batch of solves of one shape (parallel/round.py) ----

def estimate_norm_batched(pool: CutPool, n: int, iters: int, generator: torch.Generator,
                          index: CutIndex, dense: DenseRows | None = None):
    """``estimate_norm`` of every instance of a batch (``relax/batched.py``
    shapes) in one power iteration: each instance starts from the vector a
    single solve draws (one CPU draw from ``generator``, broadcast).
    Returns ||K|| of each instance, (B,) float32 on the device."""
    from ..relax import batched as rb

    dev = pool.lin.device
    B = pool.lin.shape[0]
    x = torch.randn((n,), generator=generator).to(dev).expand(B, n)
    X = rb.sym(torch.randn((n, n), generator=generator).to(dev).expand(B, n, n))
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


def _solve_batched(cx, cX, pool: CutPool, index: CutIndex, st0: PDHGState, normK,
                   omega0: float, tol: float, step_scale: float, max_iters: int,
                   check_every: int, restart_period: int,
                   dense: DenseRows | None = None, kernel: bool = True):
    """``_solve_impl`` for a batch of B instances of one shape: cx (B, n),
    cX (B, n, n), the other arguments with the instance axis first
    (``relax/batched.py``; ``index`` from its ``build_cut_index``), normK
    (B,) on the host.  The semantics of the reference's vmapped
    ``lax.while_loop``: every instance stops at its own tolerance or at
    ``max_iters`` and is frozen from then on; omega, the restart anchor,
    the window and the error are per instance; the loop runs while any
    instance runs.  Each checked block is one ``pdhg_block_batched`` call
    for the running instances (one K2 launch on CUDA; the per-instance plain
    loop with ``kernel`` False, counted in ``pdhg_block.plain_launches`` on
    CUDA), then one (B, 6) host read of the KKT errors and, when an instance
    restarts, one (B, 2) read of its distances.  Returns (state, info) with
    (B,) numpy arrays in info."""
    from .pdhg_kernel import pdhg_block, pdhg_block_batched, pdhg_block_batched_plain
    from ..relax import batched as rb

    block = pdhg_block_batched if kernel else pdhg_block_batched_plain
    plain_on_card = not kernel and cx.device.type == "cuda"
    B, n = cx.shape
    dev = cx.device
    eta = _f32(step_scale) / np.asarray(normK, _f32)
    zeros = st0.map(torch.zeros_like)
    st, acc, anchor = st0, zeros, st0
    wlen = np.zeros(B, np.int64)
    it = np.zeros(B, np.int64)
    omega = np.full(B, _f32(omega0), _f32)
    err = np.full(B, np.inf, _f32)
    p = np.zeros(B, _f32)
    d = np.zeros(B, _f32)
    while True:
        running = (it < max_iters) & (err / (_f32(1.0) + np.abs(p) + np.abs(d)) > _f32(tol))
        ids = np.flatnonzero(running)
        if ids.size == 0:
            break
        st, acc = block(cx, cX, pool, index, st, acc, eta / omega, eta * omega,
                        check_every, ids, dense)
        if plain_on_card:
            pdhg_block.plain_launches += 1
        wlen[ids] += check_every
        inv = np.where(wlen > 0, _f32(1.0) / np.maximum(wlen, 1).astype(_f32), _f32(0.0))
        inv_t = torch.as_tensor(inv.astype(_f32)).to(dev)
        avg = acc.map(lambda t: t * inv_t.view(-1, *[1] * (t.dim() - 1)))
        e_c, p_c, d_c, e_a, p_a, d_a = block_check(cx, cX, pool, dense, st, avg, n, index).T
        use_avg = e_a < e_c
        err[ids] = np.where(use_avg, e_a, e_c)[ids]
        p[ids] = np.where(use_avg, p_a, p_c)[ids]
        d[ids] = np.where(use_avg, d_a, d_c)[ids]
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
            st = rb.where(masks[1], cand, st)
            anchor = rb.where(masks[1], cand, anchor)
            acc = rb.where(masks[1], zeros, acc)
            wlen[restart] = 0
        it[ids] += check_every
    return st, {"iters": it, "kkt_error": err.astype(np.float64), "primal_obj": p,
                "dual_obj": d, "omega": omega}


def solve_setup_batched(c, pool: CutPool, cfg, dense: DenseRows | None = None) -> SolveSetup:
    """``solve_setup`` of a batch (c (B, n)): the route by ``cfg.use_kernel``
    at the batch's shape, ``relax.batched.build_cut_index`` and
    ``estimate_norm_batched`` (its (B,) result read to the host once)."""
    from ..relax import batched as rb
    from .pdhg_kernel import kernel_route

    n = int(c.shape[1])
    M, k = pool.idx.shape[1:]
    kernel = kernel_route(cfg.use_kernel, c.device, n, M, k,
                          0 if dense is None else dense.G.shape[1])
    index = rb.build_cut_index(pool, n)
    normK = estimate_norm_batched(pool, n, cfg.power_iters,
                                  torch.Generator(device="cpu").manual_seed(0), index, dense)
    return SolveSetup(kernel, index, normK.cpu().numpy())


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
    through K2 on CUDA (its ergodic sums are discarded).  Returns (x, X)."""
    from .pdhg_kernel import pdhg_block, pdhg_block_plain

    scale = float(eps) * (cX.abs().mean() + cx.abs().mean())
    cx_p = cx + scale * sx
    cX_p = cX + scale * _sym(SX)
    eta = _f32(step_scale) / _f32(setup.normK)
    tau, sigma = eta / _f32(omega), eta * _f32(omega)
    block = pdhg_block if setup.kernel else pdhg_block_plain
    if not setup.kernel and cx.device.type == "cuda":
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
