"""SDP relaxation bound via full-dimensional eigenvector cuts (port of
``sdpcutsel_tpu/loop/sdp_bound.py``).

The headline metric is % of the (initial McCormick bound - SDP bound) gap
closed, which needs the SDP relaxation value
max 1/2<Q,X> + c'x  s.t. McCormick, Z = [[1,x'],[x,X]] >= 0.  A cutting-plane
loop whose single candidate is the FULL index set obtains it: each round
eigendecomposes the (n+1)x(n+1) moment matrix at the LP optimum and adds one
dense cut per negative eigenvalue.  This outer polyhedral approximation
converges to the SDP bound from above; every round's value is a certified
f64 UPPER bound (``dual_bound_f64``).

The cuts are full-dimensional, so they go into a preallocated dense buffer
(``DenseRows`` of (capacity, n, n) / (capacity, n) / (capacity,) on the
device; v' Z v >= 0 expands to <u u', X> + 2 v0 u'x >= -v0^2), with an f32
host mirror that the f64 certificate, the purge and the cut generation
read, so no round copies the buffer off the device.  Three things write
rows, each as an in-place copy of only the rows written: the QCQP
constraint prefix, the seed directions and each round's new cuts.  A
round's LP solves over the first ``count`` rows (views of the buffer and of
the dense duals): zero rows are inert, so the reference sums over all
``capacity`` rows and this port over ``count``; the bits differ within
rounding.

The LP runs on the caller's device through the solve's dense route
(``lp/pdhg_kernel.py::kernel_route``): the certifier's pool holds no
sparse cut (capacity 1, width 1) and its dense rows (up to ``capacity``)
exceed what the iteration kernel K2 keeps in shared memory, so on CUDA
``LPConfig.use_kernel="auto"`` (and ``"on"``) runs the dense-row kernels of
``csrc/pdhg_dense.cu`` (``lp/pdhg_dense.py``: the block, its check and
||K||), which stream G and g from the buffer where they lie.  The reference
runs the same plain iteration as one ``lax.while_loop`` on its device.  On
the CPU, and with ``"off"`` anywhere, the plain loop runs (counted on CUDA
in ``pdhg_block.plain_launches``).

The host functions (``sdp_lower_bound``, ``bm_null_directions``,
``qcqp_rows``, ``qcqp_interior_anchor``, ``gap_closed`` and the cut
generator) are float64 numpy copies of the reference's, with its bits.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import LPConfig
from ..lp.pdhg import dual_bound_f64, init_state, solve_lp
from ..relax.cutbuffer import empty_pool
from ..relax.denserows import DenseRows, dense_from_qcqp


def _gen_dense_cuts_host(x, X, eig_tol, m_max):
    """Eigencut rows at (x, X) in host f64: LAPACK dsyev at (n+1) <= 126
    costs milliseconds, and f64 eigenvectors give slightly deeper cuts.
    Returns (rows | None, lam_min) with rows = (G, g, h) f32 arrays ready for
    both the device buffer and the host mirror."""
    n = x.shape[0]
    Z = np.empty((n + 1, n + 1))
    Z[0, 0] = 1.0
    Z[0, 1:] = x
    Z[1:, 0] = x
    Z[1:, 1:] = X
    w, V = np.linalg.eigh(Z)
    lam_min = float(w[0])
    neg = np.nonzero(w < -eig_tol)[0][:m_max]
    if neg.size == 0:
        return None, lam_min
    v0 = V[0, neg]
    U = V[1:, neg]
    G = U.T[:, :, None] * U.T[:, None, :]
    g = 2.0 * v0[:, None] * U.T
    h = -(v0 ** 2)
    nrm = np.sqrt((G**2).sum((1, 2)) + (g**2).sum(1)) + 1e-30
    return ((G / nrm[:, None, None]).astype(np.float32),
            (g / nrm[:, None]).astype(np.float32),
            (h / nrm).astype(np.float32)), lam_min


def _seed_rows(seed_dirs):
    """v v' >= 0 rows, normalized, for the (q, n+1) directions ``seed_dirs``
    (f64; the caller truncates and rounds to f32)."""
    Vs = np.asarray(seed_dirs, np.float64)
    v0s, Us = Vs[:, 0], Vs[:, 1:]
    Gm = Us[:, :, None] * Us[:, None, :]
    gm = 2.0 * v0s[:, None] * Us
    hm = -(v0s ** 2)
    nrm = np.sqrt((Gm**2).sum((1, 2)) + (gm**2).sum(1)) + 1e-30
    return Gm / nrm[:, None, None], gm / nrm[:, None], hm / nrm


class _DenseBuffer:
    """The eigencut loop's dense rows: the device buffer (``rows``), its f32
    host mirror (``mirror``) and the dense duals (``yD``, on the device),
    all at ``capacity``; rows [0, count) are live and the rest zero."""

    def __init__(self, n: int, capacity: int, device):
        self.capacity = capacity
        self.rows = DenseRows(G=torch.zeros((capacity, n, n), device=device),
                              g=torch.zeros((capacity, n), device=device),
                              h=torch.zeros((capacity,), device=device))
        self.mirror = (np.zeros((capacity, n, n), np.float32),
                       np.zeros((capacity, n), np.float32),
                       np.zeros((capacity,), np.float32))
        self.yD = torch.zeros((capacity,), device=device)
        self.count = 0

    def append(self, G, g, h) -> int:
        """Write f32 rows at [count, count + q) of the mirror and the device
        buffer (q clipped to the free rows); returns q."""
        c0 = self.count
        q = min(G.shape[0], self.capacity - c0)
        if q <= 0:
            return 0
        for dst, src in zip(self.mirror, (G, g, h)):
            dst[c0:c0 + q] = src[:q]
        for dst, src in zip((self.rows.G, self.rows.g, self.rows.h), self.mirror):
            dst[c0:c0 + q].copy_(torch.from_numpy(src[c0:c0 + q]))
        self.count = c0 + q
        return q

    def live(self) -> DenseRows:
        """Views of rows [0, count) of the device buffer."""
        c = self.count
        return DenseRows(G=self.rows.G[:c], g=self.rows.g[:c], h=self.rows.h[:c])

    def live_mirror(self):
        c = self.count
        return tuple(a[:c] for a in self.mirror)


def _purge_dense_rows(buf: _DenseBuffer, x, X, m0: int):
    """Compaction of the dense cut buffer: keep the QCQP prefix [0, m0) plus
    every cut that is near-active at the current LP point (small slack) or
    carries dual weight; compact survivors to the front and permute the
    warm-start duals to match.  Shallow stale cuts otherwise saturate the
    fixed-capacity buffer and freeze the bound.  The ranking reads the host
    mirror (f64) at the LP point (x, X) (f64 numpy); the kept rows are then
    written in place, on the host and on the device, and the tail zeroed.
    Rows [0, m0) (the QCQP prefix and the seed rows) always survive."""
    count = buf.count
    Gm, gm, hm = buf.mirror
    G = Gm[:count].astype(np.float64)
    g = gm[:count].astype(np.float64)
    h = hm[:count].astype(np.float64)
    yD = buf.yD.cpu().numpy().astype(np.float64)
    idx = np.arange(count)
    slack = np.einsum("mij,ij->m", G, X) + g @ x - h
    dual = yD[:count]
    # hard budget: PDHG duals are smeared (no simplex-style sparsity), so a
    # threshold rule keeps everything; instead RANK by near-activity with a
    # dual-weight bonus and keep the best `target` rows
    target = max(m0, int(0.6 * count))
    sn = slack / max(1e-12, float(slack.std()))
    dn = dual / max(1e-12, float(dual.std()))
    score = sn - dn
    score[:m0] = -np.inf                      # QCQP prefix always survives
    kept = idx[np.argsort(score, kind="stable")[:target]]
    kept.sort()
    k = len(kept)
    for a in buf.mirror:
        a[:k] = a[kept]
        a[k:count] = 0
    kept_dev = torch.as_tensor(kept, device=buf.yD.device)
    for t in (buf.rows.G, buf.rows.g, buf.rows.h, buf.yD):
        t[:k] = t[kept_dev]
        t[k:count] = 0
    buf.count = k


def _clock(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def sdp_relaxation_bound(
    inst,
    lp_cfg: LPConfig | None = None,
    max_rounds: int = 120,
    eig_tol: float = 1e-4,
    capacity: int = 1024,
    device="cuda",
    verbose: bool = False,
    stall_tol: float = 5e-5,
    stall_rounds: int = 5,
    with_point: bool = False,
    anchor=None,
    max_cuts_per_round: int = 10**9,
    purge_at: int | None = None,
    seed_dirs=None,
    final_polish: bool = False,
    stop_below: float | None = None,
):
    """Returns (sdp_bound, initial_relaxation_bound, history list); with
    with_point=True additionally the final LP point (x, X) as f64 numpy —
    the input to ``sdp_lower_bound``'s independent validation.  The LP runs
    in float32 on ``device``.

    Accepts a BoxQP instance (Q, c) or a QCQP instance (Q0, c0, constraint
    rows become a prefix of the eigencut buffer).  No purge removes the
    prefix or the seed rows.

    ``anchor=(x_in, X_in)``: in-out separation (Ben-Ameur & Neto style).
    Plain eigencut stalls at large n: cuts generated AT the LP optimum stop
    improving the bound while lambda_min(Z*) is still ~-1.  With a deep
    PSD-interior anchor — the Burer-Monteiro near-optimal primal point
    (sdp_primal.py) is ideal — cuts are instead generated at the blend
    (1-beta) z_LP + beta z_anchor, which supports the cone much closer to
    the feasible region.  beta adapts: shrinks when the blend is already
    PSD, grows after cuts succeed.  The reported bound is always the LP's
    f64 certificate, valid wherever the cuts were generated.

    Each history entry holds the reference's keys and ``seconds``: the
    round's host-clock split into ``lp`` (the solve), ``certificate``
    (``dual_bound_f64``), ``purge``, ``host_cuts`` (eigh and row
    generation on the host) and ``upload`` (the new rows' copies)."""
    lp_cfg = lp_cfg or LPConfig()
    device = torch.device(device)
    n = inst.n
    is_qcqp = hasattr(inst, "Q0")
    Qnp = inst.Q0 if is_qcqp else inst.Q
    cnp = inst.c0 if is_qcqp else inst.c
    Q = torch.as_tensor(np.asarray(Qnp), dtype=torch.float32, device=device)
    c = torch.as_tensor(np.asarray(cnp), dtype=torch.float32, device=device)

    pool = empty_pool(1, 1, device)          # no sparse cuts in this loop
    buf = _DenseBuffer(n, capacity, device)
    if is_qcqp and inst.m > 0:
        qrows = dense_from_qcqp(inst.Qs, inst.cs, inst.bs, "cpu")
        buf.append(*(t.numpy() for t in (qrows.G, qrows.g, qrows.h)))
    if seed_dirs is not None:
        # Pre-seed the buffer with v v' >= 0 rows for given (n+1)-vectors:
        # by complementary slackness the optimal SDP dual S has range inside
        # null(Z*) of the (near-)optimal primal, so seeding the
        # Burer-Monteiro solution's bottom eigenvectors (and their pairwise
        # sums) lets the LP dual express the near-optimal S immediately.
        # Every seeded row is a valid cut: only convergence speed changes.
        sG, sg, sh = _seed_rows(seed_dirs)
        q = max(0, min(sG.shape[0], capacity - buf.count - 64))
        buf.append(sG[:q].astype(np.float32), sg[:q].astype(np.float32),
                   sh[:q].astype(np.float32))
    state = init_state(n, 1, device, m=capacity)

    if anchor is not None:
        x_in = np.asarray(anchor[0], np.float64)
        X_in = np.asarray(anchor[1], np.float64)
        beta = 0.5
    m0 = buf.count           # QCQP prefix and seed rows: never purged

    def solve(cfg):
        """One LP over the live rows, warm-started; the dense duals are
        written back into the full-capacity ``buf.yD``."""
        nonlocal state
        live = dataclasses.replace(state, yD=buf.yD[:buf.count])
        st, info = solve_lp(Q, c, pool, live, cfg, dense=buf.live())
        buf.yD[:buf.count] = st.yD
        state = dataclasses.replace(st, yD=buf.yD)
        return info

    history = []
    bound0 = None
    seconds = {}

    def append_rows(rows):
        t0 = time.perf_counter()
        buf.append(*rows)
        seconds["upload"] += _clock(device) - t0

    def gen_cuts(xv, Xv):
        t0 = time.perf_counter()
        out = _gen_dense_cuts_host(xv, Xv, eig_tol, max_cuts_per_round)
        seconds["host_cuts"] += time.perf_counter() - t0
        return out

    for r in range(max_rounds):
        seconds = dict.fromkeys(("lp", "certificate", "purge", "host_cuts", "upload"), 0.0)
        t0 = _clock(device)
        info = solve(lp_cfg)
        t1 = time.perf_counter()
        seconds["lp"] = t1 - t0
        bound = dual_bound_f64(Qnp, cnp, pool, state, dense_np=buf.live_mirror())
        t2 = time.perf_counter()
        seconds["certificate"] = t2 - t1
        if bound0 is None:
            bound0 = bound
        x_np = state.x.cpu().numpy().astype(np.float64)
        X_np = state.X.cpu().numpy().astype(np.float64)
        if purge_at is not None and buf.count > purge_at:
            _purge_dense_rows(buf, x_np, X_np, m0)
            seconds["purge"] = _clock(device) - t2
        if anchor is not None:
            # in-out: separate at the blend toward the interior anchor; if
            # the blend is PSD (no cut), shrink beta toward the LP point
            for _ in range(8):
                xs = (1.0 - beta) * x_np + beta * x_in
                Xs = (1.0 - beta) * X_np + beta * X_in
                rows_new, lam_min = gen_cuts(xs, Xs)
                if lam_min < -eig_tol:
                    append_rows(rows_new)
                    beta = min(beta * 1.3, 0.9)
                    break
                beta *= 0.5
            else:
                # even the (near-)LP point separates nothing: converged.
                # Reset beta — 8 halvings left it ~0.004, and with only
                # x1.3/round recovery one such round would degrade in-out
                # to plain eigencut for ~20 rounds.
                beta = 0.5
                rows_new, lam_min = gen_cuts(x_np, X_np)
                if rows_new is not None:
                    append_rows(rows_new)
        else:
            rows_new, lam_min = gen_cuts(x_np, X_np)
            if rows_new is not None:
                append_rows(rows_new)
        history.append({"round": r, "bound": bound, "lam_min": lam_min,
                        "cuts": buf.count, "lp_iters": int(info["iters"]),
                        "lp_kkt": float(info["kkt_error"]), "seconds": seconds})
        if verbose:
            print(f"[sdp_bound] round {r}: bound={bound:.6f} "
                  f"lam_min={lam_min:.2e} cuts={buf.count} "
                  f"lp_iters={int(info['iters'])} "
                  f"kkt={float(info['kkt_error']):.2e}", flush=True)
        if lam_min >= -eig_tol:
            break
        # Each round's bound is an INDEPENDENTLY certified upper bound
        # (f64 dual certificate), so the running MIN is too — and purging
        # can make later rounds non-monotone, so best-so-far is the value
        # to both report and stall-test.
        best = min(h["bound"] for h in history)
        if stop_below is not None and best <= stop_below:
            break   # caller's tightness target reached — budget the rest
        if len(history) > stall_rounds:
            prev_best = min(h["bound"] for h in history[: -stall_rounds])
            if prev_best - best <= stall_tol * (1.0 + abs(best)):
                break

    # Final polish: the per-round LPs stop at kkt ~1e-2 under the iteration
    # budget, and the f64 certificate pays for dual infeasibility; one long
    # tight re-solve over the final buffer recovers that at the cost of a
    # single extra solve.  The polished value is one more valid certificate,
    # so the running min absorbs it.
    if final_polish and history:
        tight = dataclasses.replace(lp_cfg, max_iters=lp_cfg.max_iters * 4,
                                    tol=lp_cfg.tol * 1e-2)
        t0 = _clock(device)
        info = solve(tight)
        t1 = time.perf_counter()
        b = dual_bound_f64(Qnp, cnp, pool, state, dense_np=buf.live_mirror())
        history.append({"round": len(history), "bound": b,
                        "lam_min": float("nan"), "cuts": buf.count,
                        "lp_iters": int(info["iters"]),
                        "lp_kkt": float(info["kkt_error"]),
                        "polish": True,
                        "seconds": {"lp": t1 - t0,
                                    "certificate": time.perf_counter() - t1}})
        if verbose:
            print(f"[sdp_bound] polish: bound={b:.6f} "
                  f"iters={int(info['iters'])} "
                  f"kkt={float(info['kkt_error']):.2e}", flush=True)

    best = min(h["bound"] for h in history)
    if with_point:
        point = (state.x.cpu().numpy().astype(np.float64),
                 state.X.cpu().numpy().astype(np.float64))
        return best, bound0, history, point
    return best, bound0, history


def bm_null_directions(x, X, max_dirs: int = 320, tol_frac: float = 0.02):
    """Seed directions for ``sdp_relaxation_bound(seed_dirs=...)`` from a
    near-optimal primal point: the bottom eigenvectors of Z(x, X) (the
    optimal dual S's range, by complementary slackness) plus their pairwise
    sums/differences — the rank-1 matrices of one eigenbasis alone do not
    span the symmetric square of the null space."""
    n = x.shape[0]
    Z = np.empty((n + 1, n + 1))
    Z[0, 0] = 1.0
    Z[0, 1:] = x
    Z[1:, 0] = x
    Z[1:, 1:] = X
    w, V = np.linalg.eigh(Z)
    thresh = tol_frac * max(w[-1], 1e-12)
    q = int(np.sum(w < thresh))
    q = max(q, 2)
    base = V[:, :q].T                                  # (q, n+1)
    dirs = [base]
    for i in range(q):
        for j in range(i + 1, q):
            dirs.append((base[i] + base[j])[None, :] / np.sqrt(2.0))
            dirs.append((base[i] - base[j])[None, :] / np.sqrt(2.0))
    out = np.concatenate(dirs, axis=0)
    return out[:max_dirs]


def sdp_lower_bound(Q, c, x, X, gamma: float = 0.2,
                    repair_iters: int = 30, rows=None,
                    anchor=None) -> float:
    """Independent f64 LOWER bound on the SDP relaxation value from a
    constructed feasible point: the eigencut loop's stall-stop yields a
    certified UPPER bound that could stop too high, silently shrinking every
    gap-closed denominator — this certificate bounds that error from the
    other side.

    Construction: (1) repair the final LP point (x*, X*) to exact McCormick
    feasibility (entrywise clip of X into [max(0, x_i+x_j-1), min(x_i, x_j)]
    — the box is symmetric, so symmetry survives); (2) take the strictly
    PSD-interior McCormick point x0 = 0.5*1, X0 = 0.25*11' + gamma*I; (3)
    lambda_min of Z(alpha) = (1-alpha) Z* + alpha Z0 is concave in alpha, so
    bisection finds the smallest alpha with Z(alpha) PSD; the affine
    combination stays McCormick-feasible, and its objective is a valid lower
    bound on the SDP max.

    The raw LP point can sit far outside the PSD cone, forcing a large
    anchor blend that craters the objective.  So we ALSO run alternating
    projections on X with x held fixed — Schur: Z ⪰ 0 iff M = X - xx' ⪰ 0,
    alternate eigenvalue-clipping M into the PSD cone with clipping X back
    into the McCormick box — and certify the blend from each iterate; every
    blend is a valid lower bound regardless of projection convergence, so
    the returned max is too.

    ``rows=(Gs, gs, bs)``: additional linear constraints
    <G_i, X> + g_i'x <= b_i (the QCQP lifted constraint rows).  The blend
    predicate then also requires every row satisfied; each row is affine in
    alpha and strictly satisfied at the anchor, so the feasible alpha-set is
    an interval containing 1 and bisection stays valid.  A strictly
    row-feasible ``anchor=(x_a, X_a)`` is REQUIRED with rows (the default
    0.5/0.25 anchor knows nothing about them); anchor feasibility is
    asserted so an invalid anchor fails loudly instead of producing a wrong
    certificate."""
    Q = np.asarray(Q, np.float64)
    c = np.asarray(c, np.float64)
    n = c.shape[0]
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
    X = 0.5 * (X + X.T)
    lo = np.maximum(0.0, x[:, None] + x[None, :] - 1.0)
    hi = np.minimum(x[:, None], x[None, :])
    X = np.clip(np.asarray(X, np.float64), lo, hi)

    def Zof(xv, Xv):
        Z = np.empty((n + 1, n + 1))
        Z[0, 0] = 1.0
        Z[0, 1:] = xv
        Z[1:, 0] = xv
        Z[1:, 1:] = Xv
        return Z

    if anchor is not None:
        x0 = np.asarray(anchor[0], np.float64)
        X0 = np.asarray(anchor[1], np.float64)
        lo0 = np.maximum(0.0, x0[:, None] + x0[None, :] - 1.0)
        hi0 = np.minimum(x0[:, None], x0[None, :])
        assert (X0 >= lo0 - 1e-12).all() and (X0 <= hi0 + 1e-12).all(), (
            "interior anchor must be McCormick-feasible")
    else:
        if rows is not None:
            raise ValueError(
                "rows without a row-feasible anchor: the default interior "
                "anchor does not satisfy arbitrary QCQP rows")
        x0 = np.full(n, 0.5)
        X0 = np.full((n, n), 0.25) + gamma * np.eye(n)
    Z0 = Zof(x0, X0)
    assert np.linalg.eigvalsh(Z0)[0] > 0, "interior anchor must be PSD"
    if rows is not None:
        Gs = np.asarray(rows[0], np.float64)
        gs = np.asarray(rows[1], np.float64)
        bs = np.asarray(rows[2], np.float64)

        def row_viol(xv, Xv):
            return (np.einsum("mij,ij->m", Gs, Xv) + gs @ xv - bs).max()

        assert row_viol(x0, X0) < 0.0, (
            "interior anchor must strictly satisfy the QCQP rows")

    def blend_bound(xv, Xv):
        Zs = Zof(xv, Xv)

        def feasible(alpha):
            if np.linalg.eigvalsh((1 - alpha) * Zs + alpha * Z0)[0] < 0.0:
                return False
            if rows is not None:
                xa = (1 - alpha) * xv + alpha * x0
                Xa = (1 - alpha) * Xv + alpha * X0
                if row_viol(xa, Xa) > 0.0:
                    return False
            return True

        if feasible(0.0):
            alpha = 0.0
        else:
            a, b = 0.0, 1.0  # feasible(1) holds strictly
            for _ in range(60):
                mid = 0.5 * (a + b)
                if feasible(mid):
                    b = mid
                else:
                    a = mid
            alpha = min(b + 1e-9, 1.0)
        xa = (1 - alpha) * xv + alpha * x0
        Xa = (1 - alpha) * Xv + alpha * X0
        return float(0.5 * np.sum(Q * Xa) + c @ xa)

    best = blend_bound(x, X)
    Xr = X
    for it in range(repair_iters):
        M = Xr - np.outer(x, x)
        w, V = np.linalg.eigh(M)
        if w[0] >= -1e-12:
            best = max(best, blend_bound(x, Xr))
            break
        M = (V * np.maximum(w, 0.0)) @ V.T
        Xr = np.clip(np.outer(x, x) + M, lo, hi)
        Xr = 0.5 * (Xr + Xr.T)
        # certify intermediate iterates sparsely (each blend costs ~60 eighs)
        if it % 10 == 9:
            best = max(best, blend_bound(x, Xr))
    else:
        best = max(best, blend_bound(x, Xr))
    return best


def qcqp_rows(inst):
    """The QCQP's lifted linear rows <Q_i/2, X> + c_i'x <= b_i as stacked
    arrays for the BM solver / blend certificate."""
    Gs = np.stack([0.5 * np.asarray(Qi, np.float64) for Qi in inst.Qs])
    gs = np.stack([np.asarray(ci, np.float64) for ci in inst.cs])
    bs = np.asarray(inst.bs, np.float64)
    return Gs, gs, bs


def qcqp_interior_anchor(inst, gammas=(0.1, 0.03, 0.01, 0.003, 0.001)):
    """Strictly feasible interior anchor for a QCQP: x0 = 0.25*1 (the point
    the generator guarantees constraint slack at — instances/qcqp.py), X0 =
    x0 x0' + gamma I.  Z0 is then PSD (Schur: X0 - x0 x0' = gamma I), X0 is
    strictly inside the McCormick box (off-diag 0.0625 in (0, 0.25)), and
    gamma shrinks until every row keeps strict slack.  Raises if none of the
    gammas work (an instance whose constraints are tight at x0 — not
    produced by our generator)."""
    n = inst.n
    x0 = np.full(n, 0.25)
    Gs, gs, bs = qcqp_rows(inst)
    base = np.einsum("mij,ij->m", Gs, np.outer(x0, x0)) + gs @ x0 - bs
    for gamma in gammas:
        viol = base + gamma * np.trace(Gs, axis1=1, axis2=2)
        if viol.max() < -1e-9:
            return x0, np.outer(x0, x0) + gamma * np.eye(n)
    raise ValueError("no strictly feasible interior anchor found; "
                     f"best row slack {viol.max():.3e}")


def validate_sdp_bound(inst, lp_cfg: LPConfig | None = None,
                       max_rounds: int = 120, **kw):
    """Sandwich the SDP value: (upper, lower, rel_width) where upper is the
    eigencut-loop certificate and lower the independent feasible-point bound.
    rel_width bounds the error the stall-based early stop can introduce into
    the gap-closed denominator.  ``kw`` goes to ``sdp_relaxation_bound``
    (``device`` among them).

    Handles BOTH problem families: BoxQP directly; QCQP by joining the
    lifted constraint rows into the BM augmented Lagrangian and requiring
    the certificate blend to satisfy them (row-feasible interior anchor
    from qcqp_interior_anchor)."""
    from .sdp_primal import bm_feasible_point

    # Tight lower end: Burer-Monteiro primal ascent, certified by the
    # interior-anchor blend.  The SAME near-optimal point then anchors the
    # in-out eigencut loop, which converges far past the plain loop's stall.
    if hasattr(inst, "Q0"):
        rows = qcqp_rows(inst) if inst.m > 0 else None
        anchor0 = qcqp_interior_anchor(inst) if inst.m > 0 else None
        x_in, X_in, lb = bm_feasible_point(inst.Q0, inst.c0, rows=rows,
                                           anchor=anchor0)
    else:
        x_in, X_in, lb = bm_feasible_point(inst.Q, inst.c)
    # The accelerated defaults: seed the buffer with the BM solution's
    # null-space directions, take more eigencut directions per round into a
    # larger buffer.
    kw.setdefault("max_cuts_per_round", 48)
    kw.setdefault("capacity", 2048)
    kw.setdefault("purge_at", 1500)
    kw.setdefault("stall_tol", 1e-5)
    kw.setdefault("stall_rounds", 15)
    kw.setdefault("seed_dirs", bm_null_directions(x_in, X_in))
    kw.setdefault("final_polish", True)
    ub, _, _ = sdp_relaxation_bound(
        inst, lp_cfg, max_rounds=max_rounds, anchor=(x_in, X_in), **kw)
    rel = (ub - lb) / (1.0 + abs(ub))
    return ub, lb, rel


def gap_closed(bound0: float, sdp: float, bounds) -> np.ndarray:
    """% of (bound0 - sdp) gap closed per round, clipped to [0, 1]."""
    denom = max(bound0 - sdp, 1e-12)
    return np.clip((bound0 - np.asarray(bounds)) / denom, 0.0, 1.0)
