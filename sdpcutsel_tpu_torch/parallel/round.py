"""The instance-batched cutting-plane round (port of
``sdpcutsel_tpu/parallel/round.py``).

B instances of one n are solved together.  The reference ran its
single-instance round under ``jax.vmap`` inside a ``shard_map`` over the
mesh ('data', 'cand'); here every step is one set of tensor operations over
the instance axis (``relax/batched.py``), on a mesh (``parallel/mesh.py``).
On one process the mesh is logical: 'data' must divide B, and 'cand' splits
the candidate table into contiguous shards, all scored here.  On a
distributed mesh a rank holds the instances of its 'data' shard
(``shard_batched_state``) and its 'cand' shard of the table
(``sharding.shard_candidates``), scores only that shard, and gathers the
winners over its 'cand' group; the LP and the cut update run, replicated,
on every rank of the group, as in the reference's ``shard_map``.  A rank's
round is then bit for bit the one-process round of its 'data' shard's
instances at the logical ``Mesh(1, cand)``.  One round, for every instance:
  1. ``solve_setup_batched``: the batched cut index and one power iteration
     for every instance's ||K|| (``lp/pdhg.py``);
  2. the warm-started restarted PDHG, ``_solve_batched``: one K2 launch a
     checked block for every instance still running (converged ones are
     frozen), one host read of the KKT errors a block;
  3. the on-device f32 certificate (bound, and its running minimum);
  4. every shard scores its rows at the solved point and keeps a local top
     ``sel_size`` (ties to the lower row): neural, feasibility, combined
     through K1 (k = 3, ``ops/pair_score.py``) or K4 (any other k,
     ``ops/fused_score.py``), one launch per instance and shard, with 5
     Jacobi sweeps for neural and 6 for feasibility and combined (the
     reference's CPU route); ``pair_layout=True`` scores the pair layout's
     rows (``sharding.shard_pair_candidates``) through K1 with 5 sweeps for
     all three; random draws uniform [0, 1) scores from the instance's own
     CPU generator;
  5. the shards' winners are gathered in shard order (``gather_cand``) and
     the global pick is the support-diverse greedy (``diversity_alpha`` >
     0) or a plain top-k over them: the sharded rule, which differs from
     ``CutSolver``'s selection over the whole table;
  6. eigh of the picks' Z(rho), unit-norm cut rows; purge slack cuts, then
     append the new rows.
``use_fused=False`` scores with the kernels' plain twins on either device
(counted on CUDA in ``pair_score.plain_launches`` / ``fused_score.
plain_launches``), as ``LPConfig(use_kernel="off")`` asks for the plain
PDHG loop.  The scan step runs the same round ``rounds`` times and stacks,
per round, the pool each LP was solved on and the solve's duals, so that
``certify_scan_f64`` certifies every round afterwards in f64 on the host.

Randomness (strategy random): each instance has its own CPU
``torch.Generator`` (``init_batched_state``: seeds drawn from one generator
seeded with ``seed``).  A round draws, for each instance, its shards' scores
in shard order, one float a row of the padded table; a distributed rank
draws every shard's and keeps its own, so the stream is the one-process
stream.  The stream is not the reference's ``jax.random`` one.  A step
copies the generators, so the state it was given is left as it was.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import CutConfig, LPConfig, RunConfig, ScorerConfig
from ..cuts.assemble import assemble_Z
from ..cuts.generate import cuts_from_selected
from ..lp.pdhg import (PDHGState, _dual_bound_batched, _solve_batched, dual_bound_f64,
                       init_state, solve_setup_batched)
from ..loop.solver import KERNEL_SCORED, LEX_SWEEPS
from ..models.features import candidate_q_features
from ..models.scorer import MLPScorer, load_params
from ..ops.fused_score import fused_score, fused_score_plain
from ..ops.pair_score import SWEEPS, pair_score, pair_score_plain
from ..ops.topk import diverse_topk, masked_topk
from ..relax import batched as rb
from ..relax.cutbuffer import CutPool
from ..relax.denserows import DenseRows
from .mesh import Mesh
from .sharding import gather_cand, local_shards, local_topk


@dataclasses.dataclass
class BatchedRoundState:
    """The batch's state; every tensor has the instance axis B first."""
    Q: torch.Tensor          # (B, n, n)
    c: torch.Tensor          # (B, n)
    pool: CutPool            # fields (B, M, ...), count (B,)
    pdhg: PDHGState          # fields (B, ...)
    generators: list         # B CPU torch.Generator (strategy random)
    bound: torch.Tensor      # (B,) this round's on-device f32 certificate (max form)
    best_bound: torch.Tensor  # (B,) running minimum of the certificates


def empty_batched_dense(B: int, n: int, m: int = 0, device="cuda") -> DenseRows:
    """A batched dense block of m all-zero (inert) rows."""
    return DenseRows(G=torch.zeros((B, m, n, n), device=device),
                     g=torch.zeros((B, m, n), device=device),
                     h=torch.zeros((B, m), device=device))


def _generators(seed: int, B: int) -> list:
    parent = torch.Generator(device="cpu").manual_seed(seed)
    seeds = torch.randint(0, 2 ** 62, (B,), generator=parent).tolist()
    return [torch.Generator(device="cpu").manual_seed(s) for s in seeds]


def init_batched_state(Qb, cb, capacity: int, kmax: int, m_dense: int = 0, seed: int = 0,
                       device="cuda") -> BatchedRoundState:
    """The state before round 0: empty pools, the PDHG start point, bounds
    +inf.  Qb (B, n, n), cb (B, n): arrays or tensors, stored as float32."""
    def f32(a):
        a = a if isinstance(a, torch.Tensor) else np.asarray(a)
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    Q, c = f32(Qb), f32(cb)
    B, n = c.shape
    inf = torch.full((B,), torch.inf, device=device)
    return BatchedRoundState(
        Q=Q, c=c, pool=rb.empty_pool(B, capacity, kmax, device),
        pdhg=rb.stack([init_state(n, capacity, device, m_dense)] * B),
        generators=_generators(seed, B), bound=inf, best_bound=inf.clone())


def batched_state_from_numpy(leaves, seed: int = 0, device="cuda") -> BatchedRoundState:
    """A state holding the arrays of ``leaves``: any object with the
    reference's ``BatchedRoundState`` attributes (Q, c, pool with idx, lin,
    quad, rhs, active, count, pdhg with x, X, yA, yB, yC, yD, bound,
    best_bound) as numpy arrays, e.g. ``jax.tree.map(np.asarray, state)``.
    The reference's PRNG keys have no counterpart: the generators are
    ``init_batched_state``'s for ``seed``.  Lets both packages start a round
    from one state."""

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    pool = CutPool(*(t(getattr(leaves.pool, f), torch.int64 if f in ("idx", "count") else
                       torch.float32) for f in ("idx", "lin", "quad", "rhs", "active", "count")))
    pdhg = PDHGState(*(t(getattr(leaves.pdhg, f)) for f in ("x", "X", "yA", "yB", "yC", "yD")))
    return BatchedRoundState(t(leaves.Q), t(leaves.c), pool, pdhg,
                             _generators(seed, pool.count.shape[0]), t(leaves.bound),
                             t(leaves.best_bound))


def _copy_generator(g: torch.Generator) -> torch.Generator:
    out = torch.Generator(device="cpu")
    out.set_state(g.get_state())
    return out


@dataclasses.dataclass
class _Round:
    """What a step fixes when it is built."""
    mesh: Mesh
    lp: LPConfig
    cuts: CutConfig
    strategy: str
    kmax: int
    m_dense: int
    use_fused: bool
    pair_layout: bool
    mlp: Optional[MLPScorer] = None
    sweeps: int = SWEEPS

    def scores(self, state: BatchedRoundState, x, X, table, gens, qfeat) -> torch.Tensor:
        """(B, Ts): every instance's scores of one shard's rows."""
        B, T = x.shape[0], table.shape[0]
        if self.strategy == "random":
            # a distributed rank draws every shard's floats, in shard order,
            # and keeps its own: the one-process stream
            draws = [torch.stack([torch.rand((T,), generator=g) for g in gens])
                     for _ in range(self.mesh.cand if self.mesh.distributed else 1)]
            return draws[self.mesh.cand_index].to(x.device)
        out = []
        card = x.device.type == "cuda"
        for b in range(B):
            if self.pair_layout or self.kmax == 3:
                fn = pair_score if self.use_fused else pair_score_plain
                nn, feas = fn(x[b], X[b], state.Q[b], table, self.mlp, self.sweeps)
                if card and not self.use_fused:
                    pair_score.plain_launches += 1
            else:
                fn = fused_score if self.use_fused else fused_score_plain
                nn, feas = fn(x[b], X[b], table, qfeat[0][b], qfeat[1][b], self.mlp,
                              self.sweeps)
                if card and not self.use_fused:
                    fused_score.plain_launches += 1
            if self.strategy == "feasibility":
                out.append(feas)
            elif self.strategy == "combined":
                out.append(torch.where(feas > 0.0, nn, torch.full_like(nn, -torch.inf)))
            else:
                out.append(nn)
        return torch.stack(out)

    def select(self, state: BatchedRoundState, x, X, table, valid, gens):
        """Local top-k of every shard, gathered in shard order, then the
        global pick.  Returns (picked rows (B, S, k), valid (B, S))."""
        B, n = x.shape
        S = self.cuts.sel_size
        q_features = self.strategy != "random" and not self.pair_layout and self.kmax != 3
        won = []
        for tab, val in local_shards(table, valid, self.mesh):
            qf = candidate_q_features(state.Q, tab) if q_features else None    # row by row
            won.append(local_topk(self.scores(state, x, X, tab, gens, qf), val, tab, S))
        gv = gather_cand([w[0] for w in won], 1, self.mesh)       # (B, cand S)
        gr = gather_cand([w[1] for w in won], 1, self.mesh)       # (B, cand S, k)
        if self.cuts.diversity_alpha > 0.0:
            _, i, ok = diverse_topk(gv, gr, S, self.cuts.diversity_alpha)
        else:
            _, i, ok = masked_topk(gv, S)
        return torch.gather(gr, 1, i[..., None].expand(B, S, gr.shape[-1])).long(), ok

    def prepare(self, state: BatchedRoundState, table, valid, dense):
        """The round's arguments on the state's device, with the inert dense
        block of ``m_dense`` rows when ``dense`` is None (none at all for
        m_dense = 0)."""
        dev = state.c.device
        if self.mlp is not None and next(self.mlp.parameters()).device != dev:
            self.mlp = self.mlp.to(dev)
        if dense is None and self.m_dense:
            B, n = state.c.shape
            dense = empty_batched_dense(B, n, self.m_dense, dev)
        return table.to(dev), valid.to(dev), dense

    def __call__(self, state: BatchedRoundState, table, valid, dense):
        """One round of every instance.  Returns (new state, info)."""
        B, n = state.c.shape
        if B % self.mesh.data and not self.mesh.distributed:
            raise ValueError(f"mesh data={self.mesh.data} does not divide the batch B={B}")
        cx, cX = -state.c, -0.5 * state.Q
        lp = self.lp
        setup = solve_setup_batched(state.c, state.pool, lp, dense)
        st, info = _solve_batched(cx, cX, state.pool, setup.index, state.pdhg, setup.normK,
                                  lp.omega0, lp.tol, lp.step_scale, lp.max_iters,
                                  min(lp.check_every, lp.max_iters), lp.restart_period,
                                  dense, setup.kernel)
        bound = -_dual_bound_batched(cx, cX, state.pool, dense, st, n, setup.index)
        best = torch.minimum(state.best_bound, bound)
        gens = [_copy_generator(g) for g in state.generators]
        idx_sel, sel_valid = self.select(state, st.x, st.X, table, valid, gens)
        S, k = idx_sel.shape[1:]
        w, V = torch.linalg.eigh(assemble_Z(st.x, st.X, idx_sel))
        rows = cuts_from_selected(idx_sel.reshape(B * S, k), w.reshape(B * S, k + 1),
                                  V.reshape(B * S, k + 1, k + 1), self.cuts.viol_tol,
                                  sel_valid=sel_valid.reshape(-1))
        rows = [r.reshape(B, S * (k + 1), *r.shape[1:]) for r in rows]
        pool, yC = state.pool, st.yC
        if self.cuts.purge:
            slack = rb.cut_residuals(st.x, st.X, pool)
            pool, yC = rb.purge_pool(pool, yC, slack, self.cuts.purge_slack_tol)
        pool = rb.append_cuts(pool, *rows)
        info = {"lp_iters": info["iters"], "kkt_error": info["kkt_error"], "yC_solve": st.yC}
        new = BatchedRoundState(state.Q, state.c, pool, dataclasses.replace(st, yC=yC), gens,
                                bound, best)
        return new, info


def _build_round(mesh: Mesh, cfg: Optional[RunConfig], lp_iters, sel_size, viol_tol,
                 strategy, use_fused, m_dense, kmax, pair_layout) -> _Round:
    cfg = cfg or RunConfig()
    lp = cfg.lp if lp_iters is None else dataclasses.replace(cfg.lp, max_iters=lp_iters)
    cuts = cfg.cuts
    if sel_size is not None:
        cuts = dataclasses.replace(cuts, sel_size=sel_size)
    if viol_tol is not None:
        cuts = dataclasses.replace(cuts, viol_tol=viol_tol)
    scorer: ScorerConfig = cfg.scorer
    strat = scorer.strategy if strategy is None else strategy
    if pair_layout and strat not in KERNEL_SCORED:
        raise ValueError(f"pair_layout supports neural/feasibility/combined, not {strat!r}")
    if strat not in (*KERNEL_SCORED, "random"):
        raise ValueError(f"unsupported sharded strategy: {strat}")
    r = _Round(mesh, lp, cuts, strat, kmax, m_dense,
               True if use_fused is None else bool(use_fused), pair_layout)
    if strat in KERNEL_SCORED:
        r.mlp = MLPScorer(load_params(3 if pair_layout else kmax, scorer.weights_path), "cpu")
        r.sweeps = SWEEPS if pair_layout or strat == "neural" else LEX_SWEEPS
    return r


def make_sharded_round_step(mesh: Mesh, cfg: Optional[RunConfig] = None, *,
                            lp_iters: Optional[int] = None, sel_size: Optional[int] = None,
                            viol_tol: Optional[float] = None, strategy: Optional[str] = None,
                            use_fused: Optional[bool] = None, m_dense: int = 0, kmax: int = 3,
                            pair_layout: bool = False):
    """The batched round step over ``mesh``.  Knobs come from ``cfg``
    (default ``RunConfig()``); the keywords override them as in the
    reference.  ``use_fused``: None or True scores through the kernel
    wrappers (the kernels on CUDA, their twins on the CPU), False through
    the twins on either device.  ``pair_layout``: the table comes from
    ``sharding.shard_pair_candidates``.

    Returns step(state, table, valid, dense=None) -> (state, info), info =
    per-instance {'lp_iters', 'kkt_error'} numpy arrays (B,)."""
    rnd = _build_round(mesh, cfg, lp_iters, sel_size, viol_tol, strategy, use_fused,
                       m_dense, kmax, pair_layout)

    def step(state: BatchedRoundState, table, valid, dense: Optional[DenseRows] = None):
        state, info = rnd(state, *rnd.prepare(state, table, valid, dense))
        return state, {"lp_iters": info["lp_iters"], "kkt_error": info["kkt_error"]}

    return step


def make_sharded_scan_step(mesh: Mesh, cfg: Optional[RunConfig] = None, *, rounds: int,
                           lp_iters: Optional[int] = None, sel_size: Optional[int] = None,
                           viol_tol: Optional[float] = None, strategy: Optional[str] = None,
                           use_fused: Optional[bool] = None, m_dense: int = 0, kmax: int = 3,
                           pair_layout: bool = False):
    """``rounds`` rounds in one call, the round step's device operations in
    the same order (so it repeats a per-round run bit for bit).  Per round
    it stacks each instance's solve-time pool (the pool the LP was solved
    on), the solve's yA, yB, yC (before the purge) and yD, lp_iters,
    kkt_error and the pool's count after the append.

    Returns scan(state, table, valid, dense=None) -> (state, outs) where
    outs' leaves have a leading round axis (rounds, B, ...): 'pool' a
    ``CutPool`` of such tensors, the others tensors."""
    rnd = _build_round(mesh, cfg, lp_iters, sel_size, viol_tol, strategy, use_fused,
                       m_dense, kmax, pair_layout)

    def scan(state: BatchedRoundState, table, valid, dense: Optional[DenseRows] = None):
        args = rnd.prepare(state, table, valid, dense)
        per = []
        for _ in range(rounds):
            prev = state.pool
            state, info = rnd(state, *args)
            st = state.pdhg
            per.append({"pool": prev, "yA": st.yA, "yB": st.yB, "yC": info["yC_solve"],
                        "yD": st.yD, "lp_iters": torch.as_tensor(info["lp_iters"]),
                        "kkt_error": torch.as_tensor(info["kkt_error"]),
                        "count": state.pool.count})
        outs = {key: (rb.stack([p[key] for p in per]) if key == "pool" else
                      torch.stack([p[key] for p in per])) for key in per[0]}
        return state, outs

    return scan


def _dense_np(dense: Optional[DenseRows]):
    """Host copies (G, g, h) of a batched dense block, or None without rows."""
    if dense is None or dense.h.shape[1] == 0:
        return None
    return tuple(t.detach().cpu().numpy() for t in (dense.G, dense.g, dense.h))


def _host(obj):
    """CPU tensors of a dataclass' fields (tensors or numpy arrays)."""
    return type(obj)(*(torch.as_tensor(getattr(obj, f.name)).detach().cpu()
                       for f in dataclasses.fields(obj)))


def certify_scan_f64(Q, c, outs, dense: Optional[DenseRows] = None,
                     prev_best: Optional[np.ndarray] = None) -> np.ndarray:
    """Host f64 certificate (``dual_bound_f64``) of every (round, instance)
    of a scan run: round r pairs the pool its LP was solved on with the
    solve's duals.  Returns (rounds, B) max-form upper bounds, the running
    minimum over rounds (from ``prev_best`` when given).  After a
    distributed run, pass ``distributed.fetch_tree``'s full values (Q, c
    and ``fetch_tree(outs, mesh, axis=1)``)."""
    Q = np.asarray(torch.as_tensor(Q).cpu(), np.float64)
    c = np.asarray(torch.as_tensor(c).cpu(), np.float64)
    pool = _host(outs["pool"])
    ys = {k: torch.as_tensor(outs[k]).cpu() for k in ("yA", "yB", "yC", "yD")}
    dn = _dense_np(dense)
    R, B = ys["yA"].shape[:2]
    n = c.shape[1]
    best = (np.asarray(prev_best, np.float64).copy() if prev_best is not None
            else np.full((B,), np.inf))
    bounds = np.empty((R, B), np.float64)
    zero_x, zero_X = torch.zeros(n), torch.zeros(n, n)
    for r in range(R):
        for i in range(B):
            st = PDHGState(zero_x, zero_X, ys["yA"][r, i], ys["yB"][r, i], ys["yC"][r, i],
                           ys["yD"][r, i])
            cert = dual_bound_f64(Q[i], c[i], rb.instance(rb.instance(pool, r), i), st,
                                  None if dn is None else tuple(a[i] for a in dn))
            best[i] = min(best[i], cert)
            bounds[r, i] = best[i]
    return bounds


def certify_batched_f64(state: BatchedRoundState,
                        dense: Optional[DenseRows] = None) -> np.ndarray:
    """Host f64 certificate (``dual_bound_f64``, with its block polish) of
    every instance's current duals and pool: (B,) max-form upper bounds,
    the numbers to report; ``state.bound`` is the same certificate in f32.
    ``state`` may be ``distributed.fetch_tree``'s full state (numpy leaves)."""
    Q = np.asarray(torch.as_tensor(state.Q).cpu())
    c = np.asarray(torch.as_tensor(state.c).cpu())
    pool, st = _host(state.pool), _host(state.pdhg)
    dn = _dense_np(dense)
    return np.array([dual_bound_f64(Q[i], c[i], rb.instance(pool, i), rb.instance(st, i),
                                    None if dn is None else tuple(a[i] for a in dn))
                     for i in range(c.shape[0])], np.float64)


def bucket_instances(instances) -> dict:
    """{n: [instances of that n]} in increasing n, each in the given order:
    a batch holds one n."""
    buckets: dict = {}
    for inst in instances:
        buckets.setdefault(inst.n, []).append(inst)
    return dict(sorted(buckets.items()))


def instances_of(state: BatchedRoundState, lo: int, hi: int, device=None) -> BatchedRoundState:
    """Instances lo..hi-1 of ``state`` as a batch of their own (contiguous
    copies, with their generators' copies), on ``device`` (default: the
    state's)."""
    dev = device or state.c.device

    def take(t):
        return t[lo:hi].contiguous().to(dev)

    def take_all(obj):
        return type(obj)(*(take(v) for v in rb.values(obj)))

    return BatchedRoundState(take(state.Q), take(state.c), take_all(state.pool),
                             take_all(state.pdhg),
                             [_copy_generator(g) for g in state.generators[lo:hi]],
                             take(state.bound), take(state.best_bound))


def shard_batched_state(state: BatchedRoundState, mesh: Mesh) -> BatchedRoundState:
    """The state laid over ``mesh``.  On one process every instance stays on
    its device, so this checks that 'data' divides the batch.  On a
    distributed mesh, the rank's 'data' shard of the whole batch (every
    rank holds the same ``state``): its B / data instances and their
    generators, on the rank's device."""
    B = state.c.shape[0]
    if B % mesh.data:
        raise ValueError(f"mesh data={mesh.data} does not divide the batch B={B}")
    if not mesh.distributed:
        return state
    per = B // mesh.data
    return instances_of(state, mesh.data_index * per, (mesh.data_index + 1) * per, mesh.device)
