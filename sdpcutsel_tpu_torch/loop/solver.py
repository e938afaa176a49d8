"""The cutting-plane round controller for BoxQP (port of
``sdpcutsel_tpu/loop/solver.py``), and the round loop and checkpoints it
shares with the QCQP solver (qcqp/solver.py).

One round (``do_round``):
  1. re-solve the relaxation (warm-started restarted PDHG, lp/pdhg.py);
  2. with ``LoopConfig.steer_eps > 0``, steer: ``steer_iters`` more PDHG
     iterations on a perturbed objective from the solved state, in one K2
     launch on CUDA (``lp/pdhg.py::steer_to_vertex``).  Steps 4-6 run at
     the steered point; the certificate and the next warm start are the
     unsteered solve's;
  3. certify the f64 dual bound on the host (``dual_bound_f64``);
  4. score every candidate of the route's table by the strategy:
       neural, feasibility, combined: a scoring kernel wrapper (the route is
               the reference's, ``loop/solver.py:173-186``):
               packed  k = 3, 66 <= n <= 128, ``pair_layout="packed"``: the
                       tiered packed layout through ops/pair_packed.py (5
                       Jacobi sweeps), whose invalid slots score -inf;
               lexicographic otherwise: ops/pair_score.py for k = 3, the
                       generic ops/fused_score.py for any other k.  With
                       k = 3, n <= 128 and ``pair_layout="on"`` the
                       reference scores its pair layout, whose valid slots
                       run in this same order, with 5 sweeps; every other
                       case is the reference's CPU path, with 6 sweeps for
                       feasibility and combined.
               ``feasibility`` ranks by feas, ``neural`` by nn,
               ``combined`` by nn where feas > 0;
       random: uniform [0, 1) from the solver's generator;
       optimality: the exact subproblem improvement (models/labels.py);
       a custom ``score_fn(x, X, generator)``: one score a table row;
     the table is lexicographic for all but the first three;
  5. support-diverse (or plain) top ``sel_size``, eigh of the selected
     Z(rho), unit-norm cut rows; strategy ``triangle`` (k = 3) instead takes
     the most violated RLT-3 inequalities (cuts/triangle.py);
  6. purge slack cuts and append the new rows.
``run_scan`` (``LoopConfig.use_scan``) runs the same device operations for
all rounds with no per-round certificate or early stop, and certifies every
round afterwards from the pools and duals it kept.  ``polish`` ends either
mode when ``LoopConfig.polish_iters > 0``.  ``RunConfig.debug`` checks each
per-round state (utils/debug.py), as the reference's ``do_round`` does; its
scan mode has no such check, and neither has this one.  ``run`` writes a
snapshot every ``LoopConfig.checkpoint_every`` rounds to
``<checkpoint_dir>/<instance>.ck`` (utils/checkpoint.py); ``restore``
resumes from one, bit for bit.  Scan mode writes none, as in the reference.

Randomness: one CPU ``torch.Generator`` a solver, seeded with
``RunConfig.seed``.  A round draws from it in one order, the same in both
modes: the steering signs (x, then X) when steering, then the random scores
under ``random``.  Draws on the CPU make both devices see the same numbers;
they are not ``jax.random``'s stream.

Everything runs in float32, the kernels' one type.  On CUDA the round does
no cuBLAS matrix product (the MLP runs inside the scoring kernel), so the
process-wide TF32 setting does not reach it.  ``select_and_generate``,
``RoundStats``, ``polish_lp`` and ``CheckpointableSolver`` serve the QCQP
solver too.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import CutConfig, LPConfig, RunConfig
from ..cuts.assemble import assemble_Z
from ..cuts.eigen import batched_eigh_small
from ..cuts.enumerate import combinations_table
from ..cuts.generate import cuts_from_selected
from ..cuts.triangle import triangle_select_and_generate
from ..instances import BoxQPInstance
from ..lp.pdhg import (PDHGState, dual_bound_f64, init_state, solve_lp, solve_setup,
                       steer_to_vertex)
from ..models.features import candidate_q_features
from ..models.labels import exact_score_fn
from ..models.scorer import MLPScorer, load_params
from ..ops.fused_score import fused_score
from ..ops.pair_packed import packed_layout, packed_score
from ..ops.pair_score import SWEEPS, pair_score
from ..ops.topk import diverse_topk, masked_topk
from ..relax.cutbuffer import CutPool, append_cuts, cut_residuals, empty_pool, purge_pool
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.debug import check_round_state

KERNEL_SCORED = ("neural", "feasibility", "combined")   # scored by K1, K3 or K4
STRATEGIES = (*KERNEL_SCORED, "random", "optimality", "triangle")
LEX_SWEEPS = 6      # the reference's CPU feasibility and combined scoring (cuts/eigen.py)


@dataclasses.dataclass
class RoundStats:
    round: int
    bound: float          # best certified f64 upper bound so far
    certificate: float    # this round's own f64 certificate (>= bound)
    lp_iters: int
    lp_kkt_error: float
    cuts_added: int
    cuts_active: int
    wall_time_s: float


def check_strategy(cfg: RunConfig, custom: bool):
    """The reference's ValueErrors: an unknown strategy (unless a custom
    score_fn replaces it), and ``triangle`` with k != 3."""
    strat = cfg.scorer.strategy
    if not custom and strat not in STRATEGIES:
        raise ValueError(f"unknown strategy: {strat}")
    if strat == "triangle" and cfg.cuts.k != 3:
        raise ValueError("triangle strategy requires k=3 (RLT-3 inequalities are "
                         f"defined on triples); got k={cfg.cuts.k}")


def select_and_generate(x, X, table, scores, cuts: CutConfig):
    """Top sel_size by score -> eigh(Z) -> violated cut rows.  Returns
    (rows for append_cuts, sel: selected table rows, valid: (sel_size,))."""
    if cuts.diversity_alpha > 0.0:
        _, sel, valid = diverse_topk(scores, table, cuts.sel_size,
                                     cuts.diversity_alpha)
    else:
        _, sel, valid = masked_topk(scores, cuts.sel_size)
    idx_sel = table[sel].long()
    w, V = batched_eigh_small(assemble_Z(x, X, idx_sel))
    return cuts_from_selected(idx_sel, w, V, cuts.viol_tol, sel_valid=valid), sel, valid


def polish_lp(cfg: RunConfig) -> LPConfig:
    """The final re-solve's LP settings: polish_iters iterations at tol / 100."""
    return dataclasses.replace(cfg.lp, max_iters=cfg.loop.polish_iters,
                               tol=cfg.lp.tol * 1e-2)


class CheckpointableSolver:
    """The round loop and the round-granular checkpoints shared by the BoxQP
    and QCQP solvers.  A subclass provides ``inst``, ``cfg``, ``device``,
    ``Q``, ``c``, ``dense`` (None for BoxQP), ``pool``, ``state``,
    ``generator``, ``history``, ``_round()`` (one round's device work,
    returning (the pool its solve ran on, the solved state, the solve's info,
    the purged pool's count)) and ``_certify(pool, state)``."""

    def _steer(self, pool: CutPool, solved: PDHGState, setup):
        """The point that scores, selects and purges: the solved one, or
        with steering the steered one (the generator's first draw)."""
        loop = self.cfg.loop
        if loop.steer_eps <= 0.0:
            return solved.x, solved.X
        return steer_to_vertex(self.Q, self.c, pool, solved, self.cfg.lp, self.generator,
                               loop.steer_eps, loop.steer_iters, self.dense, setup)

    def _solve(self, pool: CutPool):
        """(solved state, info, setup) of this round's solve from the warm start."""
        setup = solve_setup(self.c, pool, self.cfg.lp, self.dense)
        solved, info = solve_lp(self.Q, self.c, pool, self.state, self.cfg.lp,
                                self.dense, setup)
        return solved, info, setup

    def _record(self, cert: float, info: dict, kept, count, wall: float) -> RoundStats:
        # every certificate is valid, so the running minimum is too
        bound = min(cert, self.history[-1].bound) if self.history else cert
        stats = RoundStats(
            round=len(self.history), bound=bound, certificate=cert,
            lp_iters=int(info["iters"]), lp_kkt_error=float(info["kkt_error"]),
            cuts_added=int(count) - int(kept), cuts_active=int(count),
            wall_time_s=wall,
        )
        self.history.append(stats)
        return stats

    def do_round(self) -> RoundStats:
        t0 = time.perf_counter()
        pool, solved, info, kept = self._round()
        cert = self._certify(pool, solved)
        stats = self._record(cert, info, kept, self.pool.count, time.perf_counter() - t0)
        if self.cfg.debug:
            check_round_state(self.state.x, self.state.X, self.pool, stats.bound)
        return stats

    def run(self, rounds: Optional[int] = None) -> list[RoundStats]:
        """Per-round loop with the reference's early stop (a round that adds
        no cut and moves the bound by less than improvement_tol ends it) and
        its snapshots, then ``polish`` when polish_iters > 0.
        ``LoopConfig.use_scan`` hands over to ``run_scan``."""
        if self.cfg.loop.use_scan:
            return self.run_scan(rounds)
        rounds = rounds if rounds is not None else self.cfg.loop.rounds
        prev = None
        for _ in range(rounds):
            s = self.do_round()
            self._maybe_checkpoint()
            if prev is not None:
                rel = abs(prev - s.bound) / (1.0 + abs(prev))
                if rel < self.cfg.loop.improvement_tol and s.cuts_added == 0:
                    break
            prev = s.bound
        if self.cfg.loop.polish_iters > 0 and self.history:
            self.polish()
        return self.history

    def run_scan(self, rounds: Optional[int] = None) -> list[RoundStats]:
        """All rounds with no per-round certificate, early stop or snapshot
        (reference ``run_scan``).  Each round keeps the pool its solve ran on
        and the solve's state on the device; after the loop every round is
        certified in f64 on the host.  The device operations and the
        generator's draws are ``do_round``'s in the same order, so both
        modes certify the same bits.  ``wall_time_s`` is the timed loop over
        the number of rounds.  A process's first launch builds the kernels
        inside that loop, as the reference's first run_scan compiles inside
        it, so a caller that times the rounds runs once before.  The solve's
        per-block convergence check still reads the device from the host."""
        rounds = rounds if rounds is not None else self.cfg.loop.rounds
        t0 = time.perf_counter()
        kept_rounds = []
        for _ in range(rounds):
            kept_rounds.append((*self._round(), self.pool.count))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = (time.perf_counter() - t0) / max(rounds, 1)
        for pool, solved, info, kept, count in kept_rounds:
            self._record(self._certify(pool, solved), info, kept, count, wall)
        if self.cfg.loop.polish_iters > 0 and self.history:
            self.polish()
        return self.history

    def polish(self) -> float:
        """A final, tighter LP re-solve with no new cuts (``polish_lp``).
        Its certificate can only lower the last round's bound; it is kept in
        ``polish_certificate``, the solve's info in ``polish_info``."""
        self.state, self.polish_info = solve_lp(self.Q, self.c, self.pool, self.state,
                                                polish_lp(self.cfg), self.dense)
        self.polish_certificate = self._certify(self.pool, self.state)
        b = self.polish_certificate
        if self.history:
            b = min(b, self.history[-1].bound)
            self.history[-1].bound = b
        return b

    @property
    def bounds(self) -> np.ndarray:
        return np.asarray([s.bound for s in self.history])

    # -- checkpoints ----------------------------------------------------------
    def _checkpoint_path(self) -> Optional[str]:
        lc = self.cfg.loop
        if not lc.checkpoint_every or not lc.checkpoint_dir:
            return None
        return os.path.join(lc.checkpoint_dir, f"{self.inst.name}.ck")

    def _maybe_checkpoint(self):
        path = self._checkpoint_path()
        if path is not None and len(self.history) % self.cfg.loop.checkpoint_every == 0:
            self.checkpoint(path)

    def _extra_arrays(self) -> dict:
        """Subclass hook: more state to snapshot, as named tensors."""
        return {}

    def _restore_extra(self, arrays: dict):
        pass

    def checkpoint(self, path: str):
        save_checkpoint(path, self.pool, self.state, self.generator.get_state(),
                        [dataclasses.asdict(h) for h in self.history],
                        {"instance": self.inst.name, "strategy": self.cfg.scorer.strategy},
                        self._extra_arrays())

    def restore(self, path: str):
        """Resume from a snapshot written by ``checkpoint``: the pool, the
        PDHG warm start, the generator and the history (and the subclass's
        extras), the tensors on this solver's device.  Raises ValueError for
        another instance's snapshot."""
        pool, state, gen, hist, meta, extra = load_checkpoint(path)
        if meta.get("instance") != self.inst.name:
            raise ValueError(f"checkpoint is for {meta.get('instance')}, "
                             f"not {self.inst.name}")

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        self.pool = CutPool(**{f: dev(v) for f, v in pool.items()})
        self.state = PDHGState(**{f: dev(v) for f, v in state.items()})
        self.generator.set_state(gen)
        self.history = [RoundStats(**h) for h in hist]
        self._restore_extra({k: dev(v) for k, v in extra.items()})
        return self


class CutSolver(CheckpointableSolver):
    """One BoxQP instance; dense candidate set of all C(n, k) subsets.  Runs
    on the card unless ``device`` names another (the CPU takes the twins).
    ``score_fn(x, X, generator)``, when given, replaces the strategy's
    scores (one a row of the lexicographic ``table``); ``triangle`` still
    takes its own path, as in the reference."""

    def __init__(self, inst: BoxQPInstance, cfg: RunConfig, device="cuda",
                 score_fn: Optional[Callable] = None):
        check_strategy(cfg, score_fn is not None)
        strat = cfg.scorer.strategy
        self.inst = inst
        self.cfg = cfg
        self.device = torch.device(device)
        n, k = inst.n, cfg.cuts.k
        self.Q = torch.as_tensor(inst.Q, dtype=torch.float32, device=self.device)
        self.c = torch.as_tensor(inst.c, dtype=torch.float32, device=self.device)
        self.dense = None
        self._score_fn = score_fn
        kernel_scored = score_fn is None and strat in KERNEL_SCORED
        mode = cfg.cuts.pair_layout
        self._use_packed = kernel_scored and k == 3 and 66 <= n <= 128 and mode == "packed"
        if self._use_packed:
            self.layout = packed_layout(n, self.device)
            self.table = self.layout.table
        else:
            self.table = torch.as_tensor(combinations_table(n, k), device=self.device)
        if kernel_scored:
            # the reference's pair route: its table's valid slots are this
            # table in order, scored with 5 sweeps
            pair_route = k == 3 and n <= 128 and mode == "on"
            self._sweeps = LEX_SWEEPS if strat != "neural" and not pair_route else SWEEPS
            self.mlp = MLPScorer(load_params(k, cfg.scorer.weights_path), self.device)
            if k != 3:
                self.triQ, self.scale = candidate_q_features(self.Q, self.table)
        if strat == "optimality" and score_fn is None:
            self._exact = exact_score_fn(self.Q, self.table)
        self.pool: CutPool = empty_pool(cfg.cuts.capacity, k, self.device)
        self.state: PDHGState = init_state(n, cfg.cuts.capacity, self.device)
        self.generator = torch.Generator(device="cpu").manual_seed(cfg.seed)
        self.history: list[RoundStats] = []
        self.polish_certificate: float | None = None     # set by polish()
        self.polish_info: dict | None = None

    def _scores(self, x, X):
        """The strategy's score of every slot of the route's table."""
        strat = self.cfg.scorer.strategy
        if self._score_fn is not None:
            return self._score_fn(x, X, self.generator)
        if strat == "random":
            return torch.rand((self.table.shape[0],), generator=self.generator).to(self.device)
        if strat == "optimality":
            return self._exact(x, X)
        if self._use_packed:
            nn, feas = packed_score(x, X, self.Q, self.layout, self.mlp)
        elif self.cfg.cuts.k == 3:
            nn, feas = pair_score(x, X, self.Q, self.table, self.mlp, self._sweeps)
        else:
            nn, feas = fused_score(x, X, self.table, self.triQ, self.scale,
                                   self.mlp, self._sweeps)
        if strat == "feasibility":
            return feas
        if strat == "combined":
            return torch.where(feas > 0.0, nn, torch.full_like(nn, -torch.inf))
        return nn

    def _post_lp(self, x, X, pool: CutPool, yC):
        """Select -> cut rows -> purge -> append, at the scoring point (x, X).
        Returns (pool, yC, kept: the purged pool's count, a tensor)."""
        cuts = self.cfg.cuts
        if self.cfg.scorer.strategy == "triangle":
            rows = triangle_select_and_generate(x, X, self.table, cuts.sel_size,
                                                cuts.viol_tol)
        else:
            rows, _, _ = select_and_generate(x, X, self.table, self._scores(x, X), cuts)
        if cuts.purge:
            slack = cut_residuals(x, X, pool)
            pool, yC = purge_pool(pool, yC, slack, cuts.purge_slack_tol)
        return append_cuts(pool, *rows), yC, pool.count

    def _round(self):
        """One round's device work: solve, steer, cut.  Returns (the pool the
        solve ran on, the solve's state, its info, kept)."""
        pool = self.pool
        solved, info, setup = self._solve(pool)
        x, X = self._steer(pool, solved, setup)
        self.pool, yC, kept = self._post_lp(x, X, pool, solved.yC)
        self.state = dataclasses.replace(solved, yC=yC)
        return pool, solved, info, kept

    def _certify(self, pool: CutPool, state: PDHGState) -> float:
        return dual_bound_f64(self.inst.Q, self.inst.c, pool, state)
