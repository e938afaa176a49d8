"""The sparse-QCQP cutting-plane round controller (port of
``sdpcutsel_tpu/qcqp/solver.py``).

The BoxQP round (loop/solver.py) with three differences:
  * the relaxation carries the linearized constraint rows
    1/2 <Qi, X> + ci'x <= bi as a dense block (relax/denserows.py) inside
    the PDHG solve, the steering run, the f64 certificate, and the PDHG block
    kernel;
  * the candidates are the <= k subsets of the maximal cliques of the
    chordal extension of the sparsity graph (``qcqp/chordal.py``), padded
    to width k by repeating the last index.  The table is not padded to a
    block multiple: the scoring kernel takes any T;
  * a cross-round re-selection gate (``CutConfig.sel_gate``) masks
    candidates whose cuts the LP has not enforced yet.

One round (``do_round``):
  1. solve the LP with the dense block (K2, ``lp/pdhg_kernel.py``);
  2. with ``steer_eps > 0``, steer from the solved state (one more K2
     launch); steps 4-6 run at the steered point;
  3. certify the f64 dual bound, the dense rows as a fourth block, from a
     host copy of the rows kept since set-up;
  4. score the clique table with the generic scoring kernel (K4,
     ``ops/fused_score.py``, 6 Jacobi sweeps), whose ``feas`` is also the
     residual gate's violation:
       neural, combined: nn where feas > viol_tol (no other can emit a cut);
       feasibility: feas;
       random: uniform [0, 1) from the solver's generator;
       optimality: the exact subproblem improvement (models/labels.py);
       a custom ``score_fn(x, X, generator)``;
  5. gate, support-diverse top sel_size, eigh of Z(rho), cut rows; strategy
     ``triangle`` (k = 3) takes the most violated RLT-3 inequalities and
     bypasses the gate, as in the reference;
  6. purge slack cuts, append the new rows;
  7. under ``RunConfig.debug``, check the round's state (utils/debug.py).
``run`` (with its snapshots, gate state included), ``run_scan`` (every
round's device work, gate included, in ``do_round``'s order; each round's
pool and duals, yD too, kept and certified after the loop), ``polish`` and
``restore`` are ``CheckpointableSolver``'s.  The generator's draws are the
BoxQP solver's: steering signs, then random scores.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..config import RunConfig
from ..cuts.triangle import triangle_select_and_generate
from ..instances.qcqp import QCQPInstance
from ..loop.solver import (KERNEL_SCORED, CheckpointableSolver, RoundStats,
                           check_strategy, select_and_generate)
from ..lp.pdhg import PDHGState, dual_bound_f64, init_state
from ..models.features import candidate_q_features
from ..models.labels import exact_score_fn
from ..models.scorer import MLPScorer, load_params
from ..ops.fused_score import fused_score
from ..relax.cutbuffer import CutPool, append_cuts, cut_residuals, empty_pool, purge_pool
from ..relax.denserows import dense_from_qcqp, empty_dense
from .chordal import chordal_decomposition, clique_candidates

SWEEPS = 6      # Jacobi sweeps on Z(rho), as in the reference's QCQP scoring


class CutSolverQCQP(CheckpointableSolver):
    """One sparse QCQP instance; clique candidate table.  Runs on the card
    unless ``device`` names another (the CPU takes the twins)."""

    def __init__(self, inst: QCQPInstance, cfg: RunConfig, device="cuda",
                 score_fn: Optional[Callable] = None):
        check_strategy(cfg, score_fn is not None)
        if cfg.cuts.sel_gate not in ("residual", "cooldown", "none"):
            raise ValueError(f"unknown sel_gate: {cfg.cuts.sel_gate!r}")
        self.inst = inst
        self.cfg = cfg
        self.device = torch.device(device)
        n, k = inst.n, cfg.cuts.k
        self.Q = torch.as_tensor(inst.Q0, dtype=torch.float32, device=self.device)
        self.c = torch.as_tensor(inst.c0, dtype=torch.float32, device=self.device)
        if inst.m > 0:
            self.dense = dense_from_qcqp(inst.Qs, inst.cs, inst.bs, self.device)
            # a host copy of the f32 rows feeds the certificate every round
            self.dense_np = tuple(t.cpu().numpy() for t in
                                  (self.dense.G, self.dense.g, self.dense.h))
        else:
            self.dense, self.dense_np = empty_dense(n, self.device), None
        cliques, _ = chordal_decomposition(n, inst.sparsity_graph())
        table = clique_candidates(cliques, k)
        if table.shape[0] == 0:
            raise ValueError("no candidate subsets: sparsity graph is empty")
        self.table = torch.as_tensor(table, device=self.device)
        self.triQ, self.scale = candidate_q_features(self.Q, self.table)
        self.mlp = MLPScorer(load_params(k, cfg.scorer.weights_path), self.device)
        self._score_fn = score_fn
        if cfg.scorer.strategy == "optimality" and score_fn is None:
            self._exact = exact_score_fn(self.Q, self.table)
        self.pool: CutPool = empty_pool(cfg.cuts.capacity, k, self.device)
        self.state: PDHGState = init_state(n, cfg.cuts.capacity, self.device, inst.m)
        self.generator = torch.Generator(device="cpu").manual_seed(cfg.seed)
        # re-selection gate state: "cooldown" counts rounds left before a
        # selected candidate may be re-picked; "residual" keeps each
        # candidate's violation when last selected (+inf: never selected)
        T = self.table.shape[0]
        self._cooldown = torch.zeros((T,), dtype=torch.int32, device=self.device)
        self._last_viol = torch.full((T,), torch.inf, device=self.device)
        self.history: list[RoundStats] = []
        self.polish_certificate: float | None = None     # set by polish()
        self.polish_info: dict | None = None

    def _scores(self, x, X):
        """(the strategy's scores, feas: K4's violations, or None where
        neither the strategy nor the gate reads them)."""
        strat, cuts = self.cfg.scorer.strategy, self.cfg.cuts
        feas = None
        if (self._score_fn is None and strat in KERNEL_SCORED) or cuts.sel_gate == "residual":
            nn, feas = fused_score(x, X, self.table, self.triQ, self.scale, self.mlp,
                                   SWEEPS)
        if self._score_fn is not None:
            return self._score_fn(x, X, self.generator), feas
        if strat == "feasibility":
            return feas, feas
        if strat == "random":
            return (torch.rand((self.table.shape[0],), generator=self.generator)
                    .to(self.device), feas)
        if strat == "optimality":
            return self._exact(x, X), feas
        return torch.where(feas > cuts.viol_tol, nn, torch.full_like(nn, -torch.inf)), feas

    def _gate_scores(self, scores, feas, kkt_error: float):
        """Mask candidates before selection.  "residual": while the current
        violation is still >= gate_eta x the violation at the last selection
        (the LP has not enforced that cut yet).  "cooldown": for sel_cooldown
        rounds after a selection, while the solve's KKT error is above
        cooldown_kkt_tol."""
        cuts = self.cfg.cuts
        neg = torch.full_like(scores, -torch.inf)
        if cuts.sel_gate == "residual":
            return torch.where(feas > cuts.gate_eta * self._last_viol, neg, scores)
        if (cuts.sel_gate == "cooldown" and cuts.sel_cooldown > 0
                and kkt_error > cuts.cooldown_kkt_tol):
            return torch.where(self._cooldown > 0, neg, scores)
        return scores

    def _gate_update(self, sel, valid, feas):
        """Record this round's valid selections for the active gate.  Only
        valid picks are written: they are distinct, so the scatter has one
        write per row and repeats bit for bit on CUDA."""
        cuts = self.cfg.cuts
        picked = sel[valid]
        if cuts.sel_gate == "residual":
            self._last_viol[picked] = feas[picked].clamp(min=cuts.viol_tol)
        elif cuts.sel_gate == "cooldown" and cuts.sel_cooldown > 0:
            self._cooldown = (self._cooldown - 1).clamp(min=0)
            self._cooldown[picked] = cuts.sel_cooldown

    def _extra_arrays(self) -> dict:
        """The gate's state rides the snapshot: resuming without it would
        reset the gate and leave the uninterrupted run's path."""
        return {"cooldown": self._cooldown, "last_viol": self._last_viol}

    def _restore_extra(self, arrays: dict):
        T = self.table.shape[0]
        if "cooldown" in arrays and arrays["cooldown"].shape == (T,):
            self._cooldown = arrays["cooldown"]
        if "last_viol" in arrays and arrays["last_viol"].shape == (T,):
            self._last_viol = arrays["last_viol"]

    def _round(self):
        """One round's device work: solve, steer, score, gate, cut.  Returns
        (the pool the solve ran on, the solve's state, its info, kept)."""
        cuts = self.cfg.cuts
        pool = self.pool
        solved, info, setup = self._solve(pool)
        x, X = self._steer(pool, solved, setup)
        if self.cfg.scorer.strategy == "triangle":
            rows = triangle_select_and_generate(x, X, self.table, cuts.sel_size,
                                                cuts.viol_tol)
        else:
            scores, feas = self._scores(x, X)
            scores = self._gate_scores(scores, feas, info["kkt_error"])
            rows, sel, valid = select_and_generate(x, X, self.table, scores, cuts)
            self._gate_update(sel, valid, feas)
        purged, yC = pool, solved.yC
        if cuts.purge:
            purged, yC = purge_pool(purged, yC, cut_residuals(x, X, purged),
                                    cuts.purge_slack_tol)
        self.pool = append_cuts(purged, *rows)
        self.state = dataclasses.replace(solved, yC=yC)
        return pool, solved, info, purged.count

    def _certify(self, pool: CutPool, state: PDHGState) -> float:
        return dual_bound_f64(self.inst.Q0, self.inst.c0, pool, state,
                              dense_np=self.dense_np)
