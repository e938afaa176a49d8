"""The sparse-QCQP cutting-plane round controller (port of
``sdpcutsel_tpu/qcqp/solver.py``, per-round mode, strategy ``neural``).

The BoxQP round (loop/solver.py) with three differences:
  * the relaxation carries the linearized constraint rows
    1/2 <Qi, X> + ci'x <= bi as a dense block (relax/denserows.py) inside
    the PDHG solve, the f64 certificate, and the PDHG block kernel;
  * the candidates are the <= k subsets of the maximal cliques of the
    chordal extension of the sparsity graph (``qcqp/chordal.py``), padded to width k by repeating the last index.  The table
    is not padded to a block multiple: the scoring kernel takes any T;
  * a cross-round re-selection gate (``CutConfig.sel_gate``) masks
    candidates whose cuts the LP has not enforced yet.

One round (``do_round``):
  1. solve the LP with the dense block (K2, ``lp/pdhg_kernel.py``);
  2. certify the f64 dual bound, the dense rows as a fourth block, from a
     host copy of the rows kept since set-up;
  3. score the clique table with the generic scoring kernel (K4,
     ``ops/fused_score.py``, 6 Jacobi sweeps): the neural score is kept
     only where feas > viol_tol, and ``feas`` is also the gate's violation;
  4. gate, support-diverse top sel_size, eigh of Z(rho), cut rows;
  5. purge slack cuts, append the new rows;
  6. under ``RunConfig.debug``, check the round's state (utils/debug.py).
``run`` ends with the reference's optional ``polish`` re-solve.

``neural`` and ``combined`` are the same code in the reference and here.
Not ported yet (they raise): other strategies, ``use_scan``, vertex
steering and checkpoints.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..config import RunConfig
from ..instances.qcqp import QCQPInstance
from ..loop.solver import RoundStats, polish_lp, select_and_generate
from ..lp.pdhg import PDHGState, dual_bound_f64, init_state, solve_lp
from ..models.features import candidate_q_features
from ..models.scorer import MLPScorer, load_params
from ..ops.fused_score import fused_score
from ..relax.cutbuffer import CutPool, append_cuts, cut_residuals, empty_pool, purge_pool
from ..relax.denserows import dense_from_qcqp, empty_dense
from ..utils.debug import check_round_state
from .chordal import chordal_decomposition, clique_candidates

SWEEPS = 6      # Jacobi sweeps on Z(rho), as in the reference's QCQP scoring


class CutSolverQCQP:
    """One sparse QCQP instance; clique candidate table.  Runs on the card
    unless ``device`` names another (the CPU takes the twins)."""

    def __init__(self, inst: QCQPInstance, cfg: RunConfig, device="cuda"):
        if cfg.scorer.strategy not in ("neural", "combined"):
            raise NotImplementedError(
                f"strategy {cfg.scorer.strategy!r} is not ported; use 'neural'")
        loop = cfg.loop
        if loop.use_scan or loop.steer_eps or loop.checkpoint_every:
            raise NotImplementedError(
                "use_scan, steering and checkpoints are not ported")
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
        self.pool: CutPool = empty_pool(cfg.cuts.capacity, k, self.device)
        self.state: PDHGState = init_state(n, cfg.cuts.capacity, self.device, inst.m)
        # re-selection gate state: "cooldown" counts rounds left before a
        # selected candidate may be re-picked; "residual" keeps each
        # candidate's violation when last selected (+inf: never selected)
        T = self.table.shape[0]
        self._cooldown = torch.zeros((T,), dtype=torch.int32, device=self.device)
        self._last_viol = torch.full((T,), torch.inf, device=self.device)
        self.history: list[RoundStats] = []
        self.polish_certificate: float | None = None     # set by polish()

    def _scores(self, x, X):
        """(gated neural scores, feas): the neural score ranks only the
        candidates violated beyond viol_tol, since no other can emit a cut."""
        nn, feas = fused_score(x, X, self.table, self.triQ, self.scale, self.mlp,
                               SWEEPS)
        neg = torch.full_like(nn, -torch.inf)
        return torch.where(feas > self.cfg.cuts.viol_tol, nn, neg), feas

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

    def _certify(self) -> float:
        return dual_bound_f64(self.inst.Q0, self.inst.c0, self.pool, self.state,
                              dense_np=self.dense_np)

    def do_round(self) -> RoundStats:
        t0 = time.perf_counter()
        cuts = self.cfg.cuts
        self.state, info = solve_lp(self.Q, self.c, self.pool, self.state,
                                    self.cfg.lp, dense=self.dense)
        cert = self._certify()
        # every certificate is valid, so the running minimum is too
        bound = min(cert, self.history[-1].bound) if self.history else cert
        x, X = self.state.x, self.state.X
        scores, feas = self._scores(x, X)
        scores = self._gate_scores(scores, feas, info["kkt_error"])
        rows, sel, valid = select_and_generate(x, X, self.table, scores, cuts)
        self._gate_update(sel, valid, feas)
        pool, yC = self.pool, self.state.yC
        if cuts.purge:
            pool, yC = purge_pool(pool, yC, cut_residuals(x, X, pool),
                                  cuts.purge_slack_tol)
        kept = int(pool.count)
        self.pool = append_cuts(pool, *rows)
        self.state = dataclasses.replace(self.state, yC=yC)
        count = int(self.pool.count)
        if self.cfg.debug:
            check_round_state(self.state.x, self.state.X, self.pool, bound)
        stats = RoundStats(
            round=len(self.history), bound=bound, certificate=cert,
            lp_iters=int(info["iters"]), lp_kkt_error=float(info["kkt_error"]),
            cuts_added=count - kept, cuts_active=count,
            wall_time_s=time.perf_counter() - t0,
        )
        self.history.append(stats)
        return stats

    def run(self, rounds: Optional[int] = None) -> list[RoundStats]:
        """Per-round loop with the reference's early stop (a round that adds
        no cut and moves the bound by less than improvement_tol ends it),
        then ``polish`` when LoopConfig.polish_iters > 0."""
        rounds = rounds if rounds is not None else self.cfg.loop.rounds
        prev = None
        for _ in range(rounds):
            s = self.do_round()
            if prev is not None:
                rel = abs(prev - s.bound) / (1.0 + abs(prev))
                if rel < self.cfg.loop.improvement_tol and s.cuts_added == 0:
                    break
            prev = s.bound
        if self.cfg.loop.polish_iters > 0 and self.history:
            self.polish()
        return self.history

    def polish(self) -> float:
        """A final, tighter LP re-solve with no new cuts (``polish_lp``:
        polish_iters iterations at tol / 100).  Its certificate can only
        lower the last round's bound; it is kept in ``polish_certificate``."""
        self.state, _ = solve_lp(self.Q, self.c, self.pool, self.state,
                                 polish_lp(self.cfg), dense=self.dense)
        self.polish_certificate = self._certify()
        b = self.polish_certificate
        if self.history:
            b = min(b, self.history[-1].bound)
            self.history[-1].bound = b
        return b
