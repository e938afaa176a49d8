"""The cutting-plane round controller for BoxQP (port of
``sdpcutsel_tpu/loop/solver.py``, per-round mode, strategy ``neural``).

One round (``do_round``):
  1. re-solve the relaxation (warm-started restarted PDHG, lp/pdhg.py);
  2. certify the f64 dual bound on the host (``dual_bound_f64``);
  3. score all C(n, k) candidates of the lexicographic table with a
     scoring kernel wrapper: ops/pair_score.py for k = 3, the generic
     ops/fused_score.py (5 Jacobi sweeps, as the reference's k = 2 path on
     the TPU) for any other k;
  4. support-diverse (or plain) top ``sel_size``, eigh of the selected
     Z(rho), unit-norm cut rows;
  5. purge slack cuts and append the new rows.

Everything runs in float32, the kernels' one type.  On CUDA the round does
no cuBLAS matrix product (the MLP runs inside the scoring kernel), so the
process-wide TF32 setting does not reach it.  ``select_and_generate`` and
``RoundStats`` serve the QCQP solver (qcqp/solver.py) too.
Not ported yet (they raise): ``run_scan`` (LoopConfig.use_scan), polish,
vertex steering, checkpoints, and strategies other than ``neural``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from sdpcutsel_tpu.config import CutConfig, RunConfig
from sdpcutsel_tpu.instances import BoxQPInstance

from ..cuts.assemble import assemble_Z
from ..cuts.eigen import batched_eigh_small
from ..cuts.enumerate import combinations_table
from ..cuts.generate import cuts_from_selected
from ..lp.pdhg import PDHGState, dual_bound_f64, init_state, solve_lp
from ..models.features import candidate_q_features
from ..models.scorer import MLPScorer, load_params
from ..ops.fused_score import fused_score
from ..ops.pair_score import SWEEPS, pair_score
from ..ops.topk import diverse_topk, masked_topk
from ..relax.cutbuffer import CutPool, append_cuts, cut_residuals, empty_pool, purge_pool


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


class CutSolver:
    """One BoxQP instance; dense candidate set of all C(n, k) subsets."""

    def __init__(self, inst: BoxQPInstance, cfg: RunConfig, device):
        if cfg.scorer.strategy != "neural":
            raise NotImplementedError(
                f"strategy {cfg.scorer.strategy!r} is not ported; use 'neural'")
        loop = cfg.loop
        if loop.use_scan or loop.polish_iters or loop.steer_eps or loop.checkpoint_every:
            raise NotImplementedError(
                "use_scan, polish, steering and checkpoints are not ported")
        self.inst = inst
        self.cfg = cfg
        self.device = torch.device(device)
        n, k = inst.n, cfg.cuts.k
        self.Q = torch.as_tensor(inst.Q, dtype=torch.float32, device=self.device)
        self.c = torch.as_tensor(inst.c, dtype=torch.float32, device=self.device)
        self.table = torch.as_tensor(combinations_table(n, k), device=self.device)
        params = load_params(k, cfg.scorer.weights_path)
        self.mlp = MLPScorer(params, self.device)
        if k != 3:
            self.triQ, self.scale = candidate_q_features(self.Q, self.table)
        self.pool: CutPool = empty_pool(cfg.cuts.capacity, k, self.device)
        self.state: PDHGState = init_state(n, cfg.cuts.capacity, self.device)
        self.history: list[RoundStats] = []

    def _post_lp(self, x, X, pool: CutPool, yC):
        """Score all candidates -> select -> cut rows -> purge -> append."""
        cuts = self.cfg.cuts
        if cuts.k == 3:
            scores, _ = pair_score(x, X, self.Q, self.table, self.mlp)
        else:
            scores, _ = fused_score(x, X, self.table, self.triQ, self.scale,
                                    self.mlp, SWEEPS)
        rows, _, _ = select_and_generate(x, X, self.table, scores, cuts)
        if cuts.purge:
            slack = cut_residuals(x, X, pool)
            pool, yC = purge_pool(pool, yC, slack, cuts.purge_slack_tol)
        kept = int(pool.count)
        return append_cuts(pool, *rows), yC, kept

    def do_round(self) -> RoundStats:
        t0 = time.perf_counter()
        self.state, info = solve_lp(self.Q, self.c, self.pool, self.state,
                                    self.cfg.lp)
        cert = dual_bound_f64(self.inst.Q, self.inst.c, self.pool, self.state)
        # every certificate is valid, so the running minimum is too
        bound = min(cert, self.history[-1].bound) if self.history else cert
        self.pool, yC, kept = self._post_lp(self.state.x, self.state.X,
                                            self.pool, self.state.yC)
        self.state = dataclasses.replace(self.state, yC=yC)
        count = int(self.pool.count)
        stats = RoundStats(
            round=len(self.history), bound=bound, certificate=cert,
            lp_iters=int(info["iters"]),
            lp_kkt_error=float(info["kkt_error"]), cuts_added=count - kept,
            cuts_active=count, wall_time_s=time.perf_counter() - t0,
        )
        self.history.append(stats)
        return stats

    def run(self, rounds: Optional[int] = None) -> list[RoundStats]:
        """Per-round loop with the reference's early stop: a round that adds
        no cut and moves the bound by less than improvement_tol ends it."""
        rounds = rounds if rounds is not None else self.cfg.loop.rounds
        prev = None
        for _ in range(rounds):
            s = self.do_round()
            if prev is not None:
                rel = abs(prev - s.bound) / (1.0 + abs(prev))
                if rel < self.cfg.loop.improvement_tol and s.cuts_added == 0:
                    break
            prev = s.bound
        return self.history
