"""The run configuration tree (port of ``sdpcutsel_tpu/config.py``).

Same dataclasses, field names, types and defaults as the reference, so one
set of keyword arguments builds either package's config.  A run is described
by one ``RunConfig`` value.  Fields the port does not read yet keep the
reference's defaults.  ``apply_overrides`` takes the CLI's repeated
``--set section.field=value`` strings, as the reference's does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class LPConfig:
    """Restarted-PDHG LP solver settings (lp/pdhg.py)."""

    max_iters: int = 20_000          # cap on PDHG iterations per solve
    check_every: int = 100           # iterations per kernel block / KKT check
    restart_period: int = 500        # fixed restart period (iterations)
    tol: float = 1e-6                # relative KKT error target
    feas_tol: float = 1e-6           # relative primal infeasibility target
    omega0: float = 1.0              # initial primal weight
    step_scale: float = 0.95         # eta = step_scale / ||K||
    power_iters: int = 30            # power-method iterations for ||K||
    use_kernel: str = "auto"         # "auto"/"on": K2, or the dense route for the certifier's
                                     # pool, on CUDA, raising outside both; "off": plain
    dtype: str = "float32"


@dataclass(frozen=True)
class CutConfig:
    """Candidate cut family and pool management."""

    k: int = 3                       # submatrix dimension (2..5)
    sel_size: int = 20               # candidates selected per round
    capacity: int = 1024             # fixed cut-pool capacity (masked buffer)
    viol_tol: float = 1e-4           # -lambda_min threshold to emit a cut
    purge_slack_tol: float = 1e-3    # purge cuts with slack above this and ~0 dual
    purge: bool = True
    pair_layout: str = "auto"        # BoxQP k = 3 route: "auto", "on", "off", "packed"
    sel_gate: str = "residual"       # QCQP re-selection gate: "residual", "cooldown", "none"
    gate_eta: float = 0.5            # "residual" gate threshold fraction
    sel_cooldown: int = 2            # "cooldown" gate: rounds a pick stays masked
    cooldown_kkt_tol: float = 1e-3   # the cooldown mask applies above this KKT error
    diversity_alpha: float = 1e-4    # > 0: support-diverse greedy selection


@dataclass(frozen=True)
class ScorerConfig:
    """Cut-selection strategy: "neural", "feasibility", "combined",
    "random", "optimality" or "triangle" (k = 3 only)."""

    strategy: str = "neural"
    weights_path: Optional[str] = None   # default: bundled artifact for this k
    hidden: Tuple[int, ...] = (64, 64)
    seed: int = 0


@dataclass(frozen=True)
class LoopConfig:
    """Cutting-plane round controller."""

    rounds: int = 20
    use_scan: bool = False           # all rounds with no per-round certificate
    improvement_tol: float = 1e-5    # stop when relative bound improvement is below
    polish_iters: int = 0            # > 0: final tighter LP re-solve with this budget
    checkpoint_every: int = 0        # > 0: snapshot every this many rounds of run()
    checkpoint_dir: Optional[str] = None
    steer_eps: float = 0.0           # > 0: vertex steering of the scoring point
    steer_iters: int = 4000


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout (instance axis, candidate axis), kept for the
    reference's field list: neither package reads ``cfg.mesh``.  The batched
    round takes its mesh from ``parallel.mesh.make_mesh(data, cand)``:
    logical on one process, one rank a device over a process group."""

    data: int = 1
    cand: int = 1


@dataclass(frozen=True)
class RunConfig:
    lp: LPConfig = field(default_factory=LPConfig)
    cuts: CutConfig = field(default_factory=CutConfig)
    scorer: ScorerConfig = field(default_factory=ScorerConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    seed: int = 0
    debug: bool = False


def override(cfg, **kwargs):
    """Functional update helper: override(cfg, lp=override(cfg.lp, tol=1e-7))."""
    return dataclasses.replace(cfg, **kwargs)


def _coerce(value: str, current):
    """Parse a CLI string to the type of the field it replaces."""
    if isinstance(current, bool):
        if value.lower() in ("1", "true", "yes", "on"):
            return True
        if value.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"expected a boolean, got {value!r}")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        return tuple(int(v) for v in value.split(",") if v)
    return value  # str / Optional[str]


def apply_overrides(cfg: RunConfig, assignments) -> RunConfig:
    """Apply ``section.field=value`` strings (e.g. from repeated CLI --set
    flags) to a RunConfig: apply_overrides(cfg, ["lp.check_every=50",
    "cuts.purge=false", "scorer.hidden=32,32", "seed=7"])."""
    for a in assignments or ():
        try:
            path, value = a.split("=", 1)
        except ValueError:
            raise ValueError(f"override {a!r} is not of form key=value")
        parts = path.split(".")
        if len(parts) == 1:
            (field,) = parts
            cur = getattr(cfg, field)  # raises AttributeError on bad name
            cfg = dataclasses.replace(cfg, **{field: _coerce(value, cur)})
        elif len(parts) == 2:
            section, field = parts
            sec = getattr(cfg, section)
            cur = getattr(sec, field)
            cfg = dataclasses.replace(
                cfg, **{section: dataclasses.replace(
                    sec, **{field: _coerce(value, cur)})})
        else:
            raise ValueError(f"override path too deep: {path!r}")
    return cfg
