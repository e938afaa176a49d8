"""Sparse QCQP instances (port of ``sdpcutsel_tpu/instances/qcqp.py``,
numpy only: the instance, its generators, the batched family
``generate_qcqp_family`` and ``load_or_generate_qcqp``).

    max 1/2 x'Q0 x + c0'x
    s.t. 1/2 x'Qi x + ci'x <= bi   (i = 1..m),   x in [0,1]^n

Instances are made from their names, ``qcqp{n:03d}-{density}-{m}-{seed}``
(random sparsity) and ``qcqpband{n:03d}-{bandwidth}-{m}-{seed}`` (banded),
with the reference's Philox streams, so the arrays equal the reference's.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class QCQPInstance:
    name: str
    Q0: np.ndarray                 # (n, n) symmetric
    c0: np.ndarray                 # (n,)
    Qs: tuple = field(default=())  # tuple of (n, n) symmetric
    cs: tuple = field(default=())  # tuple of (n,)
    bs: tuple = field(default=())  # tuple of float

    @property
    def n(self) -> int:
        return int(self.c0.shape[0])

    @property
    def m(self) -> int:
        return len(self.bs)

    def sparsity_graph(self):
        """Aggregate edge set {(i, j): some Q has a nonzero there}, i < j."""
        agg = np.abs(self.Q0.copy())
        for Q in self.Qs:
            agg += np.abs(Q)
        iu = np.triu_indices(self.n, k=1)
        mask = agg[iu] != 0
        return list(zip(iu[0][mask].tolist(), iu[1][mask].tolist()))


_NAME_RE = re.compile(r"^qcqp(\d+)-(\d+)-(\d+)-(\d+)$")          # n-density-m-seed
_BAND_RE = re.compile(r"^qcqpband(\d+)-(\d+)-(\d+)-(\d+)$")      # n-bw-m-seed


def _constraints(rng, n: int, m: int, rand_sym):
    """m constraints, feasible at x0 = 0.25 * ones with slack in [5, 50]."""
    Qs, cs, bs = [], [], []
    x0 = np.full(n, 0.25)
    for _ in range(m):
        Qi = rand_sym()
        ci = rng.integers(-100, 101, size=n).astype(np.float64)
        val = 0.5 * x0 @ Qi @ x0 + ci @ x0
        bs.append(float(val + rng.uniform(5.0, 50.0)))
        Qs.append(Qi)
        cs.append(ci)
    return tuple(Qs), tuple(cs), tuple(bs)


def generate_qcqp(n: int, density: int, m: int, seed: int) -> QCQPInstance:
    """Random sparse QCQP, deterministic in (n, density, m, seed)."""
    name = f"qcqp{n:03d}-{density}-{m}-{seed}"
    key = (n << 40) | (density << 24) | (m << 16) | seed
    rng = np.random.Generator(np.random.Philox(key=[key, 0xDC9]))

    def rand_sparse_sym():
        Q = np.zeros((n, n))
        iu = np.triu_indices(n, k=1)
        nm = iu[0].shape[0]
        mask = rng.random(nm) < (density / 100.0)
        Q[iu] = rng.integers(-50, 51, size=nm) * mask
        Q = Q + Q.T
        np.fill_diagonal(Q, rng.integers(-50, 51, size=n))
        return Q.astype(np.float64)

    Q0 = rand_sparse_sym()
    c0 = rng.integers(-100, 101, size=n).astype(np.float64)
    return QCQPInstance(name, Q0, c0, *_constraints(rng, n, m, rand_sparse_sym))


def generate_qcqp_band(n: int, bandwidth: int, m: int, seed: int) -> QCQPInstance:
    """Banded sparse QCQP: nonzeros only where |i - j| <= bandwidth (about
    70% of the in-band entries), deterministic in the arguments."""
    name = f"qcqpband{n:03d}-{bandwidth}-{m}-{seed}"
    key = (n << 40) | (bandwidth << 24) | (m << 16) | (seed << 1) | 1
    rng = np.random.Generator(np.random.Philox(key=[key, 0xBA2D]))

    def rand_band_sym():
        Q = np.zeros((n, n))
        for d in range(1, bandwidth + 1):
            v = rng.integers(-50, 51, size=n - d).astype(np.float64)
            v *= rng.random(n - d) < 0.7
            idx = np.arange(n - d)
            Q[idx, idx + d] = v
            Q[idx + d, idx] = v
        Q[np.arange(n), np.arange(n)] = rng.integers(-50, 51, size=n).astype(np.float64)
        return Q

    Q0 = rand_band_sym()
    c0 = rng.integers(-100, 101, size=n).astype(np.float64)
    return QCQPInstance(name, Q0, c0, *_constraints(rng, n, m, rand_band_sym))


def generate_qcqp_family(n: int, density: int, m: int, seed: int,
                         B: int) -> list[QCQPInstance]:
    """B instances sharing one sparsity pattern, deterministic in the
    arguments: each member rescales the base instance's objective and
    constraint quadratics entrywise on the same support (zeros stay zero)
    and redraws the linear terms; right-hand sides are drawn feasible at
    x0 = 0.25 * ones.  The batched round needs one clique table for the
    whole batch, hence one sparsity graph."""
    base = generate_qcqp(n, density, m, seed)
    x0 = np.full(n, 0.25)
    out = []
    for b in range(B):
        key = (n << 40) | (density << 24) | (m << 16) | (seed << 8) | (b + 1)
        rng = np.random.Generator(np.random.Philox(key=[key, 0xFA11]))

        def rescale(Q):
            S = rng.uniform(0.5, 1.5, size=Q.shape)
            return Q * (0.5 * (S + S.T))

        Q0 = rescale(base.Q0)
        c0 = rng.integers(-100, 101, size=n).astype(np.float64)
        Qs, cs, bs = [], [], []
        for Qi in base.Qs:
            Qb = rescale(Qi)
            cb = rng.integers(-100, 101, size=n).astype(np.float64)
            Qs.append(Qb)
            cs.append(cb)
            bs.append(float(0.5 * x0 @ Qb @ x0 + cb @ x0 + rng.uniform(5.0, 50.0)))
        out.append(QCQPInstance(f"{base.name}-fam{b}", Q0, c0, tuple(Qs), tuple(cs), tuple(bs)))
    return out


def load_or_generate_qcqp(name: str) -> QCQPInstance:
    """The instance of a ``qcqp...`` or ``qcqpband...`` name."""
    mt = _BAND_RE.match(name)
    if mt is not None:
        return generate_qcqp_band(*(int(g) for g in mt.groups()))
    mt = _NAME_RE.match(name)
    if mt is None:
        raise ValueError(f"cannot generate unknown QCQP name: {name}")
    return generate_qcqp(*(int(g) for g in mt.groups()))
