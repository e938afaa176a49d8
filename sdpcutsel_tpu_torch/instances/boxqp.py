"""BoxQP "spar" instances: the generator and the ``.in`` reader (port of
``sdpcutsel_tpu/instances/boxqp.py``, numpy only).

    max f(x) = 1/2 x^T Q x + c^T x,   x in [0,1]^n

``spar{n:03d}-{density}-{seed}``: Q symmetric with integer entries uniform in
[-50, 50] (off-diagonal nonzero with probability density/100), c integer
uniform in [-100, 100], drawn from a Philox stream keyed by the name, so the
arrays equal the reference's.

File format (the standard BoxQP ``.in`` layout, ``data/boxqp/*.in``):

    line 1: n
    line 2: c_1 ... c_n
    lines 3..n+2: rows of Q (n values each)
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class BoxQPInstance:
    name: str
    Q: np.ndarray   # (n, n) symmetric float64
    c: np.ndarray   # (n,) float64

    @property
    def n(self) -> int:
        return int(self.c.shape[0])


_NAME_RE = re.compile(r"^spar(\d+)-(\d+)-(\d+)$")


def generate_spar(n: int, density: int, seed: int) -> BoxQPInstance:
    """A spar-style instance, deterministic in (n, density, seed)."""
    name = f"spar{n:03d}-{density}-{seed}"
    key = (n << 32) | (density << 16) | seed
    rng = np.random.Generator(np.random.Philox(key=[key, 0x5DC]))
    Q = np.zeros((n, n), dtype=np.float64)
    iu = np.triu_indices(n, k=1)
    m = iu[0].shape[0]
    mask = rng.random(m) < (density / 100.0)
    vals = rng.integers(-50, 51, size=m).astype(np.float64) * mask
    Q[iu] = vals
    Q = Q + Q.T
    diag = rng.integers(-50, 51, size=n).astype(np.float64)
    np.fill_diagonal(Q, diag)
    c = rng.integers(-100, 101, size=n).astype(np.float64)
    return BoxQPInstance(name=name, Q=Q, c=c)


def parse_boxqp(path: str, name: str | None = None) -> BoxQPInstance:
    """Read the standard BoxQP ``.in`` format (see the module docstring);
    an asymmetric Q is symmetrized."""
    with open(path) as f:
        tokens = f.read().split()
    n = int(tokens[0])
    vals = np.asarray(tokens[1:], dtype=np.float64)
    if vals.shape[0] != n + n * n:
        raise ValueError(
            f"{path}: expected {n + n * n} values after n={n}, got {vals.shape[0]}")
    c = vals[:n]
    Q = vals[n:].reshape(n, n)
    if not np.allclose(Q, Q.T):
        Q = 0.5 * (Q + Q.T)
    if name is None:
        name = os.path.splitext(os.path.basename(path))[0]
    return BoxQPInstance(name=name, Q=Q, c=c)


def load_or_generate(name: str, data_dir: str | None = None) -> BoxQPInstance:
    """Read ``{data_dir}/{name}.in`` if it exists, else generate the instance
    from its name.  Unlike the reference, it writes no file."""
    if data_dir is not None:
        path = os.path.join(data_dir, f"{name}.in")
        if os.path.exists(path):
            return parse_boxqp(path, name=name)
    m = _NAME_RE.match(name)
    if m is None:
        raise ValueError(f"cannot generate unknown instance name: {name}")
    return generate_spar(*(int(g) for g in m.groups()))
