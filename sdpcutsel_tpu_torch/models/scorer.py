"""MLP cut scorer (port of ``sdpcutsel_tpu/models/scorer.py``, inference).

One dense relu MLP per submatrix dimension k (k = 3: 15 -> 64 -> 64 -> 1).
The trained weights ship as ``artifacts/mlp_k{k}.npz``, converted once from
the JAX package's flax msgpack artifacts: for k = 2..5,
``np.savez(artifact_path(k), **params_from_flax(params))`` with ``params``
the first value that the reference's ``models/scorer.py::load_params(k)``
returns (run with JAX on the CPU).  ``tests/test_torch_params.py`` holds the
files equal to the reference's.

A missing artifact raises: there is no silent random fallback.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

_ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "artifacts")


def artifact_path(k: int) -> str:
    return os.path.join(_ARTIFACT_DIR, f"mlp_k{k}.npz")


def params_from_flax(params) -> dict[str, np.ndarray]:
    """Flatten flax Dense parameters ``{'params': {'Dense_i': {'kernel',
    'bias'}}}`` into ``{'Dense_i.kernel': (in, out), 'Dense_i.bias': (out,)}``
    float32 numpy arrays."""
    layers = params["params"]
    return {f"{name}.{leaf}": np.asarray(layers[name][leaf], np.float32)
            for name in layers for leaf in ("kernel", "bias")}


def load_params(k: int, path: str | None = None) -> dict[str, np.ndarray]:
    """The trained weights for dimension k, as written by params_from_flax."""
    path = path or artifact_path(k)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no MLP weights for k={k} at {path}")
    with np.load(path) as z:
        return {name: z[name] for name in z.files}


class MLPScorer(nn.Module):
    """feats (B, d) -> predicted scale-normalized improvement (B,)."""

    def __init__(self, params: dict[str, np.ndarray], device):
        super().__init__()
        depth = len(params) // 2
        layers = []
        for i in range(depth):
            kernel = params[f"Dense_{i}.kernel"]
            lin = nn.Linear(kernel.shape[0], kernel.shape[1], device=device)
            with torch.no_grad():
                lin.weight.copy_(torch.as_tensor(kernel.T))
                lin.bias.copy_(torch.as_tensor(params[f"Dense_{i}.bias"]))
            layers.append(lin)
        self.layers = nn.ModuleList(layers)
        self.requires_grad_(False)

    def forward(self, x):
        for lin in self.layers[:-1]:
            x = torch.relu(lin(x))
        return self.layers[-1](x).squeeze(-1)
