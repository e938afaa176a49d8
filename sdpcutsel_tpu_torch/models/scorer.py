"""MLP cut scorer (port of ``sdpcutsel_tpu/models/scorer.py``).

One dense relu MLP per submatrix dimension k (k = 3: 15 -> 64 -> 64 -> 1).
Weights are a dict ``{'Dense_i.kernel': (in, out), 'Dense_i.bias': (out,)}``
of float32 arrays, stored as ``.npz``.  The shipped ``artifacts/mlp_k{k}.npz``
were converted once from the JAX package's flax msgpack artifacts: for
k = 2..5, ``np.savez(artifact_path(k), **params_from_flax(params))`` with
``params`` the first value that the reference's
``models/scorer.py::load_params(k)`` returns (run with JAX on the CPU).
``tests/test_torch_params.py`` holds the files equal to the reference's.
``models/train.py`` trains new ones (``init_params``, a trainable
``MLPScorer``, ``params_of``, ``save_params``).

A missing artifact raises: there is no silent random fallback.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from .features import feature_dim

# flax's lecun_normal: a normal cut at +-2 std, scaled so that the cut
# distribution's std is 1 / sqrt(fan_in) (the std of N(0, 1) cut at +-2)
_TRUNC_STD = 0.87962566103423978

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


def init_params(k: int, hidden=(64, 64), seed: int = 0,
                generator: torch.Generator | None = None) -> dict[str, np.ndarray]:
    """Fresh weights for dimension k, as flax's ``Dense`` defaults draw them
    (the reference's ``init_params``): each kernel (in, out) lecun_normal,
    a normal of std 1 / sqrt(in) / 0.8796... cut at +-2 std, each bias 0.
    Drawn on the CPU from ``generator`` (default: seeded with ``seed``)."""
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    widths = [feature_dim(k), *hidden, 1]
    params = {}
    for i, (fan_in, fan_out) in enumerate(zip(widths[:-1], widths[1:])):
        std = 1.0 / np.sqrt(fan_in) / _TRUNC_STD
        kernel = torch.empty((fan_in, fan_out), dtype=torch.float32)
        nn.init.trunc_normal_(kernel, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        params[f"Dense_{i}.kernel"] = kernel.numpy()
        params[f"Dense_{i}.bias"] = np.zeros((fan_out,), np.float32)
    return params


def save_params(params: dict[str, np.ndarray], path: str):
    """Write ``params`` (the ``params_of`` layout) to the ``.npz`` at path."""
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **params)


def load_params(k: int, path: str | None = None) -> dict[str, np.ndarray]:
    """The trained weights for dimension k, in the layout of params_from_flax
    and save_params."""
    path = path or artifact_path(k)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no MLP weights for k={k} at {path}")
    with np.load(path) as z:
        return {name: z[name] for name in z.files}


class MLPScorer(nn.Module):
    """feats (B, d) -> predicted scale-normalized improvement (B,).  Frozen
    unless ``trainable``; the scoring kernels read ``layers``' detached
    values either way."""

    def __init__(self, params: dict[str, np.ndarray], device, trainable: bool = False):
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
        self.requires_grad_(trainable)

    def forward(self, x):
        for lin in self.layers[:-1]:
            x = torch.relu(lin(x))
        return self.layers[-1](x).squeeze(-1)


def params_of(mlp: MLPScorer) -> dict[str, np.ndarray]:
    """The weights of ``mlp`` as float32 numpy arrays in the ``.npz`` layout."""
    params = {}
    for i, lin in enumerate(mlp.layers):
        params[f"Dense_{i}.kernel"] = np.ascontiguousarray(lin.weight.detach().cpu().numpy().T)
        params[f"Dense_{i}.bias"] = lin.bias.detach().cpu().numpy().copy()
    return params
