"""Wrapper of the dense k = 3 scoring kernel (``csrc/pair_score.cu``) and its
plain PyTorch twin.

For every triple of a (T, 3) candidate table (the lexicographic
``combinations_table(n, 3)`` on the main path) both return

    nn   = scale * relu(MLP([tri(Q_rho)/scale | x_rho | tri(X_rho)]))
    feas = -lambda_min(Z(rho))   after ``sweeps`` cyclic Jacobi sweeps
                                 (SWEEPS = 5 unless the caller says).

The kernel replaces the Pallas TPU kernel
``sdpcutsel_tpu/ops/pair_score.py::_pair_kernel`` (launched from
``pair_score_fused``) plus the XLA MLP over its feature planes.  The TPU
kernel scored in a padded pair layout; here every lane of a warp gathers its
own triple, so the candidate order is the table's own, and the warp runs the
MLP's two products on the tensor cores in split TF32 (``csrc/score_mma.cuh``).
The pair layout's valid slots run in lexicographic order, so the
lexicographic table selects as the reference's pair route does.

Device rule: CPU tensors take the twin; CUDA tensors launch the kernel; any
other device raises.  ``pair_score.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import _build
from ..models.features import candidate_q_features
from ..models.scorer import MLPScorer
from .fused_score import fused_score_plain

SWEEPS = 5      # Jacobi sweeps on the 4 x 4 Z(rho), as in the reference's scoring


def pair_score_plain(x, X, Q, table, mlp: MLPScorer, sweeps: int = SWEEPS):
    """Twin: features + MLP + struct-of-arrays Jacobi over the table."""
    triQ, scale = candidate_q_features(Q, table)
    return fused_score_plain(x, X, table, triQ, scale, mlp, sweeps)


def _launch(x, X, Q, table, mlp: MLPScorer, sweeps: int):
    T, k = table.shape
    n = x.shape[0]
    weights = [t for lin in mlp.layers for t in (lin.weight, lin.bias)]
    if k != 3 or [tuple(w.shape) for w in weights[::2]] != [(64, 15), (64, 64), (1, 64)]:
        raise ValueError("pair_score kernel takes k = 3 and a 15-64-64-1 MLP")
    if table.dtype != torch.int32:
        raise ValueError("pair_score kernel takes an int32 table")
    for t in (x, X, Q, *weights):
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError("pair_score kernel takes float32 tensors on one device")
    if table.device != x.device or X.shape != (n, n) or Q.shape != (n, n):
        raise ValueError("pair_score kernel: shape or device mismatch")
    lib = _build.lib()
    args = [t.contiguous() for t in (table, x, X, Q, *weights)]
    nn = torch.empty((T,), dtype=torch.float32, device=x.device)
    feas = torch.empty_like(nn)
    err = lib.pair_score_launch(
        T, n, sweeps, *(t.data_ptr() for t in args), nn.data_ptr(),
        feas.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "pair_score_launch")
    pair_score.launches += 1
    return nn, feas


def pair_score(x, X, Q, table, mlp: MLPScorer, sweeps: int = SWEEPS):
    """(nn, feas), each (T,), for the candidates of ``table``."""
    if x.device.type == "cpu":
        return pair_score_plain(x, X, Q, table, mlp, sweeps)
    if x.device.type == "cuda":
        return _launch(x, X, Q, table, mlp, sweeps)
    raise ValueError(f"pair_score: no kernel for device {x.device}")


pair_score.launches = 0
