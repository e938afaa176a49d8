"""Wrapper of the generic scoring kernel (``csrc/fused_score.cu``) and its
plain PyTorch twin.

For every row rho of a (T, k) candidate table, k = 2..5, both return

    nn   = scale * relu(MLP([triQ | x_rho | tri(X_rho)]))
    feas = -lambda_min(Z(rho))   after ``sweeps`` cyclic Jacobi sweeps,

with triQ, scale = ``candidate_q_features(Q, table)`` computed once per
instance.  Rows may repeat an index (the QCQP clique tables pad short
subsets that way).  The kernel replaces the Pallas TPU kernel
``sdpcutsel_tpu/ops/fused_score.py::_kernel`` (launched from
``fused_score``), which needed the table padded to its 1024-row block; this
one takes the table as it is.  It runs K1's and K3's tensor-core body
(``csrc/score_mma.cuh``), one instantiation per k.

Device rule: CPU tensors take the twin; CUDA tensors launch the kernel; any
other device raises.  ``fused_score.launches`` counts kernel launches, and
``fused_score.plain_launches`` the twin's calls on CUDA tensors that a caller
asked for (the batched round's ``use_fused=False``).
"""

from __future__ import annotations

import torch

from .. import _build
from ..cuts import eigen
from ..models.features import candidate_features
from ..models.scorer import MLPScorer


def fused_score_plain(x, X, table, triQ, scale, mlp: MLPScorer, sweeps: int):
    """Twin: features + MLP + struct-of-arrays Jacobi over the table."""
    nn = scale * torch.relu(mlp(candidate_features(triQ, x, X, table)))
    return nn, eigen.feasibility_scores_from_point(x, X, table, sweeps)


def _launch(x, X, table, triQ, scale, mlp: MLPScorer, sweeps: int):
    T, k = table.shape
    n = x.shape[0]
    weights = [t for lin in mlp.layers for t in (lin.weight, lin.bias)]
    F = k * (k + 1) + k
    if k not in (2, 3, 4, 5):
        raise ValueError(f"fused_score kernel takes k = 2..5, got {k}")
    if [tuple(w.shape) for w in weights[::2]] != [(64, F), (64, 64), (1, 64)]:
        raise ValueError(f"fused_score kernel takes a {F}-64-64-1 MLP for k = {k}")
    if table.dtype != torch.int32:
        raise ValueError("fused_score kernel takes an int32 table")
    for t in (x, X, triQ, scale, *weights):
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError("fused_score kernel takes float32 tensors on one device")
    if (table.device != x.device or X.shape != (n, n)
            or triQ.shape != (T, k * (k + 1) // 2) or scale.shape != (T,)):
        raise ValueError("fused_score kernel: shape or device mismatch")
    lib = _build.lib()
    args = [t.contiguous() for t in (table, x, X, triQ, scale, *weights)]
    nn = torch.empty((T,), dtype=torch.float32, device=x.device)
    feas = torch.empty_like(nn)
    err = lib.fused_score_launch(
        T, n, k, sweeps, *(t.data_ptr() for t in args), nn.data_ptr(),
        feas.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_score_launch")
    fused_score.launches += 1
    return nn, feas


def fused_score(x, X, table, triQ, scale, mlp: MLPScorer, sweeps: int):
    """(nn, feas), each (T,), for the candidates of ``table``."""
    if x.device.type == "cpu":
        return fused_score_plain(x, X, table, triQ, scale, mlp, sweeps)
    if x.device.type == "cuda":
        return _launch(x, X, table, triQ, scale, mlp, sweeps)
    raise ValueError(f"fused_score: no kernel for device {x.device}")


fused_score.launches = 0
fused_score.plain_launches = 0    # calls on CUDA tensors that asked for the twin
