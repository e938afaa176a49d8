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
other device raises.  ``pair_score.launches`` counts kernel launches, and
``pair_score.plain_launches`` the twin's calls on CUDA tensors that a caller
asked for (the batched round's ``use_fused=False``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..models.features import candidate_q_features
from ..models.scorer import MLPScorer
from .fused_score import fused_score_plain

SWEEPS = 5      # Jacobi sweeps on the 4 x 4 Z(rho), as in the reference's scoring
_LANES = 128


def build_pair_layout(n: int, pairs_block: int = 128):
    """The reference's pair layout (``sdpcutsel_tpu/ops/pair_score.py::
    build_pair_layout``), numpy: (table (P_pad * 128, 3) int32, valid
    (P_pad * 128,) bool).  Slot p * 128 + l is the triple (pi[p], pj[p],
    min(l, n - 1)) of the p-th pair (i < j, lexicographic; padded pairs
    repeat (0, 1)); it is valid where j < l < n and p < C(n, 2).  The valid
    slots are the lexicographic triples in order.  The batched round's
    ``pair_layout=True`` shards this table (``parallel/sharding.py``)."""
    if not 3 <= n <= _LANES:
        raise ValueError(f"pair layout requires 3 <= n <= {_LANES}, got {n}")
    iu, ju = np.triu_indices(n, k=1)
    P = iu.shape[0]
    P_pad = -(-P // pairs_block) * pairs_block
    pi = np.zeros(P_pad, np.int32)
    pj = np.ones(P_pad, np.int32)
    pi[:P], pj[:P] = iu, ju
    ll = np.arange(_LANES, dtype=np.int32)
    table = np.empty((P_pad, _LANES, 3), np.int32)
    table[:, :, 0] = pi[:, None]
    table[:, :, 1] = pj[:, None]
    table[:, :, 2] = np.minimum(ll, n - 1)[None, :]
    valid = (ll[None, :] > pj[:, None]) & (ll[None, :] < n)
    valid[P:] = False
    return table.reshape(-1, 3), valid.reshape(-1)


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
pair_score.plain_launches = 0    # calls on CUDA tensors that asked for the twin
