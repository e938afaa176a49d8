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

The scoring kernels (K1, K3 and this one) read candidate c's rows at 32-bit
offsets (``width c + a``): ``offset_refusal`` is the rule of one launch.
K1's and this kernel's wrappers score a larger table in several launches
(``launch_ranges``), each on a contiguous view of the table and of its
outputs below 2^31 words; a candidate's scores depend on its own row alone,
so the split changes no bit.

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

OFFSET_LIMIT = 2 ** 31      # the scoring kernels' int offsets: width c + a < 2^31


def offset_refusal(kernel: str, rows: int, width: int) -> str | None:
    """Why a scoring kernel does not take ``rows`` candidates whose widest
    array has ``width`` words a candidate (K1's table: 3; K3's slots: 1;
    K4's triQ: k (k + 1) / 2, wider than its table's k), or None where it
    does: the kernels read candidate c at the 32-bit offset width c + a, so
    rows x width must stay below 2^31 (k = 3 from n ~ 1,627 on, where
    C(n, 3) triples take 3 words each)."""
    if rows * width >= OFFSET_LIMIT:
        return (f"{kernel} kernel: {rows} candidates x {width} words = {rows * width} reach "
                f"its 32-bit offsets' limit of 2^31")
    return None


def launch_ranges(rows: int, width: int, max_rows: int | None = None) -> list[tuple[int, int]]:
    """The launches that score ``rows`` candidates whose widest array has
    ``width`` words a candidate: [start, stop) ranges covering [0, rows) in
    order, each of at most ``max_rows`` rows (by default the most whose
    rows x width stay below 2^31, ``offset_refusal``'s rule), in near-equal
    parts.  One range where one launch takes the table (none for no rows)."""
    most = (OFFSET_LIMIT - 1) // width
    most = most if max_rows is None else min(most, max_rows)
    if most < 1:
        raise ValueError(f"launch_ranges: max_rows must be >= 1, got {max_rows}")
    parts = -(-rows // most)
    return [(rows * i // parts, rows * (i + 1) // parts) for i in range(parts)]


def fused_score_plain(x, X, table, triQ, scale, mlp: MLPScorer, sweeps: int):
    """Twin: features + MLP + struct-of-arrays Jacobi over the table."""
    nn = scale * torch.relu(mlp(candidate_features(triQ, x, X, table)))
    return nn, eigen.feasibility_scores_from_point(x, X, table, sweeps)


def _launch(x, X, table, triQ, scale, mlp: MLPScorer, sweeps: int,
            max_rows: int | None = None):
    T, k = table.shape
    n = x.shape[0]
    weights = [t.detach() for lin in mlp.layers for t in (lin.weight, lin.bias)]
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
    table, triQ, scale = (t.contiguous() for t in (table, triQ, scale))
    shared = [t.contiguous() for t in (x, X)]
    weights = [t.contiguous() for t in weights]
    nn = torch.empty((T,), dtype=torch.float32, device=x.device)
    feas = torch.empty_like(nn)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for s, e in launch_ranges(T, k * (k + 1) // 2, max_rows):
        rows = (table[s:e], *shared, triQ[s:e], scale[s:e], *weights)
        err = lib.fused_score_launch(e - s, n, k, sweeps, *(t.data_ptr() for t in rows),
                                     nn[s:e].data_ptr(), feas[s:e].data_ptr(), stream)
        _build.check(err, "fused_score_launch")
        fused_score.launches += 1
    return nn, feas


def fused_score(x, X, table, triQ, scale, mlp: MLPScorer, sweeps: int, *,
                _max_rows: int | None = None):
    """(nn, feas), each (T,), for the candidates of ``table``, in the
    launches of ``launch_ranges`` (``_max_rows`` forces smaller ones:
    measurements only)."""
    if x.device.type == "cpu":
        return fused_score_plain(x, X, table, triQ, scale, mlp, sweeps)
    if x.device.type == "cuda":
        return _launch(x, X, table, triQ, scale, mlp, sweeps, _max_rows)
    raise ValueError(f"fused_score: no kernel for device {x.device}")


fused_score.launches = 0
fused_score.plain_launches = 0    # calls on CUDA tensors that asked for the twin
