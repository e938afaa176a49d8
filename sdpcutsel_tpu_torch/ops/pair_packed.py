"""The reference's tiered packed pair layout, and the wrapper of its scoring
kernel (``csrc/pair_packed.cu``) with its plain PyTorch twin.

The layout (port of ``sdpcutsel_tpu/ops/pair_packed.py``, 66 <= n <= 128)
packs the pairs (i, j) of ``np.triu_indices(n, 1)`` into rows of 128 lanes,
1, 2 or 4 pairs a row, by tier of j:

    tier 0: j <  n-65          1 pair a row,  l = lane
    tier 1: j in [n-65, n-33)  2 pairs a row, l = n-64 + lane % 64
    tier 2: j >= n-33          4 pairs a row, l = n-32 + lane % 32

Each tier's rows are padded to a multiple of 128 with pair id -1.  Slot
order is [tier 0 | tier 1 | tier 2], each row-major; slot (row, lane) of a
tier holds the triple (iu[p], ju[p], l) and is valid when p >= 0, l > j and
l < n.  The solver swaps this order in for the lexicographic table when the
reference would (``CutConfig(pair_layout="packed")``), because the order
decides the selection's tie-breaks.

For every slot both the kernel and the twin return

    nn   = scale * relu(MLP([tri(Q_rho)/scale | x_rho | tri(X_rho)]))
    feas = -lambda_min(Z(rho))   after SWEEPS cyclic Jacobi sweeps,

the per-triple semantics of ``pair_score``, and -inf for both at invalid
slots (the reference computes those from zero padding and masks them before
selection).  The kernel scores only the valid slots, in dense tiles read
from ``PackedLayout.valid_slots``, with ``pair_score``'s device code, so a
triple gets the same bits from both.  It replaces the Pallas TPU kernel
``sdpcutsel_tpu/ops/pair_packed.py::_packed_kernel`` (launched from
``_tier_score``) plus the XLA MLP over its feature planes.

Device rule: CPU tensors take the twin; CUDA tensors launch the kernel; any
other device raises.  ``packed_score.launches`` counts kernel launches.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import _build
from ..models.scorer import MLPScorer
from .fused_score import offset_refusal
from .pair_score import SWEEPS, pair_score_plain

LANES = 128     # slots of a row, and the multiple each tier's rows are padded to


@functools.lru_cache(maxsize=8)
def build_packed_pair_layout(n: int) -> dict:
    """The reference's packed layout (numpy).  Returns iu, ju (all pairs),
    tiers = (t0, t1, t2) with t_t an (R_t, 1 | 2 | 4) int32 array of pair ids
    (-1 pads), lmaps (each tier's lane -> l map), the matching candidate
    table (slots, 3) and validity mask (slots,), and the valid slots in
    order (the kernel's dense tiles).  Callers must not write to the cached
    arrays."""
    assert 66 <= n <= LANES, (
        "tiered packing targets the large-n regime (lane windows assume "
        f"n >= 66); got {n} — use the lexicographic table below that")
    iu, ju = np.triu_indices(n, k=1)
    cut1, cut2 = max(0, n - 65), max(0, n - 33)

    def rows_for(mask, per_row):
        ids = np.nonzero(mask)[0].astype(np.int32)
        R = -(-max(len(ids), 1) // per_row)
        R = -(-R // LANES) * LANES
        out = np.full((R, per_row), -1, np.int32)
        out.ravel()[: len(ids)] = ids
        return out

    t0 = rows_for(ju < cut1, 1)
    t1 = rows_for((ju >= cut1) & (ju < cut2), 2)
    t2 = rows_for(ju >= cut2, 4)

    ll = np.arange(LANES, dtype=np.int32)
    lmaps = [ll, (n - 64) + (ll % 64), (n - 32) + (ll % 32)]
    tables, valids = [], []
    for rows, lmap in zip((t0, t1, t2), lmaps):
        sub = LANES // rows.shape[1]
        pair_of_lane = rows[:, ll // sub]              # (R, 128) pair ids
        ok = pair_of_lane >= 0
        p = np.where(ok, pair_of_lane, 0)
        tab = np.stack([iu[p], ju[p],
                        np.broadcast_to(np.minimum(lmap, n - 1), p.shape)], axis=-1)
        valid = ok & (lmap[None, :] > ju[p]) & (lmap[None, :] < n)
        tables.append(tab.reshape(-1, 3))
        valids.append(valid.reshape(-1))
    valid = np.concatenate(valids, axis=0)
    return {
        "iu": iu.astype(np.int32), "ju": ju.astype(np.int32),
        "tiers": (t0, t1, t2), "lmaps": lmaps,
        "table": np.concatenate(tables, axis=0).astype(np.int32),
        "valid": valid, "valid_slots": np.flatnonzero(valid).astype(np.int32),
    }


@dataclasses.dataclass(frozen=True)
class PackedLayout:
    """``build_packed_pair_layout(n)`` on a device: what the kernel reads
    (tier row counts, the tiers' pair ids concatenated row-major, iu, ju, the
    valid slots) and what selection reads (the slot-ordered table and
    mask)."""
    n: int
    R: tuple          # (R0, R1, R2) rows of each tier
    rows: torch.Tensor   # (R0 + 2 R1 + 4 R2,) int32 pair ids, -1 pads
    iu: torch.Tensor     # (C(n, 2),) int32
    ju: torch.Tensor
    table: torch.Tensor  # (slots, 3) int32
    valid: torch.Tensor  # (slots,) bool
    valid_slots: torch.Tensor  # (C(n, 3),) int32 slots where valid, ascending

    @property
    def slots(self) -> int:
        return self.table.shape[0]


def packed_layout(n: int, device) -> PackedLayout:
    lay = build_packed_pair_layout(n)
    t = functools.partial(torch.as_tensor, device=device)
    return PackedLayout(
        n=n, R=tuple(r.shape[0] for r in lay["tiers"]),
        rows=t(np.concatenate([r.ravel() for r in lay["tiers"]])),
        iu=t(lay["iu"]), ju=t(lay["ju"]), table=t(lay["table"]), valid=t(lay["valid"]),
        valid_slots=t(lay["valid_slots"]))


def slot_triples(lay: PackedLayout):
    """(i, j, l, valid), each (slots,), decoded from the tiers as the kernel
    decodes them: slot -> (row, lane) -> tier -> pair id and lane map."""
    n, (R0, R1, _) = lay.n, lay.R
    s = torch.arange(lay.slots, device=lay.rows.device)
    g, lane = s // LANES, s % LANES

    def by_tier(v0, v1, v2):
        return torch.where(g >= R0 + R1, v2, torch.where(g >= R0, v1, v0))

    per = by_tier(1, 2, 4)
    sub = LANES // per
    r = g - by_tier(0, R0, R0 + R1)
    p = lay.rows[by_tier(0, R0, R0 + 2 * R1) + r * per + lane // sub].long()
    l = by_tier(0, n - 64, n - 32) + lane % sub
    pc = p.clamp(min=0)
    i, j = lay.iu[pc].long(), lay.ju[pc].long()
    return i, j, l, (p >= 0) & (l > j) & (l < n)


def packed_score_plain(x, X, Q, lay: PackedLayout, mlp: MLPScorer):
    """Twin: ``pair_score_plain`` on the valid slots' triples, -inf at the
    rest."""
    i, j, l, valid = slot_triples(lay)
    table = torch.stack([i, j, l], dim=1)[valid].to(torch.int32)
    nn_v, feas_v = pair_score_plain(x, X, Q, table, mlp)
    nn = torch.full((lay.slots,), -torch.inf, dtype=x.dtype, device=x.device)
    feas = nn.clone()
    nn[valid] = nn_v
    feas[valid] = feas_v
    return nn, feas


def _launch(x, X, Q, lay: PackedLayout, mlp: MLPScorer):
    n = x.shape[0]
    weights = [t.detach() for lin in mlp.layers for t in (lin.weight, lin.bias)]
    if [tuple(w.shape) for w in weights[::2]] != [(64, 15), (64, 64), (1, 64)]:
        raise ValueError("pair_packed kernel takes a 15-64-64-1 MLP")
    why = offset_refusal("pair_packed", lay.slots, 1)
    if why is not None:
        raise ValueError(why)
    for t in (x, X, Q, *weights):
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError("pair_packed kernel takes float32 tensors on one device")
    for t in (lay.valid_slots, lay.rows, lay.iu, lay.ju):
        if t.dtype != torch.int32 or t.device != x.device:
            raise ValueError("pair_packed kernel takes the layout's int32 tensors on x's device")
    lib = _build.lib()
    args = [t.contiguous() for t in (lay.valid_slots, lay.rows, lay.iu, lay.ju, x, X, Q,
                                     *weights)]
    nn = torch.empty((lay.slots,), dtype=torch.float32, device=x.device)
    feas = torch.empty_like(nn)
    err = lib.pair_packed_launch(
        lay.slots, lay.valid_slots.shape[0], n, lay.R[0], lay.R[1], SWEEPS,
        *(t.data_ptr() for t in args),
        nn.data_ptr(), feas.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "pair_packed_launch")
    packed_score.launches += 1
    return nn, feas


def packed_score(x, X, Q, lay: PackedLayout, mlp: MLPScorer):
    """(nn, feas), each (slots,), in the packed layout's slot order."""
    n = x.shape[0]
    if n != lay.n or X.shape != (n, n) or Q.shape != (n, n):
        raise ValueError(f"packed_score: x, X, Q of n = {n} and a layout of n = {lay.n}")
    if x.device.type == "cpu":
        return packed_score_plain(x, X, Q, lay, mlp)
    if x.device.type == "cuda":
        return _launch(x, X, Q, lay, mlp)
    raise ValueError(f"packed_score: no kernel for device {x.device}")


packed_score.launches = 0
