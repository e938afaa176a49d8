"""Candidate sharding and the global top-k (port of
``sdpcutsel_tpu/parallel/sharding.py``).

The candidate table is padded to a multiple of the shard count and split
into ``mesh.cand`` contiguous shards.  Each shard scores its rows and keeps
a local top ``sel_size`` (a stable sort: ties go to the lower position, as
``jax.lax.top_k`` breaks them); ``gather_cand`` concatenates the shards'
winners in shard order, which is what the reference's tiled all_gather over
'cand' gives, and the global top-k runs on that small set.  Under ties the
gathered order is the global candidate order, so the selection does not
depend on the number of shards.

On one process every shard is local.  On a distributed mesh
(``mesh.Mesh.distributed``) a rank holds only its own 'cand' shard (the
table helpers below return it), and ``gather_cand`` is an all_gather over
the rank's 'cand' group in rank order, which is shard order: the one
exchange of a round.

Tables are placed on the card unless the caller names another device (a
distributed mesh's default is the rank's device).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.pair_score import build_pair_layout
from ..ops.topk import masked_topk
from . import distributed
from .mesh import Mesh


def pad_table(table: np.ndarray, parts: int):
    """Pad the table to a multiple of ``parts`` rows; padded rows repeat row
    0 and are invalid.  Returns (padded (Tp, k), valid (Tp,))."""
    T = table.shape[0]
    pad = -(-T // parts) * parts - T
    padded = np.concatenate([table, np.tile(table[:1], (pad, 1))]) if pad else table
    valid = np.concatenate([np.ones(T, bool), np.zeros(pad, bool)])
    return padded, valid


def _place(padded: np.ndarray, valid: np.ndarray, mesh: Mesh, device):
    """The whole padded table and mask on one process; a distributed rank's
    own 'cand' shard of them."""
    return (distributed.put_global(padded, mesh, "cand", device),
            distributed.put_global(valid, mesh, "cand", device))


def shard_candidates(table: np.ndarray, mesh: Mesh, block: int = 1, device=None):
    """The padded table (int32) and its valid mask on ``device`` (default:
    the card, or a distributed rank's device), every shard a multiple of
    ``block`` rows (the kernels take any row count, so 1 by default; the
    reference pads to 1024 on the TPU for its kernel).  A distributed rank
    gets its own shard."""
    padded, valid = pad_table(np.asarray(table), mesh.cand * block)
    return _place(np.ascontiguousarray(padded, dtype=np.int32), valid, mesh, device)


def shard_pair_candidates(n: int, mesh: Mesh, block: int = 1024, device=None):
    """The pair layout's table (``ops/pair_score.py::build_pair_layout``)
    padded so that every shard is a multiple of ``block`` (>= 128, so a
    shard holds whole 128-slot pair runs), with its valid mask; placed as
    ``shard_candidates`` places its table."""
    if block % 128:
        raise ValueError(f"block must be a multiple of 128, got {block}")
    table, valid = build_pair_layout(n)
    padded, _ = pad_table(table, mesh.cand * block)
    valid_full = np.zeros(padded.shape[0], bool)
    valid_full[: valid.shape[0]] = valid
    return _place(np.ascontiguousarray(padded), valid_full, mesh, device)


def shards(t: torch.Tensor, mesh: Mesh, dim: int = 0) -> tuple:
    """The ``mesh.cand`` contiguous shards of ``t`` along ``dim`` (views)."""
    size = t.shape[dim]
    if size % mesh.cand:
        raise ValueError(f"{size} rows do not split into {mesh.cand} shards")
    return t.split(size // mesh.cand, dim)


def local_shards(table: torch.Tensor, valid: torch.Tensor, mesh: Mesh) -> list:
    """[(table rows, valid)] of the shards this process scores, in shard
    order: all ``mesh.cand`` of them on one process, a distributed rank's
    own (its whole ``table``)."""
    if mesh.distributed:
        return [(table, valid)]
    return list(zip(shards(table, mesh), shards(valid, mesh)))


def gather_cand(parts: list, dim: int = 0, mesh: Mesh | None = None) -> torch.Tensor:
    """Every shard's local result, concatenated in shard order along ``dim``
    (the reference's ``jax.lax.all_gather(..., 'cand', tiled=True)``):
    ``parts`` are this process's shards' results; on a distributed mesh
    with cand > 1, the rank's one result, gathered over its 'cand' group."""
    if mesh is None or not mesh.distributed or mesh.cand == 1:
        return torch.cat(list(parts), dim)
    (part,) = parts
    return distributed.all_gather_cat(part, mesh.group, dim)


def local_topk(scores, valid, table, sel_size: int):
    """A shard's winners: the top ``sel_size`` of ``scores`` (..., Ts) with
    invalid rows at -inf, ties to the lower position.  Returns (values
    (..., sel_size), rows of ``table`` (..., sel_size, k))."""
    if scores.shape[-1] < sel_size:
        raise ValueError(f"a shard of {scores.shape[-1]} rows cannot give {sel_size} winners")
    vals, pos, _ = masked_topk(torch.where(valid, scores, -torch.inf), sel_size)
    return vals, table[pos]


def sharded_score_and_select(score_local_fn, mesh: Mesh, sel_size: int):
    """fn(x, X, table, valid) -> (the global top ``sel_size`` values, their
    rows (sel_size, k), valid (sel_size,)), scoring every shard with
    ``score_local_fn(x, X, table_shard, valid_shard)``, taking its local
    top-k, gathering the winners and taking the global top-k."""

    def step(x, X, table, valid):
        won = [local_topk(score_local_fn(x, X, t, v), v, t, sel_size)
               for t, v in local_shards(table, valid, mesh)]
        gv = gather_cand([w[0] for w in won], mesh=mesh)
        gr = gather_cand([w[1] for w in won], mesh=mesh)
        v, i, ok = masked_topk(gv, sel_size)
        return v, gr[i], ok

    return step
