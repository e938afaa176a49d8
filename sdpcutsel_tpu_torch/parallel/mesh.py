"""The ('data', 'cand') mesh (port of ``sdpcutsel_tpu/parallel/mesh.py``).

The reference lays the axes over TPU chips:
  'data' — the instance batch: independent instances solved together; no
           collective crosses it;
  'cand' — the candidate table: each shard scores its rows, and the only
           collective is the per-round gather of every shard's local top-k.

Without a process group both axes are logical: the whole batch runs
together on the one device, whatever ``data`` is (it must divide the
batch), and ``cand`` splits the candidate table into contiguous shards
whose winners are concatenated in shard order (``sharding.gather_cand``),
as the reference's tiled all_gather concatenates them.  Selection does not
depend on ``cand`` (the layout invariance of ``tests/test_round_sharded.py``).

With a process group of W ranks (``distributed.initialize``),
``make_mesh(data, cand)`` needs data x cand = W (1 x 1 for a single rank,
whose results still pass through the group's collectives), one rank a
device, laid out data-major: rank = d * cand + c, as the reference
reshapes the devices, sorted by process, to (data, cand).  A 'cand' group
is a run of consecutive ranks with a process group of its own
(``new_group``, called by every rank in the same order); no process group
spans 'data'.  A rank holds the instances of its 'data' shard and scores
its 'cand' shard of the table.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from . import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int = 1
    cand: int = 1
    distributed: bool = False    # one rank a device, over a process group
    rank: int = 0
    device: Optional[torch.device] = None
    group: Any = dataclasses.field(default=None, compare=False, repr=False)  # the 'cand' group

    @property
    def data_index(self) -> int:
        return self.rank // self.cand

    @property
    def cand_index(self) -> int:
        return self.rank % self.cand


def make_mesh(data: int = 1, cand: int = 1) -> Mesh:
    if data < 1 or cand < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data}, cand={cand}")
    if not dist.is_initialized():
        return Mesh(data, cand)
    world, rank = dist.get_world_size(), dist.get_rank()
    if data * cand != world:
        raise ValueError(f"mesh {data}x{cand} needs {data * cand} ranks, the process group "
                         f"has {world}")
    groups = [dist.new_group(list(range(d * cand, (d + 1) * cand))) for d in range(data)] \
        if cand > 1 else [None] * data
    return Mesh(data, cand, True, rank, distributed.device(), groups[rank // cand])


def default_mesh() -> Mesh:
    """Every rank on the candidate axis (a single-instance solve)."""
    return make_mesh(1, dist.get_world_size() if dist.is_initialized() else 1)
