"""The logical ('data', 'cand') mesh of one process (port of
``sdpcutsel_tpu/parallel/mesh.py`` for one card).

The reference lays the axes over TPU chips:
  'data' — the instance batch: independent instances solved together; no
           collective crosses it;
  'cand' — the candidate table: each shard scores its rows, and the only
           collective is the per-round gather of every shard's local top-k.
In one process both axes are logical.  The whole batch runs together on the
one device, whatever ``data`` is (it must divide the batch), and ``cand``
splits the table into contiguous shards whose winners are concatenated in
shard order (``sharding.gather_cand``), as the reference's tiled all_gather
concatenates them.  Selection does not depend on ``cand`` (the layout
invariance of ``tests/test_round_sharded.py``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int = 1
    cand: int = 1


def make_mesh(data: int = 1, cand: int = 1) -> Mesh:
    if data < 1 or cand < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data}, cand={cand}")
    return Mesh(data, cand)
