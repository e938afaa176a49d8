from .mesh import Mesh, default_mesh, make_mesh  # noqa: F401
from .sharding import (  # noqa: F401
    gather_cand,
    pad_table,
    shard_candidates,
    shard_pair_candidates,
    sharded_score_and_select,
)
