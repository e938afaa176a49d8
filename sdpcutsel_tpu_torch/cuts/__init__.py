from .assemble import assemble_Z  # noqa: F401
from .eigen import batched_eigh_small, feasibility_scores_from_point  # noqa: F401
from .enumerate import combinations_table  # noqa: F401
from .generate import cuts_from_selected  # noqa: F401
