from .cutbuffer import (  # noqa: F401
    CutIndex,
    CutPool,
    append_cuts,
    build_cut_index,
    cut_adjoint,
    cut_residuals,
    empty_pool,
    purge_pool,
)
from .mccormick import SA, SB, apply_K, apply_KT, project_primal  # noqa: F401
