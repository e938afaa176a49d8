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
from .denserows import (  # noqa: F401
    DenseRows,
    batched_dense_from_qcqp,
    dense_adjoint,
    dense_from_qcqp,
    dense_residuals,
    empty_dense,
)
from .mccormick import SA, SB, apply_K, apply_KT, project_primal  # noqa: F401
