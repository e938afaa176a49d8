from .pdhg import (  # noqa: F401
    PDHGState,
    dual_bound_f64,
    init_state,
    solve_lp,
)
from .pdhg_kernel import pdhg_block, pdhg_block_plain  # noqa: F401
