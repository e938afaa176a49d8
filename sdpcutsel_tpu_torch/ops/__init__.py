from .fused_score import fused_score, fused_score_plain  # noqa: F401
from .jacobi import min_eig_from_parts  # noqa: F401
from .pair_packed import packed_score, packed_score_plain  # noqa: F401
from .pair_score import pair_score, pair_score_plain  # noqa: F401
from .topk import diverse_topk, masked_topk  # noqa: F401
