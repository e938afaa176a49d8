from .features import candidate_features, candidate_q_features  # noqa: F401
from .scorer import MLPScorer, load_params, params_from_flax  # noqa: F401
