from .features import candidate_features, candidate_q_features, feature_dim  # noqa: F401
from .scorer import (MLPScorer, init_params, load_params, params_from_flax,  # noqa: F401
                     params_of, save_params)
