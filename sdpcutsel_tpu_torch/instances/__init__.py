from .boxqp import BoxQPInstance, generate_spar, load_or_generate, parse_boxqp  # noqa: F401
from .qcqp import QCQPInstance, generate_qcqp_family, load_or_generate_qcqp  # noqa: F401
