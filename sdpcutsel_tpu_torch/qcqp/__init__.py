from .solver import CutSolverQCQP  # noqa: F401
