from .solver import CutSolver, RoundStats  # noqa: F401
