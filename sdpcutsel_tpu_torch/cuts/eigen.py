"""Small symmetric eigendecomposition of the selected Z(rho) (port of
``sdpcutsel_tpu/cuts/eigen.py::batched_eigh_small``).

Runs only on the <= sel_size selected candidates at cut generation, where
full eigenvectors are needed.  Cut rows are invariant to the sign of an
eigenvector (lin = 2 v0 u, quad = u u', rhs = -v0^2), so the library's sign
convention does not matter.
"""

from __future__ import annotations

import torch


def batched_eigh_small(Z):
    """Z: (T, m, m) symmetric -> (w ascending: (T, m), V columns: (T, m, m))."""
    return torch.linalg.eigh(Z)
