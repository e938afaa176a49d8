"""Small symmetric eigenvalue problems of the candidates' Z(rho) (port of
``sdpcutsel_tpu/cuts/eigen.py``).

``batched_eigh_small`` runs only on the <= sel_size selected candidates at
cut generation, where full eigenvectors are needed.  Cut rows are invariant
to the sign of an eigenvector (lin = 2 v0 u, quad = u u', rhs = -v0^2), so
the library's sign convention does not matter.

``feasibility_scores_from_point`` is -lambda_min over a whole candidate
table by the struct-of-arrays Jacobi: the violation that the QCQP residual
gate reads, and the plain twin of the scoring kernels' ``feas``.
"""

from __future__ import annotations

import torch

from ..ops.jacobi import min_eig_from_parts


def batched_eigh_small(Z):
    """Z: (T, m, m) symmetric -> (w ascending: (T, m), V columns: (T, m, m))."""
    return torch.linalg.eigh(Z)


def feasibility_scores_from_point(x, X, table, sweeps: int = 6):
    """-lambda_min(Z(rho)) for every row of ``table``, gathered from (x, X)
    without materializing (T, k+1, k+1)."""
    table = table.long()
    xr = x[table]
    Xr = X[table[:, :, None], table[:, None, :]]
    return -min_eig_from_parts(xr, Xr, sweeps=sweeps)
