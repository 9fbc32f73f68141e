"""Chebyshev smoothing on Jacobi-scaled scalar stencils (counterpart of
``thermalporous_tpu/precond/chebyshev.py:24-80``).

The smooth itself is the ``chebyshev_smooth`` kernel wrapper
(``kernels/stencil.py``), whose plain version is the reference's recurrence.
"""

from __future__ import annotations

import torch

from thermalporous_torch.core.stencil import ScalarStencil
from thermalporous_torch.kernels import stencil as kst


def gershgorin_lambda_max(st: ScalarStencil) -> torch.Tensor:
    """Upper bound on the spectrum of D⁻¹A from Gershgorin rows (a 0-dim
    tensor on the stencil's device)."""
    return torch.max(st.row_abs_sum() / torch.abs(st.diag))


def chebyshev(
    st: ScalarStencil,
    b: torch.Tensor,
    x: torch.Tensor | None = None,
    degree: int = 3,
    lam_max: torch.Tensor | None = None,
    lam_min_frac: float = 0.25,
    lam_max_safety: float = 1.05,
) -> torch.Tensor:
    """``degree`` Chebyshev iterations on D⁻¹A x = D⁻¹b from ``x`` (None =
    zero start) over [lam_min_frac·λmax, λmax·safety]."""
    if lam_max is None:
        lam_max = gershgorin_lambda_max(st)
    return kst.chebyshev_smooth(st.packed, b, x, lam_max, degree, lam_min_frac,
                                lam_max_safety)
