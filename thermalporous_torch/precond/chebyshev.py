"""Smoothers (counterpart of ``thermalporous_tpu/precond/chebyshev.py``):
Chebyshev on Jacobi-scaled scalar stencils (24-80) and red-black block
Gauss–Seidel on block stencils (107-114, 265-300).

The Chebyshev smooth is the ``chebyshev_smooth`` kernel wrapper; the
red-black block Gauss–Seidel runs a zero-start sweep through the
``fused_block_rbgs`` wrapper and every other sweep as two
``block_rbgs_half_sweep`` calls (``kernels/stencil.py``); their plain
versions are the reference's recurrences.  The other smoothers of the
reference are not ported.
"""

from __future__ import annotations

import torch

from thermalporous_torch.core.stencil import BlockStencil, ScalarStencil
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
    second: str | None = None,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """``degree`` Chebyshev iterations on D⁻¹A x = D⁻¹b from ``x`` (None =
    zero start) over [lam_min_frac·λmax, λmax·safety].  With ``second``
    ("residual" or "product") the result y comes with b − A·y or A·y from
    the same kernel launch."""
    if lam_max is None:
        lam_max = gershgorin_lambda_max(st)
    return kst.chebyshev_smooth(st.packed, b, x, lam_max, degree, lam_min_frac,
                                lam_max_safety, second=second)


def block_red_black_gauss_seidel(
    st: BlockStencil,
    dinv: torch.Tensor,
    b: torch.Tensor,
    x: torch.Tensor | None = None,
    sweeps: int = 1,
) -> torch.Tensor:
    """``sweeps`` red-black block Gauss–Seidel sweeps on a block stencil from
    ``x`` (None = zero): each colour's cells get exact per-cell block solves
    (``dinv``, the inverse diagonal blocks) against the other colour's fresh
    values.

    From zero the first sweep is the ``fused_block_rbgs`` kernel (the stage-2
    kernel with no x₁); every other sweep is two ``block_rbgs_half_sweep``
    launches, red then black.  On CPU tensors the wrappers' plain versions
    are the reference's looped form, statement by statement."""
    if x is None:
        x = kst.fused_block_rbgs(st.coef, dinv, b)
        sweeps -= 1
    for _ in range(sweeps):
        x = kst.block_rbgs_half_sweep(st.coef, dinv, b, x, 0)
        x = kst.block_rbgs_half_sweep(st.coef, dinv, b, x, 1)
    return x
