"""Smoothers (counterpart of ``thermalporous_tpu/precond/chebyshev.py``):
Chebyshev on Jacobi-scaled scalar stencils (24-80) and red-black block
Gauss–Seidel on block stencils (107-114, 265-300).

The Chebyshev smooth is the ``chebyshev_smooth`` kernel wrapper and the
one-sweep zero-start red-black block Gauss–Seidel the ``fused_block_rbgs``
kernel wrapper (``kernels/stencil.py``); their plain versions are the
reference's recurrences.  The other smoothers of the reference are not
ported.
"""

from __future__ import annotations

import torch

from thermalporous_torch.core.stencil import BlockStencil, ScalarStencil, apply_blocks
from thermalporous_torch.kernels import stencil as kst
from thermalporous_torch.kernels.stencil import checkerboard as _checkerboard


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

    One sweep from zero is the ``fused_block_rbgs`` kernel (the flagship's
    stage 2).  Any other call runs the reference's looped form on CPU
    tensors and raises ``NotImplementedError`` on CUDA tensors, which have
    no kernel for it."""
    if x is None and sweeps == 1:
        return kst.fused_block_rbgs(st.coef, dinv, b)
    if b.device.type != "cpu":
        raise NotImplementedError(
            "block_red_black_gauss_seidel on CUDA: only one sweep from zero "
            "has a kernel")
    red = _checkerboard(st.grid_shape, b.dtype, b.device)
    black = 1.0 - red
    if x is None:
        x = torch.zeros_like(b)
    for _ in range(sweeps):
        x = x + red * apply_blocks(dinv, b - st.matvec(x))
        x = x + black * apply_blocks(dinv, b - st.matvec(x))
    return x
