"""Coupled block geometric multigrid on the full (p, T[, S]) system, the
``stage2="bgmg"`` smoother of CPR/CPTR (counterpart of
``thermalporous_tpu/precond/block_gmg.py``).

A Galerkin hierarchy of the untouched full-system block stencil: the
summation-restriction / injection-prolongation pair of the scalar
multigrid lifted to the per-cell nc×nc blocks, full factor-2 coarsening on
every axis that is not exhausted, red-black block Gauss–Seidel smoothing on
every level and a dense inverse of the coarsest coupled system.

On the card each level's smooths run on the red-black kernels of
``kernels/stencil.py`` through
:func:`~thermalporous_torch.precond.chebyshev.block_red_black_gauss_seidel`:
the pre-smooth from zero is one ``fused_block_rbgs`` launch (the stage-2
kernel with no x₁) and every further sweep, the post-smooth from x
included, two ``block_rbgs_half_sweep`` launches; each level's residual is
one ``block_matvec`` launch.  The Galerkin coarsening, the block inverses
and the dense coarsest solve are plain PyTorch, as the reference's are jnp.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from thermalporous_torch.core.stencil import BlockStencil, invert_blocks
from thermalporous_torch.precond.chebyshev import block_red_black_gauss_seidel
from thermalporous_torch.precond.gmg import GMGConfig, dense_inv


@dataclasses.dataclass
class BlockGMGState:
    """The coupled hierarchy (rebuilt per preconditioner set-up)."""

    stencils: tuple[BlockStencil, ...]   # per level
    dinvs: tuple[torch.Tensor, ...]      # per smoothed level, (nc, nc, *grid)
    coarse_inv: torch.Tensor             # dense inverse of the coarsest system


def _bsum(x: torch.Tensor, dim: int, factors: tuple[int, ...]) -> torch.Tensor:
    """Sum over 2-cell blocks on factor-2 axes; the grid axes are the last
    ``dim`` axes of ``x`` (residuals (nc, *grid) and blocks (…, nc, nc,
    *grid) alike; ragged tails zero-padded)."""
    lead = x.dim() - dim
    for axis in range(dim):
        if factors[axis] == 1:
            continue
        ax = axis + lead
        if x.shape[ax] % 2 == 1:
            x = torch.cat([x, torch.zeros_like(x.narrow(ax, 0, 1))], dim=ax)
        m = x.shape[ax] // 2
        x = x.reshape(x.shape[:ax] + (m, 2) + x.shape[ax + 1:]).sum(dim=ax + 1)
    return x


def _bprolong(e: torch.Tensor, dim: int, fine_shape: tuple[int, ...],
              factors: tuple[int, ...]) -> torch.Tensor:
    """Piecewise-constant injection back to the fine grid (grid axes last)."""
    lead = e.dim() - dim
    for axis in range(dim):
        if factors[axis] == 1:
            continue
        ax = axis + lead
        e = torch.repeat_interleave(e, 2, dim=ax)
        if e.shape[ax] != fine_shape[axis]:
            e = e.narrow(ax, 0, fine_shape[axis])
    return e.contiguous()


def block_galerkin_coarsen(st: BlockStencil,
                           factors: tuple[int, ...] | None = None) -> BlockStencil:
    """A_c = R·A·P with summation R and injection P, lifted to blocks: the
    scalar ``gmg.galerkin_coarsen``'s bookkeeping (a fine face interior to a
    coarse cell folds into the coarse diagonal, the rest into the coarse
    off-diagonals) with every coupling the cell's nc×nc block."""
    shape = st.grid_shape
    dim = len(shape)
    if factors is None:
        factors = tuple(2 if n > 1 else 1 for n in shape)

    def axis_mask(axis: int, even: bool) -> torch.Tensor:
        idx = torch.arange(shape[axis], device=st.coef.device)
        m = (idx % 2 == 0) if even else (idx % 2 == 1)
        view = [1] * (dim + 2)
        view[2 + axis] = shape[axis]
        return m.to(st.coef.dtype).reshape(view)

    d = st.diag
    for a in range(dim):
        if factors[a] == 2:
            d = d + st.upper[a] * axis_mask(a, even=True)
            d = d + st.lower[a] * axis_mask(a, even=False)
    bs = lambda x: _bsum(x, dim, factors)
    ups, los = [], []
    for a in range(dim):
        if factors[a] == 2:
            ups.append(bs(st.upper[a] * axis_mask(a, even=False)))
            los.append(bs(st.lower[a] * axis_mask(a, even=True)))
        else:
            ups.append(bs(st.upper[a]))
            los.append(bs(st.lower[a]))
    return BlockStencil.from_parts(bs(d), ups, los)


def block_gmg_setup(st: BlockStencil, gmg_cfg: GMGConfig, max_coarse_cells: int = 256,
                    max_levels: int = 12) -> BlockGMGState:
    """Build the coupled hierarchy (per preconditioner set-up): full
    factor-2 coarsening on every axis that is not exhausted until a level
    has at most ``max_coarse_cells`` cells.  ``gmg_cfg`` carries no option
    this hierarchy uses on one device (the reference reads its multi-device
    fields only)."""
    stencils = [st]
    while (math.prod(stencils[-1].grid_shape) > max_coarse_cells
           and len(stencils) < max_levels
           and any(n > 1 for n in stencils[-1].grid_shape)):
        stencils.append(block_galerkin_coarsen(stencils[-1]))
    return BlockGMGState(stencils=tuple(stencils),
                         dinvs=tuple(invert_blocks(s.diag) for s in stencils[:-1]),
                         coarse_inv=dense_inv(stencils[-1].to_dense()))


def _cycle(state: BlockGMGState, level: int, b: torch.Tensor, gmg_cfg: GMGConfig,
           sweeps: int) -> torch.Tensor:
    """One coupled V-cycle from ``level`` down: ``sweeps`` red-black block
    sweeps from zero, the residual restricted, the coarse correction
    injected back, ``sweeps`` sweeps from there; the coarsest level is the
    dense solve."""
    st = state.stencils[level]
    if level == len(state.stencils) - 1:
        return torch.mv(state.coarse_inv, b.reshape(-1)).reshape(b.shape)
    dinv = state.dinvs[level]
    fine = st.grid_shape
    coarse = state.stencils[level + 1].grid_shape
    factors = tuple(2 if c < f else 1 for f, c in zip(fine, coarse))
    dim = len(fine)
    x = block_red_black_gauss_seidel(st, dinv, b, sweeps=sweeps)
    rc = _bsum(b - st.matvec(x), dim, factors)
    ec = _cycle(state, level + 1, rc, gmg_cfg, sweeps)
    x = x + _bprolong(ec, dim, fine, factors)
    return block_red_black_gauss_seidel(st, dinv, b, x=x, sweeps=sweeps)


def block_gmg_apply(state: BlockGMGState, b: torch.Tensor, gmg_cfg: GMGConfig,
                    sweeps: int = 1, cycles: int = 1) -> torch.Tensor:
    """``cycles`` coupled V-cycles approximating A⁻¹b on the full system,
    each after the first on the residual of the sum so far."""
    x = _cycle(state, 0, b, gmg_cfg, sweeps)
    for _ in range(cycles - 1):
        x = x + _cycle(state, 0, b - state.stencils[0].matvec(x), gmg_cfg, sweeps)
    return x
