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

Over a grid decomposition (``block_gmg_setup(..., block=...)``) the
hierarchy takes the scalar multigrid's treatment (``precond/gmg.py``): the
leading levels are **decomposed** while they have more than
``GMGConfig.replicate_below`` cells, every rank's block is at least as deep
as the ring (the Jacobian's, :data:`~thermalporous_torch.dist.sharding.STATE_HALO`
cells) and the block boundaries are even along the axes the level
coarsens.  A decomposed level's stencil and diagonal inverses are held on
the extended block (the finest is the Jacobian as held; a coarser one is
coarsened from the owned rows, whose off-diagonals carry the couplings
across a block boundary, and its ring filled by one exchange), its smooths
run on the kernels there in the whole grid's colours (the level's own
parity), and its residual is a halo matvec.  Below, every level is
**replicated**: the restricted residual is all-gathered onto it, the dense
coupled coarsest inverse is the same on every rank, and each rank cuts its
own part out of the correction (the reference's ``_replicated`` rule,
``block_gmg.py:145-152, 194-196``).
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
    # grid decomposition: the Block of each leading decomposed level (its
    # stencil and D⁻¹ held on the extended block), and the Block of
    # block_gmg_apply's vectors (owned blocks of level 0), or None
    blocks: tuple = ()
    top: object | None = None

    def gshape(self, level: int) -> tuple[int, ...]:
        """The whole grid of ``level``."""
        if level < len(self.blocks):
            return self.blocks[level].shape
        return self.stencils[level].grid_shape


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


def _full_factors(shape: tuple[int, ...]) -> tuple[int, ...]:
    """Factor-2 coarsening on every axis that is not exhausted."""
    return tuple(2 if n > 1 else 1 for n in shape)


def block_galerkin_coarsen(st: BlockStencil,
                           factors: tuple[int, ...] | None = None) -> BlockStencil:
    """A_c = R·A·P with summation R and injection P, lifted to blocks: the
    scalar ``gmg.galerkin_coarsen``'s bookkeeping (a fine face interior to a
    coarse cell folds into the coarse diagonal, the rest into the coarse
    off-diagonals) with every coupling the cell's nc×nc block."""
    shape = st.grid_shape
    dim = len(shape)
    if factors is None:
        factors = _full_factors(shape)

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
                    max_levels: int = 12, block=None) -> BlockGMGState:
    """Build the coupled hierarchy (per preconditioner set-up): full
    factor-2 coarsening on every axis that is not exhausted until a level
    has at most ``max_coarse_cells`` cells.  ``gmg_cfg`` carries no option
    this hierarchy uses on one device (the reference reads its multi-device
    fields only: ``replicate_below`` and ``mesh``).  With ``block`` (``st``
    held on its extended block) the decomposed hierarchy of the module's
    docstring."""
    if block is not None:
        return _setup_blocks(st, gmg_cfg, max_coarse_cells, max_levels, block)
    stencils = [st]
    while (math.prod(stencils[-1].grid_shape) > max_coarse_cells
           and len(stencils) < max_levels
           and any(n > 1 for n in stencils[-1].grid_shape)):
        stencils.append(block_galerkin_coarsen(stencils[-1]))
    return BlockGMGState(stencils=tuple(stencils),
                         dinvs=tuple(invert_blocks(s.diag) for s in stencils[:-1]),
                         coarse_inv=dense_inv(stencils[-1].to_dense()))


def _setup_blocks(st: BlockStencil, gmg_cfg: GMGConfig, max_coarse_cells: int,
                  max_levels: int, block) -> BlockGMGState:
    """The coupled hierarchy of a decomposed Jacobian: the levels' whole
    shapes as :func:`block_gmg_setup` walks them, the leading levels
    decomposed while they may be, the rest replicated."""
    if gmg_cfg.mesh is not None and gmg_cfg.mesh is not block.mesh:
        raise ValueError("GMGConfig.mesh is not the mesh the data is decomposed over")
    shapes = [block.shape]
    while (math.prod(shapes[-1]) > max_coarse_cells and len(shapes) < max_levels
           and any(n > 1 for n in shapes[-1])):
        shapes.append(tuple(-(-n // 2) if n > 1 else n for n in shapes[-1]))
    factors = [_full_factors(shape) for shape in shapes[:-1]]
    top = BlockStencil(block.owned(st.coef, lead=3))
    blocks, levels = block.walk_levels(shapes, factors, gmg_cfg.replicate_below, top,
                                       lambda cur, level, blk: block_galerkin_coarsen(
                                           cur, factors[level]))
    stencils, dinvs = [], []
    for level, cur in enumerate(levels):
        if level < len(blocks):
            held = st if level == 0 else BlockStencil(blocks[level].extend(cur.coef, lead=3))
        else:
            held = cur
        stencils.append(held)
        if level < len(levels) - 1:
            dinvs.append(invert_blocks(held.diag))
    return BlockGMGState(stencils=tuple(stencils), dinvs=tuple(dinvs),
                         coarse_inv=dense_inv(stencils[-1].to_dense()),
                         blocks=tuple(blocks), top=block.with_width(0))


def _cycle_block(state: BlockGMGState, level: int, b: torch.Tensor, gmg_cfg: GMGConfig,
                 sweeps: int) -> torch.Tensor:
    """:func:`_cycle` from decomposed ``level`` on owned vectors: ``b``
    exchanged once for both smooths, the residual a halo matvec, the
    restriction and the prolongation block by block, the restricted
    residual all-gathered onto a replicated next level and the rank's part
    cut back out of its correction."""
    from thermalporous_torch.dist.halo import HaloStencil

    blk = state.blocks[level]
    st, dinv = state.stencils[level], state.dinvs[level]
    fine = blk.owned_shape
    factors = tuple(2 if c < f else 1 for f, c in zip(blk.shape, state.gshape(level + 1)))
    dim = len(fine)
    b_ext = blk.extend(b, lead=1)
    x = block_red_black_gauss_seidel(st, dinv, b_ext, sweeps=sweeps, block=blk)
    ec = blk.through_coarse(factors, _bsum(b - HaloStencil(st, blk).matvec(x), dim, factors),
                            lambda rc: _cycle(state, level + 1, rc, gmg_cfg, sweeps),
                            replicate=level + 1 == len(state.blocks))
    x = x + _bprolong(ec, dim, fine, factors)
    return block_red_black_gauss_seidel(st, dinv, b_ext, x=x, sweeps=sweeps, block=blk)


def _cycle(state: BlockGMGState, level: int, b: torch.Tensor, gmg_cfg: GMGConfig,
           sweeps: int) -> torch.Tensor:
    """One coupled V-cycle from ``level`` down: ``sweeps`` red-black block
    sweeps from zero, the residual restricted, the coarse correction
    injected back, ``sweeps`` sweeps from there; the coarsest level is the
    dense solve."""
    st = state.stencils[level]
    if level == len(state.stencils) - 1:
        return torch.mv(state.coarse_inv, b.reshape(-1)).reshape(b.shape)
    if level < len(state.blocks):
        return _cycle_block(state, level, b, gmg_cfg, sweeps)
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
    each after the first on the residual of the sum so far.  A decomposed
    hierarchy takes and returns owned blocks (each later cycle's residual a
    halo matvec); one replicated from level 0 gathers ``b`` and cuts the
    rank's part out."""
    if state.top is not None and not state.blocks:
        whole = dataclasses.replace(state, top=None)
        return state.top.on_whole(lambda bb: block_gmg_apply(whole, bb, gmg_cfg, sweeps=sweeps,
                                                             cycles=cycles), b)
    matvec = state.stencils[0].matvec
    if state.blocks:
        from thermalporous_torch.dist.halo import HaloStencil

        matvec = HaloStencil(state.stencils[0], state.blocks[0]).matvec
    x = _cycle(state, 0, b, gmg_cfg, sweeps)
    for _ in range(cycles - 1):
        x = x + _cycle(state, 0, b - matvec(x), gmg_cfg, sweeps)
    return x
