"""Block and scalar 5/7-point stencil matrices (counterpart of
``thermalporous_tpu/core/stencil.py``).

The Newton Jacobian is kept as per-cell dense blocks.  Unlike the reference,
which holds ``diag``/``upper``/``lower`` as separate arrays, a
:class:`BlockStencil` owns ONE contiguous coefficient tensor
``coef`` of shape ``(2·dim+1, nc, nc, *grid)`` in the order of the
reference's ``pack_block_stencil`` — ``[diag, up_0, lo_0, up_1, lo_1, ...]``
— and ``diag``, ``upper[a]``, ``lower[a]`` are views into it.  The matvec
kernel then reads the assembly's output with no repacking copy.
:class:`ScalarStencil` does the same with ``packed`` of shape
``(2·dim+1, *grid)``.

``upper[a]`` couples cell i to i+e_a (zero on the last slice along a),
``lower[a]`` couples it to i−e_a (zero on the first slice).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from thermalporous_torch.core.grid import shift_minus, shift_plus
from thermalporous_torch.kernels import stencil as kst


def _pack(diag: torch.Tensor, upper: Sequence[torch.Tensor],
          lower: Sequence[torch.Tensor]) -> torch.Tensor:
    parts = [diag]
    for up, lo in zip(upper, lower):
        parts += [up, lo]
    return torch.stack(parts)


@dataclasses.dataclass
class BlockStencil:
    """Block 7-point (5-point in 2D) stencil operator."""

    coef: torch.Tensor  # (2·dim+1, nc, nc, *grid), contiguous
    #: index sum of the grid's origin in the whole grid, mod 2: the colour
    #: offset of the red-black and zebra smoothers (a whole grid's is 0; a
    #: decomposed block's view, ``dist.halo.HaloStencil``, has its own)
    parity = 0

    @classmethod
    def from_parts(cls, diag, upper, lower) -> "BlockStencil":
        return cls(_pack(diag, upper, lower))

    @property
    def nc(self) -> int:
        return self.coef.shape[1]

    @property
    def grid_shape(self) -> tuple[int, ...]:
        return tuple(self.coef.shape[3:])

    @property
    def dim(self) -> int:
        return self.coef.dim() - 3

    @property
    def diag(self) -> torch.Tensor:
        return self.coef[0]

    @property
    def upper(self) -> tuple[torch.Tensor, ...]:
        return tuple(self.coef[1 + 2 * a] for a in range(self.dim))

    @property
    def lower(self) -> tuple[torch.Tensor, ...]:
        return tuple(self.coef[2 + 2 * a] for a in range(self.dim))

    def line_parity(self, axis: int) -> int:
        """The zebra colour offset of lines along ``axis``: the index sum of
        the grid's origin over the other axes, mod 2 (a whole grid's is 0)."""
        return 0

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """A·v for a state-shaped ``v`` (nc, *grid)."""
        return kst.block_matvec(self.coef, v, self.nc)

    def matvec_cols(self, v: torch.Tensor, k: int) -> torch.Tensor:
        """A·[v; 0] for ``v`` of shape (k, *grid): only block columns 0:k.

        Exactly the full matvec of v padded with nc−k zero components (the
        elided columns would multiply exact zeros) while reading k/nc of the
        coefficients — the CPTR stage-2 residual r − A·x₁, where x₁ lives on
        the (p, T) unknowns only.
        """
        return kst.block_matvec(self.coef, v, k)

    def matvec_offdiag(self, v: torch.Tensor,
                       axes: Sequence[int] | None = None) -> torch.Tensor:
        """A·v without the diagonal-block term: the neighbour coupling only,
        along ``axes`` (None = every axis; taken modulo the grid's
        dimension and sorted, as the reference takes them).  Plain torch.

        Restricting ``axes`` gives a sparsified operator (the rbgs stage 2's
        ``stage2_axes``).  An empty ``axes`` raises ``ValueError``: there is
        no coupling to return (the reference returns None there)."""
        dim = self.dim
        axs = (tuple(range(dim)) if axes is None
               else tuple(sorted(a % dim for a in axes)))
        if not axs:
            raise ValueError("matvec_offdiag: axes is empty")
        y = None
        for a in axs:
            t = apply_blocks(self.upper[a], shift_minus(v, a, lead=1))
            y = t if y is None else y + t
            y = y + apply_blocks(self.lower[a], shift_plus(v, a, lead=1))
        return y

    def transpose(self) -> "BlockStencil":
        """The stencil of Aᵀ (exact): row i of Aᵀ couples to i+e_a through
        L_a[i+e_a]ᵀ and to i−e_a through U_a[i−e_a]ᵀ (the zero-filled shifts
        keep the zero-boundary convention); the diagonal blocks transpose in
        place."""
        bt = lambda a: a.transpose(0, 1)
        return BlockStencil.from_parts(
            bt(self.diag),
            [bt(shift_minus(lo, a, lead=2)) for a, lo in enumerate(self.lower)],
            [bt(shift_plus(up, a, lead=2)) for a, up in enumerate(self.upper)])

    def scalar(self, row: int, col: int) -> "ScalarStencil":
        """The scalar sub-stencil of one (equation, unknown) pair (a copy)."""
        return ScalarStencil(self.coef[:, row, col].contiguous())

    def block(self, rows: slice, cols: slice) -> "BlockStencil":
        """A sub-block stencil, e.g. the (p, T) 2×2 system (a copy)."""
        return BlockStencil(self.coef[:, rows, cols].contiguous())

    def diag_inverse(self) -> torch.Tensor:
        """Per-cell inverse of the diagonal blocks, (nc, nc, *grid)."""
        return invert_blocks(self.diag)

    def scale_rows(self, w: torch.Tensor) -> "BlockStencil":
        """The stencil of W·A for per-cell blocks ``w`` (nc, nc, *grid)
        (the CPR/CPTR decoupling)."""
        return BlockStencil(multiply_blocks(w, self.coef))

    def to_dense(self) -> torch.Tensor:
        """Dense (nc·N, nc·N) matrix, unknowns component-major (the order of
        ``v.reshape(-1)`` for v (nc, *grid)), by index scatter: each block
        entry lands once, a boundary coupling (zero) nowhere.  The coarsest
        level of the block multigrid, the "lu" preconditioner, tests."""
        nc, shape = self.nc, self.grid_shape
        dev, dt = self.coef.device, self.coef.dtype
        n = math.prod(shape)
        lin = torch.arange(n, device=dev).reshape(shape)
        idx = torch.stack(torch.meshgrid(*[torch.arange(s, device=dev) for s in shape],
                                         indexing="ij"))
        comp = torch.arange(nc, device=dev)
        ci, cj = comp.reshape(nc, 1, 1), comp.reshape(1, nc, 1)
        rows = lin.reshape(1, 1, n)
        dense = torch.zeros((nc, n, nc, n), dtype=dt, device=dev)
        dense.index_put_((ci, rows, cj, rows), self.diag.reshape(nc, nc, n), accumulate=True)
        for a in range(self.dim):
            stride = math.prod(shape[a + 1:])
            for blocks, ok, step in ((self.upper[a], idx[a] < shape[a] - 1, stride),
                                     (self.lower[a], idx[a] > 0, -stride)):
                cols = torch.where(ok, lin + step, lin).reshape(1, 1, n)
                vals = torch.where(ok, blocks, 0.0).reshape(nc, nc, n)
                dense.index_put_((ci, rows, cj, cols), vals, accumulate=True)
        return dense.reshape(nc * n, nc * n)


@dataclasses.dataclass
class ScalarStencil:
    """Scalar 7-point stencil (one equation, one unknown per cell)."""

    packed: torch.Tensor  # (2·dim+1, *grid), contiguous
    parity = 0            # as BlockStencil.parity

    @classmethod
    def from_parts(cls, diag, upper, lower) -> "ScalarStencil":
        return cls(_pack(diag, upper, lower))

    @property
    def grid_shape(self) -> tuple[int, ...]:
        return tuple(self.packed.shape[1:])

    @property
    def dim(self) -> int:
        return self.packed.dim() - 1

    @property
    def diag(self) -> torch.Tensor:
        return self.packed[0]

    @property
    def upper(self) -> tuple[torch.Tensor, ...]:
        return tuple(self.packed[1 + 2 * a] for a in range(self.dim))

    @property
    def lower(self) -> tuple[torch.Tensor, ...]:
        return tuple(self.packed[2 + 2 * a] for a in range(self.dim))

    line_parity = BlockStencil.line_parity

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        return kst.matvec(self.packed, v)

    def row_abs_sum(self) -> torch.Tensor:
        """Σ_j |a_ij| per cell (Gershgorin bound material)."""
        s = torch.abs(self.diag)
        for up, lo in zip(self.upper, self.lower):
            s = s + torch.abs(up) + torch.abs(lo)
        return s

    def to_dense(self) -> torch.Tensor:
        """Dense (N, N) matrix by direct index scatter (the multigrid
        coarsest level).  Boundary off-diagonals are zero by the full-shape
        convention, so their clipped targets add nothing."""
        shape = self.grid_shape
        dev, dt = self.packed.device, self.packed.dtype
        n = math.prod(shape)
        lin = torch.arange(n, device=dev).reshape(shape)
        idx = torch.stack(torch.meshgrid(
            *[torch.arange(s, device=dev) for s in shape], indexing="ij"))
        dense = torch.zeros((n, n), dtype=dt, device=dev)
        rows = lin.reshape(n)
        dense.index_put_((rows, rows), self.diag.reshape(n), accumulate=True)
        for a, (up, lo) in enumerate(zip(self.upper, self.lower)):
            stride = math.prod(shape[a + 1:])
            has_up = idx[a] < shape[a] - 1
            has_lo = idx[a] > 0
            cols_up = torch.where(has_up, lin + stride, lin).reshape(n)
            cols_lo = torch.where(has_lo, lin - stride, lin).reshape(n)
            dense.index_put_((rows, cols_up),
                             torch.where(has_up, up, 0.0).reshape(n),
                             accumulate=True)
            dense.index_put_((rows, cols_lo),
                             torch.where(has_lo, lo, 0.0).reshape(n),
                             accumulate=True)
        return dense


def map_stencil(st, fn):
    """A stencil of any class (block, scalar, or a multigrid level's wide
    or box stencil) rebuilt from ``fn(coef, lead)`` of its one coefficient
    tensor, ``lead`` the number of its axes before the grid's."""
    t = st.packed if isinstance(st, ScalarStencil) else st.coef
    return type(st)(fn(t, t.dim() - len(st.grid_shape)))


def invert_blocks(d: torch.Tensor) -> torch.Tensor:
    """Invert per-cell (nc, nc) blocks stored as (nc, nc, *grid): closed
    forms for nc ≤ 3 (cofactors over the determinant), batched
    ``torch.linalg.inv`` above."""
    nc = d.shape[0]
    if nc == 1:
        return 1.0 / d
    if nc == 2:
        a, b = d[0, 0], d[0, 1]
        c, e = d[1, 0], d[1, 1]
        det = a * e - b * c
        return torch.stack([torch.stack([e, -b]), torch.stack([-c, a])]) / det
    if nc == 3:
        a = d
        c00 = a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1]
        c01 = a[0, 2] * a[2, 1] - a[0, 1] * a[2, 2]
        c02 = a[0, 1] * a[1, 2] - a[0, 2] * a[1, 1]
        c10 = a[1, 2] * a[2, 0] - a[1, 0] * a[2, 2]
        c11 = a[0, 0] * a[2, 2] - a[0, 2] * a[2, 0]
        c12 = a[0, 2] * a[1, 0] - a[0, 0] * a[1, 2]
        c20 = a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]
        c21 = a[0, 1] * a[2, 0] - a[0, 0] * a[2, 1]
        c22 = a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]
        det = a[0, 0] * c00 + a[0, 1] * c10 + a[0, 2] * c20
        inv = torch.stack([torch.stack([c00, c01, c02]),
                           torch.stack([c10, c11, c12]),
                           torch.stack([c20, c21, c22])])
        return inv / det
    perm = tuple(range(2, d.dim())) + (0, 1)
    inv = torch.linalg.inv(d.permute(perm))
    back = (d.dim() - 2, d.dim() - 1) + tuple(range(d.dim() - 2))
    return inv.permute(back).contiguous()


def apply_blocks(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-cell blocks ``w`` (nc, nc, *grid) applied to ``v`` (nc, *grid)."""
    return kst.apply_block_cols(w, v)


def multiply_blocks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-cell block product a·b: ``a`` (nc, nc, *grid), ``b`` (..., nc, nc,
    *grid) with any leading axes (e.g. the 2·dim+1 stencil offsets)."""
    nc = a.shape[0]
    lead = b.dim() - a.dim()
    bi = lambda k, j: b[(slice(None),) * lead + (k, j)]
    rows = []
    for i in range(nc):
        cols = []
        for j in range(nc):
            acc = a[i, 0] * bi(0, j)
            for k in range(1, nc):
                acc = acc + a[i, k] * bi(k, j)
            cols.append(acc)
        rows.append(torch.stack(cols, dim=lead))
    return torch.stack(rows, dim=lead)
