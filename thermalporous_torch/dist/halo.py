"""Ghost-cell exchange between mesh neighbours (counterpart of
``thermalporous_tpu/dist/halo.py``).

The reference's explicit halo residual is "the direct TPU translation of
the reference's PyOP2/MPI halo exchange": each device owns a grid block,
receives one-cell ghost slices from its mesh neighbours (``lax.ppermute``)
and evaluates the same local physics on the extended block, computing the
fluxes of a block face on both sides.  Here the permute is a
``torch.distributed`` send/receive between neighbours (:func:`_exchange`,
:meth:`GridMesh.exchange`), through CPU tensors over gloo.

Every stencil pass of a decomposed run takes one exchange of a ghost ring
of the depth it needs (:meth:`Block.extend`, x then y, so that corners come
along): the residual and the Jacobian's products one cell, the red-black
stage 2 two, a degree-d Chebyshev smooth with its second output d + 1.
:class:`HaloStencil` is such a stencil, held on the extended block and
applied to owned vectors; :meth:`HaloStencil.transpose` is the adjoint's
operator, and the multigrid levels of the weighted and variational transfers
(``precond/transfer.py``'s wide and box stencils) are held the same way.
The smoothers that read a stencil's rows (pointwise, red-black, sparsified,
line) run on a HaloStencil in the whole grid's colours, their line solves
along x or y a pipeline through the ranks (:meth:`Block.pipeline`), which
needs no ring.

The extended-block residual of the decomposed step and adjoint fills no
ghost: its ring stops at the grid's boundary (:meth:`Block.ghosts`), so the
"edge" and "zero" fills of :func:`_exchange` (the explicit halo residual's
only) have no cotangent to route, and :meth:`Block.fold` is the whole
adjoint of its exchange.
"""

from __future__ import annotations

import torch

from thermalporous_torch.core.grid import divergence_add, neighbor_plus
from thermalporous_torch.core.stencil import invert_blocks, map_stencil
from thermalporous_torch.dist.sharding import Block, GridMesh
from thermalporous_torch.physics.wells import WELL_FIELDS, WellFields


def _edge(x: torch.Tensor, spatial_axis: int, lead: int, first: bool) -> torch.Tensor:
    axis = lead + spatial_axis
    n = x.shape[axis]
    return x.narrow(axis, 0 if first else n - 1, 1)


def _exchange(x: torch.Tensor, mesh: GridMesh, spatial_axis: int, lead: int,
              from_right: bool, fill: str = "edge") -> torch.Tensor:
    """Ghost slice of an owned block ``x`` from the +axis (``from_right``)
    or −axis neighbour along mesh axis ``spatial_axis``.

    Blocks with no neighbour in that direction receive ``fill``:
    - "edge": their own edge slice — correct for STATE ghosts (keeps property
      correlations finite; the zero boundary transmissibility kills the flux);
    - "zero": zeros — required for TRANSMISSIBILITY ghosts, so a phantom
      boundary face can never carry flux even when the ghost state differs
      from the edge state.
    """
    c = list(mesh.coords)
    m = mesh.shape[spatial_axis]
    idx = c[spatial_axis]

    def at(i):
        cc = list(c)
        cc[spatial_axis] = i
        return mesh.rank_at(*cc)

    tag = 8 + 2 * spatial_axis + int(from_right)
    sends, recvs = [], []
    if from_right:
        if idx > 0:                                     # my first slice goes left
            sends.append((at(idx - 1), tag, _edge(x, spatial_axis, lead, first=True)))
        missing = idx == m - 1
        own = _edge(x, spatial_axis, lead, first=False)
        if not missing:
            recvs.append((at(idx + 1), tag, tuple(own.shape), x.dtype))
    else:
        if idx < m - 1:                                 # my last slice goes right
            sends.append((at(idx + 1), tag, _edge(x, spatial_axis, lead, first=False)))
        missing = idx == 0
        own = _edge(x, spatial_axis, lead, first=True)
        if not missing:
            recvs.append((at(idx - 1), tag, tuple(own.shape), x.dtype))
    got = mesh.exchange(sends, recvs)
    if missing:
        return torch.zeros_like(own) if fill == "zero" else own
    return got[0]


def make_halo_residual(model, mesh: GridMesh, data_template,
                       axis_names: tuple[str, ...] = ("x", "y")):
    """Build ``residual(u, u_old, dt, data)`` evaluated blockwise with
    explicit one-cell exchanges of the owned blocks.

    ``u``, ``u_old`` and ``data`` are this rank's blocks as
    :func:`~thermalporous_torch.dist.sharding.shard_state` and
    :func:`~thermalporous_torch.dist.sharding.shard_problem_data` give them
    (their owned parts are used); the result is the owned block of the
    residual.  The grid axes listed in ``axis_names`` are those the mesh
    decomposes; any remaining spatial axes (z) stay local.
    ``data_template`` is only used for its block."""
    dim = model.grid.dim
    blk: Block = data_template.block
    if blk.mesh is not mesh:
        raise ValueError("make_halo_residual: data decomposed over another mesh")

    def residual(u, u_old, dt, data):
        u, u_old = blk.owned(u, lead=1), blk.owned(u_old, lead=1)
        f = blk.owned(data.fields, lead=1)
        tgeo, tcond = f[:dim], f[dim:2 * dim]
        phi = f[2 * dim]
        wells = WellFields(*(f[2 * dim + 1 + i] for i in range(len(WELL_FIELDS))))
        res = model.cell_terms(u, u_old, dt, phi, wells)
        for a in range(dim):
            if a < len(axis_names):
                # ghosts: right neighbour cell, left neighbour cell + its
                # last face transmissibilities
                u_r = _exchange(u, mesh, a, 1, from_right=True)
                u_l = _exchange(u, mesh, a, 1, from_right=False)
                tg_l = _exchange(tgeo[a], mesh, a, 0, from_right=False, fill="zero")
                tc_l = _exchange(tcond[a], mesh, a, 0, from_right=False, fill="zero")
                axis = 1 + a
                u_ext = torch.cat([u_l, u, u_r], dim=axis)
                # faces −1..b−1: left cells are u_ext[:-1], right u_ext[1:]
                n = u_ext.shape[axis]
                ul, ur = u_ext.narrow(axis, 0, n - 1), u_ext.narrow(axis, 1, n - 1)
                tg = torch.cat([tg_l, tgeo[a]], dim=a)
                tc = torch.cat([tc_l, tcond[a]], dim=a)
                flux = model.face_terms(a, ul, ur, tg, tc)
                # cell i gains +f[i+1] (its own face) − f[i] (left face)
                m = flux.shape[axis]
                res = res + flux.narrow(axis, 1, m - 1) - flux.narrow(axis, 0, m - 1)
            else:
                flux = model.face_terms(a, u, neighbor_plus(u, a, lead=1), tgeo[a], tcond[a])
                res = divergence_add(res, flux, a, lead=1)
        return res

    return residual


class HaloStencil:
    """A block or scalar stencil ``st`` held on ``block``'s extended block
    (its rows right to the ring's first cells), applied to owned vectors:
    each product extends its vector by one exchange and keeps the owned
    rows.  The decomposed Newton operator, the T←p and S←(p, T) couplings,
    the inner iterations' (p, T) operator, the stage 2's residuals and
    sparsified sweeps, and the smoothers of a decomposed multigrid level
    other than Chebyshev.

    It also reads as a stencil of the owned block (``grid_shape``, ``diag``,
    ``upper``, ``lower``, :meth:`diag_inverse`: the owned rows; ``parity``
    and :meth:`line_parity`: the owned origin's colour offsets; ``block``:
    the line solves along a decomposed axis run as a pipeline through its
    ranks), so that the pointwise, red-black and line smoothers run on it
    unchanged, in the whole grid's colours."""

    def __init__(self, st, block: Block):
        self.st = st
        self.block = block
        self.dim = len(block.shape)

    def _apply(self, fn, v: torch.Tensor) -> torch.Tensor:
        lead = v.dim() - self.dim
        return self.block.owned(fn(self.block.extend(v, lead=lead)), lead=lead)

    def _own(self, t: torch.Tensor) -> torch.Tensor:
        return self.block.owned(t, lead=t.dim() - self.dim)

    def map(self, fn) -> "HaloStencil":
        """The stencil of ``fn(coef, lead)`` of the held coefficients (as
        :func:`~thermalporous_torch.core.stencil.map_stencil`), on the same
        block: the bf16 cast of ``CPRConfig.pc_dtype``."""
        return HaloStencil(map_stencil(self.st, fn), self.block)

    @property
    def grid_shape(self) -> tuple[int, ...]:
        return self.block.owned_shape

    def line_parity(self, axis: int) -> int:
        """The owned origin's index sum over the axes other than ``axis``,
        mod 2: the zebra colour offset of lines along ``axis``."""
        return sum(self.block.owned_range(a)[0] for a in range(self.dim) if a != axis) % 2

    @property
    def parity(self) -> int:
        """The owned origin's index sum, mod 2: the red-black colour offset
        of the owned block."""
        return sum(self.block.owned_range(a)[0] for a in range(self.dim)) % 2

    @property
    def diag(self) -> torch.Tensor:
        return self._own(self.st.diag)

    @property
    def upper(self) -> tuple[torch.Tensor, ...]:
        return tuple(self._own(t) for t in self.st.upper)

    @property
    def lower(self) -> tuple[torch.Tensor, ...]:
        return tuple(self._own(t) for t in self.st.lower)

    def diag_inverse(self) -> torch.Tensor:
        """The owned rows' inverse diagonal blocks (a block stencil's)."""
        return invert_blocks(self.diag)

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        return self._apply(self.st.matvec, v)

    def matvec_cols(self, v: torch.Tensor, k: int) -> torch.Tensor:
        return self._apply(lambda x: self.st.matvec_cols(x, k), v)

    def matvec_offdiag(self, v: torch.Tensor, axes=None) -> torch.Tensor:
        """The owned rows' neighbour coupling along ``axes`` (a block
        stencil's ``matvec_offdiag``), ``v`` exchanged once."""
        return self._apply(lambda x: self.st.matvec_offdiag(x, axes=axes), v)

    def transpose(self) -> "HaloStencil":
        """The decomposed Aᵀ (a block stencil's): the held stencil's
        transpose cut to the owned rows, which read the lower and upper
        couplings one cell into the ring (exact: the ring's first rows were
        assembled from a state ring two cells deep), then re-extended by
        one exchange of its coefficients, so that every ring row is the
        owning rank's transposed row, as the stage 2 on the extended block
        reads it."""
        blk = self.block
        t = map_stencil(self.st.transpose(),
                        lambda c, lead: blk.extend(blk.owned(c, lead=lead), lead=lead))
        return HaloStencil(t, blk)
