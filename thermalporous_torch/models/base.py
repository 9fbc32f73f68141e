"""Model base: TPFA residual and block-stencil assembly (counterpart of
``thermalporous_tpu/models/base.py``).

A model is defined by two local functions:

- ``cell_terms(u, u_old, dt, phi, wells) -> (nc, *grid)``: accumulation
  (backward Euler) minus well/heater sources;
- ``face_terms(axis, u_L, u_R, tgeo, tcond) -> (nc, *grid)``: TPFA fluxes
  through the face L → R.

Broadcast over full tensors they give the residual; under ``torch.func.jvp``
the residual gives the exact matrix-free product J·v
(:meth:`ThermalModelBase.jvp`), and with broadcast unit tangents the local
functions give the exact per-cell blocks of the Jacobian
(:meth:`ThermalModelBase.assemble_stencil`).  On the card the same blocks
come from J·v products on coloured unit tangents (:func:`probe_stencil`),
through the caller's ``fused_jvp``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Sequence

import torch
from torch.func import vmap

from thermalporous_torch._device import reduce_dtype
from thermalporous_torch.core.grid import (
    Grid,
    divergence_add,
    harmonic_face_transmissibility,
    neighbor_plus,
    shift_plus,
)
from thermalporous_torch.core.stencil import BlockStencil
from thermalporous_torch.physics.props import PhysicalParams
from thermalporous_torch.physics.wells import (
    WELL_FIELDS,
    Heater,
    Well,
    WellFields,
    well_fields_numpy,
)
from thermalporous_torch.tracing import count, span


def n_fields(dim: int) -> int:
    """Field channels of ``ProblemData.fields``: tgeo·dim, tcond·dim, phi,
    and the six well fields."""
    return 2 * dim + 1 + len(WELL_FIELDS)


@dataclasses.dataclass
class ProblemData:
    """All array-valued problem data, packed in ONE contiguous tensor.

    ``fields`` has shape ``(2·dim+7, *grid)``: ``[tgeo_0.., tcond_0.., phi,
    wi, pbh, tinj, has_tinj, qrate, qheat]`` — the channel order of the
    reference's fused-residual packing, so the residual kernel reads it with
    no copy.  ``tgeo[a]``/``tcond[a]`` are full-shape face transmissibilities
    A·k̄/Δ [m³] and A·κ̄/Δ [W/K] (face i→i+1 at index i, zero on the last
    slice); the other attributes are views.
    """

    fields: torch.Tensor

    @property
    def dim(self) -> int:
        return self.fields.dim() - 1

    @property
    def tgeo(self) -> tuple[torch.Tensor, ...]:
        return tuple(self.fields[a] for a in range(self.dim))

    @property
    def tcond(self) -> tuple[torch.Tensor, ...]:
        return tuple(self.fields[self.dim + a] for a in range(self.dim))

    @property
    def phi(self) -> torch.Tensor:
        return self.fields[2 * self.dim]

    @property
    def wells(self) -> WellFields:
        base = 2 * self.dim + 1
        return WellFields(*(self.fields[base + i] for i in range(len(WELL_FIELDS))))

    def with_wells(self, wells: WellFields) -> "ProblemData":
        """The same problem under other well/heater fields (a control
        segment): a new packed tensor with the six well channels written from
        ``wells``; this one's tensor, which other runs may share, is left as
        it is."""
        fields = self.fields.clone()
        base = 2 * self.dim + 1
        for i, name in enumerate(WELL_FIELDS):
            fields[base + i].copy_(getattr(wells, name))
        return ProblemData(fields)


def make_problem_data(
    grid: Grid,
    pp: PhysicalParams,
    kx,
    ky=None,
    kz=None,
    phi=0.2,
    wells: Sequence[Well] = (),
    heaters: Sequence[Heater] = (),
    *,
    dtype: torch.dtype,
    device: torch.device | str,
) -> ProblemData:
    """Transmissibilities and well fields of a case, on ``device``."""
    ones = torch.ones(grid.shape, dtype=dtype, device=device)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device) * ones
    kx = as_t(kx)
    ky = kx if ky is None else as_t(ky)
    kz = kx if kz is None else as_t(kz)
    tgeo = harmonic_face_transmissibility(grid, [kx, ky, kz][: grid.dim])
    kappa = pp.kappa_eff * ones
    tcond = harmonic_face_transmissibility(grid, [kappa] * grid.dim)
    phi_t = as_t(phi)
    # the Peaceman index sees the permeability as rounded to ``dtype``, as
    # the reference's does
    wf = well_fields_numpy(grid, wells, heaters, kx=kx.cpu().numpy(),
                           ky=ky.cpu().numpy())
    well_t = [torch.as_tensor(wf[k], dtype=dtype, device=device)
              for k in WELL_FIELDS]
    return ProblemData(torch.stack([*tgeo, *tcond, phi_t, *well_t]))


#: colourings of the probed assembly, by dimension: (the weight of each
#: axis, the number of colours).  A cell's colour is Σ_a w_a·i_a mod q; the
#: offsets 0 and ±w_a are distinct mod q, so a cell and its 2·dim
#: neighbours all differ in colour.
PROBE_COLOURING = {2: ((1, 2), 5), 3: ((1, 2, 3), 7)}


def probe_colours(grid_shape: tuple[int, ...], device) -> torch.Tensor:
    """The colour of every cell of a grid of ``grid_shape`` (int64, *grid)."""
    weights, q = PROBE_COLOURING[len(grid_shape)]
    colour = torch.zeros(grid_shape, dtype=torch.int64, device=device)
    for axis, (w, m) in enumerate(zip(weights, grid_shape)):
        shape = [1] * len(grid_shape)
        shape[axis] = m
        colour = colour + w * torch.arange(m, device=device).reshape(shape)
    return colour % q


@functools.lru_cache(maxsize=4)
def _probe_masks(grid_shape: tuple[int, ...], dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """(q, *grid): [k] is 1 on the cells of colour k, else 0."""
    _, q = PROBE_COLOURING[len(grid_shape)]
    on = probe_colours(grid_shape, device) == torch.arange(q, device=device).reshape(
        (q,) + (1,) * len(grid_shape))
    return on.to(dtype)


@functools.lru_cache(maxsize=4)
def _probe_index(grid_shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """(2·dim+1, 1, 1, cells): the probe that holds each stencil slot of
    each cell — the colour of the slot's neighbour (slot 0 the cell itself,
    1 + 2a the next cell along axis a, 2 + 2a the previous one)."""
    weights, q = PROBE_COLOURING[len(grid_shape)]
    offsets = [0] + [o for w in weights for o in (w, -w)]
    colour = probe_colours(grid_shape, device).reshape(1, -1)
    off = torch.tensor(offsets, dtype=torch.int64, device=device).reshape(-1, 1)
    return ((colour + off) % q).reshape(len(offsets), 1, 1, -1)


def probe_stencil(nc: int, grid_shape: tuple[int, ...], jvp: Callable,
                  dtype: torch.dtype, device) -> BlockStencil:
    """The block stencil of the Jacobian whose product is ``jvp`` (v ↦ J·v
    on states (nc, *grid)), by coloured probing.

    J is a block 7-point (2D: 5-point) stencil, and a cell and its
    neighbours all differ in colour (:data:`PROBE_COLOURING`), so
    J·(e_c ⊙ [colour = k]) holds at each cell i, in row r, ∂R_r(i)/∂u_c(j)
    for the one cell j of i's stencil of colour k: q·nc products give every
    coefficient, and one gather sorts them into the slots.  A slot whose
    neighbour lies outside the grid has no cell of its colour in the
    stencil, and reads an exact zero.  The colour masks and the gather's
    index depend on the grid alone and are built once; each unit tangent is
    a window of one buffer, whose middle row the colour's mask fills."""
    device = torch.device(device)
    dim, cells = len(grid_shape), math.prod(grid_shape)
    masks = _probe_masks(grid_shape, dtype, device)
    q = masks.shape[0]
    count("assembly.probed")
    count("assembly.probes", q * nc)
    # one buffer of 2·nc − 1 rows, zero but for its middle row, which holds
    # colour k's mask: its nc rows from row nc − 1 − c are e_c ⊙ [colour = k]
    window = torch.zeros((2 * nc - 1,) + grid_shape, dtype=dtype, device=device)
    ys = []
    for k in range(q):
        window[nc - 1].copy_(masks[k])
        ys += [jvp(window[nc - 1 - c:2 * nc - 1 - c]) for c in range(nc)]
    # [k, c, r, i] = (J·(e_c ⊙ [colour = k]))[r, i]
    ys = torch.stack(ys).reshape(q, nc, nc, cells).transpose(1, 2)
    index = _probe_index(grid_shape, device).expand(2 * dim + 1, nc, nc, cells)
    coef = torch.gather(ys, 0, index)
    return BlockStencil(coef.reshape((2 * dim + 1, nc, nc) + grid_shape))


class ThermalModelBase:
    """Shared residual/stencil machinery; subclasses define the local physics."""

    nc: int = 0

    def __init__(self, grid: Grid, pp: PhysicalParams):
        self.grid = grid
        self.pp = pp
        # depth_L − depth_R across a face per axis: −dz along the gravity
        # axis of a 3D grid, 0 elsewhere
        dd = [0.0] * grid.dim
        if grid.dim == 3 and grid.gravity != 0.0:
            dd[2] = -grid.spacing[2]
        self._ddepth = tuple(dd)

    # -- subclass contract -------------------------------------------------
    def cell_terms(self, u, u_old, dt, phi, well: WellFields):
        raise NotImplementedError

    def face_terms(self, axis: int, u_l, u_r, tgeo, tcond):
        raise NotImplementedError

    def initial_state(self, data: ProblemData, dtype=None) -> torch.Tensor:
        raise NotImplementedError

    def residual_scales(self, u_old, dt, data: ProblemData) -> torch.Tensor:
        """Characteristic per-cell accumulation magnitudes, (nc, *grid): the
        material-balance scales of the Newton convergence test.  Inert
        (k = 0) cells count, as in the reference."""
        raise NotImplementedError

    def in_place_totals(self, u, data: ProblemData) -> torch.Tensor:
        """Total conserved content per equation row, (nc,): the integrals of
        the accumulation densities of :meth:`cell_terms` (over a grid
        decomposition the owned cells', summed over the ranks:
        :meth:`cell_sums`)."""
        raise NotImplementedError

    @staticmethod
    def cell_sums(parts, data: ProblemData, acc: torch.dtype) -> torch.Tensor:
        """(len(parts),) sums over the cells of the per-cell tensors
        ``parts`` in ``acc``; over a grid decomposition (``data.block``, the
        tensors held on its extended block) the owned cells' partials summed
        over the ranks."""
        block = getattr(data, "block", None)
        if block is None:
            return torch.stack([t.sum(dtype=acc) for t in parts])
        return block.mesh.allreduce_sum(
            torch.stack([block.owned(t, lead=0).sum(dtype=acc) for t in parts]))

    def source_totals(self, u, data: ProblemData) -> torch.Tensor:
        """Net well/heater source per equation row at state ``u``, (nc,),
        summed in f64 when the state is f32; over a grid decomposition
        (``data.block``) the owned cells' partials summed over the ranks."""
        q = self.well_sources(u, data.wells)
        block = getattr(data, "block", None)
        if block is None:
            return q.reshape(self.nc, -1).sum(dim=1, dtype=reduce_dtype(u.dtype))
        q = block.owned(q, lead=1)
        return block.mesh.allreduce_sum(
            q.reshape(self.nc, -1).sum(dim=1, dtype=reduce_dtype(u.dtype)))

    # -- residual -----------------------------------------------------------
    def residual(self, u: torch.Tensor, u_old: torch.Tensor, dt,
                 data: ProblemData) -> torch.Tensor:
        """Backward-Euler residual, shape (nc, *grid):
        R_i = V·(acc(u_i) − acc(u_old_i))/Δt + Σ_faces F_f − q_i."""
        res = self.cell_terms(u, u_old, dt, data.phi, data.wells)
        for axis in range(self.grid.dim):
            f = self.face_terms(axis, u, neighbor_plus(u, axis),
                                data.tgeo[axis], data.tcond[axis])
            res = divergence_add(res, f, axis, lead=1)
        return res

    # -- Krylov operator ----------------------------------------------------
    def jvp(self, u, u_old, dt, data: ProblemData):
        """``v ↦ J(u)·v``, the exact matrix-free Jacobian product (the plain
        version of the ``fused_jvp`` kernel)."""

        def op(v):
            return torch.func.jvp(lambda x: self.residual(x, u_old, dt, data), (u,), (v,))[1]

        return op

    # -- stencil assembly ---------------------------------------------------
    def assemble_stencil(self, u, u_old, dt, data: ProblemData,
                         jvp: Callable | None = None) -> BlockStencil:
        """Exact block stencil of ∂R/∂u.

        On the card, where the caller gives ``jvp`` (v ↦ J(u)·v, the
        ``fused_jvp`` kernel at this state), by coloured probing through it
        (:func:`probe_stencil`).  Otherwise by broadcast-tangent JVPs: cell
        and face terms are pointwise, so the c-th unit tangent broadcast
        over every cell gives the c-th column of every local block in one
        full-shape JVP.  The nc tangents go through one batched JVP
        (``torch.func.vmap``) per term, a face's two sides (2·nc tangents)
        through one: the same elementwise arithmetic per tangent, and the
        same bits, as nc separate passes, in a fraction of their operations'
        dispatches.
        """
        with span("assembly"):
            nc, dim = self.nc, self.grid.dim
            if jvp is not None and u.device.type == "cuda":
                return probe_stencil(nc, tuple(u.shape[1:]), jvp, u.dtype, u.device)
            eye = torch.eye(nc, dtype=u.dtype, device=u.device).reshape((nc, nc) + (1,) * dim)
            tangents = eye.expand((nc,) + tuple(u.shape)).contiguous()
            zeros = torch.zeros_like(tangents)
            left, right = torch.cat([tangents, zeros]), torch.cat([zeros, tangents])
            cell_fn = lambda x: self.cell_terms(x, u_old, dt, data.phi, data.wells)
            # [i, c] = ∂R_i/∂u_c of the same cell
            diag = vmap(lambda t: torch.func.jvp(cell_fn, (u,), (t,))[1], out_dims=1)(tangents)
            uppers, lowers = [], []
            for axis in range(dim):
                ur = neighbor_plus(u, axis)
                tg, tc = data.tgeo[axis], data.tcond[axis]
                face_fn = lambda a, b: self.face_terms(axis, a, b, tg, tc)
                both = vmap(lambda tl, tr: torch.func.jvp(face_fn, (u, ur), (tl, tr))[1],
                            out_dims=1)(left, right)
                dfl, dfr = both[:, :nc], both[:, nc:]
                # face i adds +F to cell i and −F to cell i+1
                uppers.append(dfr)
                lowers.append(-shift_plus(dfl, axis, lead=2))
                diag = diag + dfl - shift_plus(dfr, axis, lead=2)
            return BlockStencil.from_parts(diag, uppers, lowers)
