"""Fused residual and JVP kernels of both models (``csrc/residual.cu``).

Each wrapper's plain version is the model's own method —
:meth:`~thermalporous_torch.models.base.ThermalModelBase.residual` for the
residual, :meth:`~thermalporous_torch.models.base.ThermalModelBase.jvp` for
J(u)·v: for tensors on the CPU a wrapper returns that; for CUDA tensors it
launches its model form's kernel (or raises) and adds one to that entry
point's counter in ``launches``.

Both wrappers take either model; ``_FORMS`` maps each model type to its C
entry points (``tp_twophase_*``, ``tp_singlephase_*``), its constants and
its counters (``fused_residual``/``fused_jvp`` for the two-phase kernels,
``fused_residual_sp``/``fused_jvp_sp`` for the single-phase ones).

All four entries are one kernel body: a block marches along grid axis 0
through a tile of the plane of the other axes (:func:`model_plan`), with
each cell's properties computed once and each face once per tile.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import weakref

import torch

from thermalporous_torch.kernels import _lib
from thermalporous_torch.kernels.stencil import _check
from thermalporous_torch.models.base import ProblemData, n_fields
from thermalporous_torch.models.singlephase import SinglePhaseModel
from thermalporous_torch.models.twophase import TwoPhaseModel
from thermalporous_torch.physics.relperm import CoreyRelPerm


def _params(model, rp: CoreyRelPerm) -> list[float]:
    """The constants of ``ModelParams`` (csrc/residual.cu), in its field
    order, as host doubles.  Compound constants are formed in double here
    exactly where the plain version forms them in Python floats."""
    pp, grid = model.pp, model.grid
    dd = list(model._ddepth) + [0.0] * (3 - len(model._ddepth))
    vals = [
        pp.p_ref, pp.T_ref, pp.rho_w_ref, pp.c_w, pp.beta_w, pp.cp_w,
        pp.rho_o_ref, pp.c_o, pp.beta_o, pp.cp_o, pp.mu_o_ref, pp.b_o,
        1.0 / pp.T_mu_ref,
        pp.rho_c_rock, grid.cell_volume, grid.gravity,
        *dd,
        rp.s_wr, 1.0 - rp.s_wr - rp.s_or, rp.n_w, rp.n_o, rp.k_rw_end,
        rp.k_ro_end,
        pp.MU_W_COEF, pp.MU_W_NUM, pp.MU_W_SHIFT,
    ]
    assert len(vals) == _lib.MODEL_NUM_PARAMS
    return [float(v) for v in vals]


def twophase_params(model: TwoPhaseModel) -> list[float]:
    return _params(model, model.relperm)


def singlephase_params(model: SinglePhaseModel) -> list[float]:
    """As :func:`twophase_params`; the relative-permeability slots hold the
    defaults, which the single-phase kernels do not read."""
    return _params(model, CoreyRelPerm())


#: threads of a block of the residual/JVP kernel (csrc/residual.cu:
#: kModelThreads): one per cell of the in-plane tile
MODEL_THREADS = 256
#: blocks per SM that :func:`model_plan` aims for when it cuts axis 0 into
#: chunks (the dual-number form keeps fewer blocks resident, so it takes
#: more and shorter chunks to even out its last wave: measured on the H100,
#: PERF.md), and the fewest planes of a chunk (its first plane computes one
#: set of properties and one face again)
MODEL_BLOCKS_PER_SM = {False: 4, True: 8}
MODEL_MIN_PLANES = 4
#: properties a face reads per cell (csrc/residual.cu: NPF), by unknowns
MODEL_FACE_PROPS = {3: 6, 2: 4}


@dataclasses.dataclass(frozen=True)
class ModelPlan:
    """Tiling of the residual/JVP kernel.  The grid is seen as (e0, e1, e2)
    with e1 = 1 in 2D; a block owns ``lx`` planes along axis 0 of a tile of
    ``ty`` rows of ``tz`` consecutive cells."""

    ty: int
    tz: int
    lx: int
    tiles_y: int
    tiles_z: int
    chunks: int

    @property
    def blocks(self) -> int:
        return self.tiles_y * self.tiles_z * self.chunks

    @property
    def threads(self) -> int:
        return 32 * -(-(self.ty * self.tz) // 32)

    def smem(self, dim: int, nc: int, item: int, jvp: bool) -> int:
        """Bytes of shared memory of a block (csrc/residual.cu:
        model_smem): two buffers of the face properties of the tile with
        its ring, as values or as (value, tangent) pairs, and of the
        tile's in-plane fluxes."""
        ring_rows = 2 if dim == 3 else 0
        cells = (self.ty + ring_rows) * (self.tz + 2)
        scalar = item * (2 if jvp else 1)
        return 2 * (MODEL_FACE_PROPS[nc] * cells * scalar
                    + 2 * nc * self.ty * self.tz * item)


@functools.cache
def model_plan(shape: tuple[int, ...], sms: int, jvp: bool = False) -> ModelPlan:
    """The tiling for a grid of ``shape`` on a card with ``sms`` SMs, for
    the residual or (``jvp``) the J(u)·v form.

    The in-plane tile is the one with the least work per plane: the lanes
    of its warps (idle ones included) plus half a lane for each ring cell,
    whose properties are computed again; rows keep at least 32 consecutive
    cells where the grid has them.  Axis 0 is cut into chunks until there
    are about ``MODEL_BLOCKS_PER_SM[jvp]`` blocks per SM, of at least
    ``MODEL_MIN_PLANES`` planes each."""
    n = math.prod(shape)
    if len(shape) not in (2, 3) or n < 1 or n >= 2**31:
        raise ValueError(f"residual kernel: grid {shape} (2 or 3 axes, "
                         f"1 <= cells < 2**31)")
    e0, e1, e2 = shape[0], (shape[1] if len(shape) == 3 else 1), shape[-1]
    best = None
    for tz in range(min(e2, 32), min(e2, MODEL_THREADS) + 1):
        tiles_z = -(-e2 // tz)
        tiles_y = -(-e1 // min(e1, MODEL_THREADS // tz))
        ty = -(-e1 // tiles_y)
        ring = (2 * tz if tiles_y > 1 else 0) + (2 * ty if tiles_z > 1 else 0)
        lanes = 32 * -(-(ty * tz) // 32)
        cost = tiles_y * tiles_z * (lanes + 16 * -(-ring // 32))
        if best is None or cost < best[0]:
            best = (cost, ty, tz, tiles_y, tiles_z)
    _, ty, tz, tiles_y, tiles_z = best
    want = -(-MODEL_BLOCKS_PER_SM[jvp] * sms // (tiles_y * tiles_z))
    chunks = max(1, min(want, e0 // MODEL_MIN_PLANES))
    lx = -(-e0 // chunks)
    return ModelPlan(ty, tz, lx, tiles_y, tiles_z, -(-e0 // lx))


#: Each model form with a kernel, by model type: the prefix of its C entry
#: points (``<prefix>_residual``, ``<prefix>_jvp``), its ``ModelParams``
#: constants, and the suffix of its launch counters.
_FORMS = {
    TwoPhaseModel: ("tp_twophase", twophase_params, ""),
    SinglePhaseModel: ("tp_singlephase", singlephase_params, "_sp"),
}

#: Launches per C entry point: ``fused_residual`` and ``fused_jvp`` count
#: the two-phase kernels, ``fused_residual_sp`` and ``fused_jvp_sp`` the
#: single-phase ones.
launches = dict.fromkeys(
    ("fused_residual", "fused_residual_sp", "fused_jvp", "fused_jvp_sp"), 0)


#: the constants of each model seen so far, as the C entries take them
_PARAMS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _params_array(model, params_of) -> ctypes.c_void_p:
    """``params_of(model)`` as a host double array, built once per model
    (a model's constants do not change after it is made)."""
    held = _PARAMS.get(model)
    if held is None:
        array = (ctypes.c_double * _lib.MODEL_NUM_PARAMS)(*params_of(model))
        held = _PARAMS[model] = (array, ctypes.cast(array, ctypes.c_void_p))
    return held[1]


def _run(kind: str, model, u: torch.Tensor, second: torch.Tensor, u_old: torch.Tensor,
         dt: float, data: ProblemData, plain) -> torch.Tensor:
    """Check the arguments, then ``plain()`` on the CPU or the ``kind``
    ("residual" or "jvp") entry of ``model``'s form on (u, second) on the
    card.  ``second`` is u_old for a residual and v for a JVP."""
    name = f"fused_{kind}"
    dev = _check(name, u, second, u_old, data.fields)
    grid = model.grid.shape
    dim = len(grid)
    if (tuple(u.shape) != (model.nc,) + grid or second.shape != u.shape
            or u_old.shape != u.shape
            or tuple(data.fields.shape) != (n_fields(dim),) + grid):
        raise ValueError(f"{name}: u {tuple(u.shape)}, fields "
                         f"{tuple(data.fields.shape)}, grid {grid}")
    if dev.type == "cpu":
        return plain()
    form = _FORMS.get(type(model))
    if form is None:
        raise NotImplementedError(f"{name} kernel: {type(model).__name__} has no CUDA kernel")
    prefix, params_of, suffix = form
    plan = model_plan(grid, _lib.limits_of(u)[0], kind == "jvp")
    out = torch.empty_like(u)
    _lib.launch(f"{prefix}_{kind}", _lib.dtype_code(u), u.data_ptr(), second.data_ptr(),
                data.fields.data_ptr(), out.data_ptr(), float(dt),
                _params_array(model, params_of), dim, *_lib.dims3(grid),
                plan.ty, plan.tz, plan.lx, _lib.stream_of(u))
    launches[name + suffix] += 1
    return out


def fused_residual(model, u: torch.Tensor, u_old: torch.Tensor, dt: float,
                   data: ProblemData) -> torch.Tensor:
    """The whole backward-Euler residual (nc, *grid) in one pass per cell."""
    return _run("residual", model, u, u_old, u_old, dt, data,
                lambda: model.residual(u, u_old, dt, data))


def fused_jvp(model, u: torch.Tensor, v: torch.Tensor, u_old: torch.Tensor, dt: float,
              data: ProblemData) -> torch.Tensor:
    """J(u)·v, the exact directional derivative of the residual at ``u``, in
    one pass per cell (the kernel reads u, v and the fields: the old
    accumulation is a constant, whose tangent is zero)."""
    return _run("jvp", model, u, v, u_old, dt, data,
                lambda: model.jvp(u, u_old, dt, data)(v))
