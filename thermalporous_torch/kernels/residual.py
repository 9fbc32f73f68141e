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
"""

from __future__ import annotations

import ctypes

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
    out = torch.empty_like(u)
    params = (ctypes.c_double * _lib.MODEL_NUM_PARAMS)(*params_of(model))
    _lib.launch(f"{prefix}_{kind}", _lib.dtype_code(u), u.data_ptr(), second.data_ptr(),
                data.fields.data_ptr(), out.data_ptr(), float(dt),
                ctypes.cast(params, ctypes.c_void_p), dim, *_lib.dims3(grid),
                _lib.stream_of(u))
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
