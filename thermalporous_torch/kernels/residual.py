"""Fused residual kernel of the two-phase model (``csrc/residual.cu``).

The wrapper's plain version is the model's own
:meth:`~thermalporous_torch.models.base.ThermalModelBase.residual`: for
tensors on the CPU it returns that; for CUDA tensors it launches the kernel
(two-phase model only) or raises, and adds one to ``fused_residual.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from thermalporous_torch.kernels import _lib
from thermalporous_torch.kernels.stencil import _check
from thermalporous_torch.models.base import ProblemData, n_fields
from thermalporous_torch.models.twophase import TwoPhaseModel


def twophase_params(model: TwoPhaseModel) -> list[float]:
    """The constants of ``TwoPhaseParams`` (csrc/residual.cu), in its field
    order, as host doubles.  Compound constants are formed in double here
    exactly where the plain version forms them in Python floats."""
    pp, rp, grid = model.pp, model.relperm, model.grid
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
    assert len(vals) == _lib.TWOPHASE_NUM_PARAMS
    return [float(v) for v in vals]


def fused_residual(model, u: torch.Tensor, u_old: torch.Tensor, dt: float,
                   data: ProblemData) -> torch.Tensor:
    """The whole backward-Euler residual (nc, *grid) in one pass per cell."""
    dev = _check("fused_residual", u, u_old, data.fields)
    grid = model.grid.shape
    dim = len(grid)
    if (tuple(u.shape) != (model.nc,) + grid or u_old.shape != u.shape
            or tuple(data.fields.shape) != (n_fields(dim),) + grid):
        raise ValueError(f"fused_residual: u {tuple(u.shape)}, fields "
                         f"{tuple(data.fields.shape)}, grid {grid}")
    if dev.type == "cpu":
        return model.residual(u, u_old, dt, data)
    if type(model) is not TwoPhaseModel:
        raise NotImplementedError(
            f"fused_residual kernel: {type(model).__name__} has no CUDA kernel")
    out = torch.empty_like(u)
    params = (ctypes.c_double * _lib.TWOPHASE_NUM_PARAMS)(*twophase_params(model))
    _lib.launch("tp_twophase_residual", _lib.dtype_code(u), u.data_ptr(),
                u_old.data_ptr(), data.fields.data_ptr(), out.data_ptr(),
                float(dt), ctypes.cast(params, ctypes.c_void_p), dim,
                *_lib.dims3(grid), _lib.stream_of(u))
    fused_residual.launches += 1
    return out


fused_residual.launches = 0
