"""The implicit step factory (counterpart of
``thermalporous_tpu/solve/timeloop.py:make_step_fn``).

``make_step_fn`` builds ``advance(u_old, dt, data, u_guess=None)``: one
backward-Euler step as a Newton solve — stencil assembly, CPTR setup,
FGMRES with the stencil as the Krylov operator, line search — with
material-balance-scaled convergence norms.  It is the port's main path.

The residual goes through the ``fused_residual`` kernel wrapper and the
Krylov operator through the ``block_matvec`` wrapper (``BlockStencil.matvec``),
the preconditioner through the scalar matvec and Chebyshev wrappers: on a
CUDA device they launch the hand-written kernels, on the CPU they run their
plain PyTorch versions.
"""

from __future__ import annotations

import torch

from thermalporous_torch._device import require_cuda
from thermalporous_torch.kernels.residual import fused_residual
from thermalporous_torch.models.base import ProblemData, ThermalModelBase
from thermalporous_torch.precond.cpr import CPRConfig, make_preconditioner
from thermalporous_torch.solve.newton import NewtonConfig, NewtonStats, newton_solve


def make_step_fn(
    model: ThermalModelBase,
    precond: str = "cptr",
    newton_cfg: NewtonConfig = NewtonConfig(),
    pc_cfg: CPRConfig | None = None,
    device: torch.device | str = "cpu",
):
    """Build ``advance(u_old, dt, data, u_guess=None) -> (u, NewtonStats)``
    for tensors on ``device`` (``dt`` a Python float in seconds)."""
    device = require_cuda(device)
    pc_setup, pc_apply = make_preconditioner(precond, pc_cfg)

    def advance(u_old: torch.Tensor, dt: float, data: ProblemData,
                u_guess: torch.Tensor | None = None) -> tuple[torch.Tensor, NewtonStats]:
        for t in (u_old, data.fields) + (() if u_guess is None else (u_guess,)):
            if t.device.type != device.type:
                raise ValueError(f"make_step_fn({device}): tensor on {t.device}")
        dt = float(dt)
        return newton_solve(
            residual=lambda u: fused_residual(model, u, u_old, dt, data),
            assemble=lambda u: model.assemble_stencil(u, u_old, dt, data),
            pc_setup=pc_setup,
            pc_apply=pc_apply,
            u0=u_old if u_guess is None else u_guess,
            cfg=newton_cfg,
            scale=model.residual_scales(u_old, dt, data),
            norm_from=None if u_guess is None else u_old,
        )

    return advance
