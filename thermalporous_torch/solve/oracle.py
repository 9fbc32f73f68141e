"""High-precision dense reference solver, the "oracle" (counterpart of
``thermalporous_tpu/solve/oracle.py``).

One backward-Euler step solved by dense Newton in f64 on the CPU over the
SAME residual function as the production stack: the Jacobian is
``torch.func.jacfwd`` of ``model.residual`` (not ``assemble_stencil``, so
the oracle stays independent of the assembly it gates) and each Newton
system is solved by ``torch.linalg.solve``.  The production
Newton–FGMRES–CPTR stack must reproduce its states per step to a tight
tolerance.  Tiny grids only (dense Jacobian).
"""

from __future__ import annotations

import math

import torch

from thermalporous_torch.models.base import ProblemData, ThermalModelBase

F64 = torch.float64


def _check_data(data: ProblemData) -> None:
    f = data.fields
    if f.device.type != "cpu" or f.dtype != F64:
        raise ValueError(f"the oracle runs in f64 on the CPU; data is {f.dtype} "
                         f"on {f.device}")


def dense_newton_step(
    model: ThermalModelBase,
    u_old: torch.Tensor,
    dt: float,
    data: ProblemData,
    rtol: float = 1e-12,
    atol: float = 0.0,
    max_iters: int = 50,
    max_backtracks: int = 10,
) -> torch.Tensor:
    """One backward-Euler step solved by dense Newton with an Armijo line
    search (f64, CPU); raises ``RuntimeError`` on an exhausted line search
    or when Newton does not converge in ``max_iters``."""
    _check_data(data)
    u_old = u_old.to(device="cpu", dtype=F64)
    u = u_old.clone()
    shape = tuple(u.shape)
    n = u.numel()

    def res(x):
        return model.residual(x, u_old, dt, data)

    f = res(u)
    nrm0 = float(torch.linalg.vector_norm(f))
    tol = max(rtol * nrm0, atol)
    for _ in range(max_iters):
        nrm = float(torch.linalg.vector_norm(f))
        if nrm <= tol:
            break
        jac = torch.func.jacfwd(res)(u).reshape(n, n)
        dx = torch.linalg.solve(jac, -f.reshape(n)).reshape(shape)
        alpha = 1.0
        accepted = False
        for _ in range(max_backtracks):
            u_try = u + alpha * dx
            f_try = res(u_try)
            n_try = float(torch.linalg.vector_norm(f_try))
            if math.isfinite(n_try) and n_try <= (1.0 - 1e-4 * alpha) * nrm:
                accepted = True
                break
            alpha *= 0.5
        if not accepted:
            # the oracle is the parity gate: never adopt a non-decreasing
            # (possibly non-finite) iterate silently
            raise RuntimeError(
                f"oracle line search exhausted {max_backtracks} backtracks: "
                f"|F|={nrm:.3e}, best try |F|={n_try:.3e}")
        u, f = u_try, f_try
    else:
        raise RuntimeError(f"oracle Newton did not converge: |F|={nrm:.3e}")
    return u


def oracle_run(
    model: ThermalModelBase,
    data: ProblemData,
    dts: list[float],
    u0: torch.Tensor | None = None,
    **kwargs,
) -> list[torch.Tensor]:
    """Run a fixed Δt sequence; returns the state after every step."""
    _check_data(data)
    u = model.initial_state(data) if u0 is None else u0
    states = []
    for dt in dts:
        u = dense_newton_step(model, u, dt, data, **kwargs)
        states.append(u.clone())
    return states
