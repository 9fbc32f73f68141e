"""Newton's method with backtracking line search (counterpart of
``thermalporous_tpu/solve/newton.py``).

Each iteration assembles the block stencil (the exact Jacobian), builds the
preconditioner, solves J·dx = −F with FGMRES using the stencil as the
Krylov operator, optionally limits dx (the ``chop`` hook: the Appleyard
saturation chop), and backtracks α ∈ {1, ½, ¼, …} until the (optionally
material-balance-scaled) residual norm is acceptable.  The loop runs on
the host; each residual norm is fetched once to decide, and the
Eisenstat–Walker forcing term is computed on the host from those norms, in
the compute dtype, as the reference computes it on the device.

Ported: the Armijo and nonmonotone line searches (``ls_growth``,
``ls_div_ratio``), Eisenstat–Walker forcing (with the left-scaling of the
linear system by the material-balance scales), scaled norms with the
dtype-aware floor, ``norm_from``, the ``chop`` hook, ``pc_lag="every"`` and
``krylov_op="stencil"``.  The frozen preconditioner (``pc_lag="step"``),
restarts, recycling and the JVP Krylov operator raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from thermalporous_torch._device import reduce_dtype
from thermalporous_torch.solve.fgmres import _NP, fgmres


@dataclasses.dataclass(frozen=True)
class NewtonConfig:
    """The reference's fields, defaults and validation (see
    ``thermalporous_tpu/solve/newton.py:NewtonConfig`` for each option)."""

    max_iters: int = 15
    rtol: float = 1e-6            # ‖F‖ ≤ max(rtol·‖F₀‖, atol)
    atol: float = 0.0
    ksp_rtol: float = 1e-5
    ksp_atol: float = 0.0
    ksp_maxiter: int = 60
    ksp_ew: bool = False
    ew_rtol0: float = 0.3
    ew_rtolmax: float = 0.9
    ew_gamma: float = 1.0
    ew_alpha: float = 1.618033988749895
    ew_threshold: float = 0.1
    ksp_restart: int | None = None
    ksp_basis: str = "same"       # Arnoldi basis storage: "same" | "bf16"
    ksp_orth: str = "cgs2"        # ported: "cgs2" | "cgs2g"
    ksp_recycle: int = 0
    max_backtracks: int = 6
    ls_decrease: float = 1e-4
    ls_mode: str = "armijo"       # "armijo" | "nonmonotone"
    ls_growth: float = 0.25
    ls_div_ratio: float = 4.0
    ds_max: float | None = None
    pc_lag: str = "every"         # ported: "every"
    krylov_op: str = "stencil"    # ported: "stencil"

    def __post_init__(self):
        _check = {
            "ksp_basis": ("same", "bf16"),
            "ksp_orth": ("cgs2", "cgs1", "cgs2s", "cgs2g", "cgs2g2"),
            "ls_mode": ("armijo", "nonmonotone"),
            "pc_lag": ("every", "step"),
            "krylov_op": ("stencil", "jvp", "stencil_pallas"),
        }
        for field, allowed in _check.items():
            v = getattr(self, field)
            if v not in allowed:
                raise ValueError(f"unknown {field} {v!r}; one of {allowed}")


def _check_ported(cfg: NewtonConfig) -> None:
    if cfg.ksp_orth not in ("cgs2", "cgs2g"):
        raise NotImplementedError(f"ksp_orth {cfg.ksp_orth!r} is not ported")
    if cfg.krylov_op != "stencil":
        raise NotImplementedError(f"krylov_op {cfg.krylov_op!r} is not ported")
    if cfg.ksp_restart is not None and cfg.ksp_restart < cfg.ksp_maxiter:
        raise NotImplementedError("FGMRES restarts are not ported")
    if cfg.ksp_recycle:
        raise NotImplementedError("Krylov recycling is not ported")
    if cfg.pc_lag != "every":
        raise NotImplementedError(f"pc_lag {cfg.pc_lag!r} is not ported")


@dataclasses.dataclass
class NewtonStats:
    iters: int          # Newton iterations performed
    ksp_iters: int      # total FGMRES iterations
    norm0: float        # initial residual norm
    norm: float         # final residual norm
    converged: bool
    failed: bool        # line search exhausted / non-finite / not converged


def newton_solve(
    residual: Callable[[torch.Tensor], torch.Tensor],
    assemble: Callable[[torch.Tensor], object],
    pc_setup: Callable[[object], object],
    pc_apply: Callable[[object, torch.Tensor], torch.Tensor],
    u0: torch.Tensor,
    cfg: NewtonConfig = NewtonConfig(),
    scale: torch.Tensor | None = None,
    norm_from: torch.Tensor | None = None,
    chop: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
) -> tuple[torch.Tensor, NewtonStats]:
    """Solve residual(u) = 0 from ``u0``.

    ``assemble`` gives the Jacobian's BlockStencil (the Krylov operator and
    the preconditioner's input), ``scale`` the per-cell material-balance
    scales of the convergence norm, ``norm_from`` the physical step start
    when ``u0`` is a predicted guess (the tolerance anchors there, and a
    guess worse than it is discarded), ``chop(u, dx) -> dx`` a limiter of
    the Newton direction applied before the line search."""
    _check_ported(cfg)
    dtype = u0.dtype
    npt = _NP[dtype]
    rd = reduce_dtype(dtype)
    if scale is None:
        def norm(f):
            q = f.reshape(-1).to(rd)
            return npt(torch.sqrt(torch.dot(q, q)).to(dtype).item())
        atol = cfg.atol
    else:
        def norm(f):
            q = (f / scale).reshape(-1).to(rd)
            return npt(torch.sqrt(torch.dot(q, q) / q.numel()).to(dtype).item())
        atol = max(cfg.atol, 50.0 * float(torch.finfo(dtype).eps))

    f0 = residual(u0)
    nrm_start = norm(f0)
    if norm_from is not None:
        # rtol anchors on the physical step start; a guess whose residual is
        # worse than the step start's is discarded
        f_ref = residual(norm_from)
        nrm0 = norm(f_ref)
        if not nrm_start <= nrm0:
            u0, f0, nrm_start = norm_from, f_ref, nrm0
    else:
        nrm0 = nrm_start
    tol = np.maximum(npt(cfg.rtol) * nrm0, npt(atol))
    basis = torch.bfloat16 if cfg.ksp_basis == "bf16" else None
    nonmonotone = cfg.ls_mode == "nonmonotone"
    # Eisenstat–Walker forcing term, a compute-dtype scalar on the host
    eta = npt(min(max(cfg.ew_rtol0, cfg.ksp_rtol), cfg.ew_rtolmax)) if cfg.ksp_ew else None
    tiny = npt(torch.finfo(dtype).tiny)

    u, f, nrm, k, ksp, failed = u0, f0, nrm_start, 0, 0, False
    while nrm > tol and k < cfg.max_iters and not failed:
        st = assemble(u)                 # exact J; one assembly serves both
        pcs = pc_setup(st)
        if cfg.ksp_ew and scale is not None:
            # left-scale the system by the material-balance scales, so that
            # FGMRES enforces η in the norm Newton gates on
            matvec = lambda v: st.matvec(v) / scale
            rhs = -(f / scale)
            krylov_pc = lambda r: pc_apply(pcs, r * scale)
        else:
            matvec, rhs = st.matvec, -f
            krylov_pc = lambda r: pc_apply(pcs, r)
        result = fgmres(
            matvec, rhs, precond=krylov_pc,
            rtol=eta if cfg.ksp_ew else cfg.ksp_rtol, atol=cfg.ksp_atol,
            maxiter=cfg.ksp_maxiter, basis_dtype=basis,
            orth_gram=3 if cfg.ksp_orth == "cgs2g" else 0,
        )
        dx = result.x
        if chop is not None:
            dx = chop(u, dx)

        cap = npt(1.0 + cfg.ls_growth) * nrm if nonmonotone else None
        alpha, tries, accepted = npt(1.0), 0, False
        while not accepted and tries < cfg.max_backtracks:
            u_t = u + float(alpha) * dx
            f_t = residual(u_t)
            n_t = norm(f_t)
            bound = cap if nonmonotone else (npt(1.0) - npt(cfg.ls_decrease) * alpha) * nrm
            accepted = bool(np.isfinite(n_t) and n_t <= bound)
            alpha, tries = alpha * npt(0.5), tries + 1
        failed_now = not accepted
        if nonmonotone and not failed_now:
            # the divergence guard: blow-up past the step start's residual
            failed_now = bool(n_t > npt(cfg.ls_div_ratio) * nrm0)
        if cfg.ksp_ew and not failed_now:
            # version-2 update from the contraction of the scaled norm
            ratio = n_t / max(nrm, tiny)
            eta_a = npt(cfg.ew_gamma) * ratio ** npt(cfg.ew_alpha)
            eta_safe = npt(cfg.ew_gamma) * eta ** npt(cfg.ew_alpha)
            eta_next = max(eta_a, eta_safe) if eta_safe > npt(cfg.ew_threshold) else eta_a
            eta = npt(min(max(eta_next, npt(cfg.ksp_rtol)), npt(cfg.ew_rtolmax)))
        if not failed_now:     # on failure keep the old iterate; the caller cuts Δt
            u, f, nrm = u_t, f_t, n_t
        k, ksp, failed = k + 1, ksp + result.iters, failed_now

    converged = bool(nrm <= tol)
    return u, NewtonStats(iters=k, ksp_iters=ksp, norm0=float(nrm0),
                          norm=float(nrm), converged=converged,
                          failed=failed or not converged)
