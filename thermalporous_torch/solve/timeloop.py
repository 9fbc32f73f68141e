"""The implicit step and the adaptive-Δt time loop (counterpart of
``thermalporous_tpu/solve/timeloop.py``).

``make_step_fn`` builds ``advance(u_old, dt, data, u_guess=None)``: one
backward-Euler step as a Newton solve — stencil assembly, CPTR setup,
FGMRES with the stencil as the Krylov operator, the Appleyard saturation
chop when ``NewtonConfig.ds_max`` is set, line search — with
material-balance-scaled convergence norms.  :class:`Simulator` drives it
with the adaptive Δt controller: grow after an easy step, shrink after a
hard one, cut back and retry on failure, and (``TimeConfig.fail_frac``)
remember failed Δt as a regrowth cap.

The residual goes through the ``fused_residual`` kernel wrapper, the Krylov
operator through ``block_matvec``, the preconditioner through the scalar
matvec, Chebyshev, red-black Gauss–Seidel and coarse-subtree wrappers: on a
CUDA device they launch the hand-written kernels, on the CPU they run their
plain PyTorch versions.  Every entry point runs on the card unless the
caller passes ``device="cpu"``.

Not ported: blocked stepping (``TimeConfig.block_steps > 1``,
``make_block_step_fn``) and ``Simulator.run_schedule``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from thermalporous_torch._device import require_cuda
from thermalporous_torch.kernels.residual import fused_residual
from thermalporous_torch.models.base import ProblemData, ThermalModelBase
from thermalporous_torch.precond.cpr import (
    CPRConfig,
    make_preconditioner,
    resolve_adaptive_coarsening,
)
from thermalporous_torch.solve.newton import NewtonConfig, NewtonStats, newton_solve


def make_step_fn(
    model: ThermalModelBase,
    precond: str = "cptr",
    newton_cfg: NewtonConfig = NewtonConfig(),
    pc_cfg: CPRConfig | None = None,
    device: torch.device | str = "cuda",
):
    """Build ``advance(u_old, dt, data, u_guess=None) -> (u, NewtonStats)``
    for tensors on ``device`` (``dt`` a Python float in seconds)."""
    device = require_cuda(device)
    pc_setup, pc_apply = make_preconditioner(precond, pc_cfg)

    chop = None
    if newton_cfg.ds_max is not None and model.nc >= 3:
        ds_max = float(newton_cfg.ds_max)

        def chop(u, dx):
            # Appleyard chop: clamp |ΔS_w| per cell, and the updated
            # saturation to its physical range
            ds = torch.clamp(dx[2], -ds_max, ds_max)
            ds = torch.minimum(torch.maximum(ds, -u[2]), 1.0 - u[2])
            return torch.cat([dx[:2], ds[None], dx[3:]])

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
            chop=chop,
        )

    return advance


@dataclasses.dataclass(frozen=True)
class TimeConfig:
    """The reference's Δt controller settings (see
    ``thermalporous_tpu/solve/timeloop.py:TimeConfig``)."""

    dt_init: float = 3600.0
    dt_min: float = 1.0
    dt_max: float = 1e7
    growth: float = 1.5          # Δt multiplier after an easy step
    cutback: float = 0.5         # Δt multiplier on failure / hard step
    grow_below: int = 6          # grow when newton_iters < this
    shrink_above: int = 10       # shrink next Δt when newton_iters > this
    max_retries: int = 12
    # failure memory (None = off): each failed attempt at dt_f caps regrowth
    # at fail_frac·dt_f; the cap relaxes by fail_relax per accepted step
    fail_frac: float | None = None
    fail_relax: float = 1.25
    predictor: str = "none"      # "none" | "linear"
    block_steps: int = 1         # > 1 is not ported

    def __post_init__(self):
        if self.block_steps > 1:
            raise NotImplementedError("blocked stepping (block_steps > 1) is not ported")
        if self.predictor not in ("none", "linear"):
            raise ValueError(f"unknown predictor {self.predictor!r}")


@dataclasses.dataclass
class StepRecord:
    """One accepted timestep's telemetry (the reference's fields)."""

    step: int
    t: float
    dt: float
    newton_iters: int
    ksp_iters: int
    retries: int
    residual_norm0: float
    residual_norm: float
    wall_s: float
    next_dt: float = 0.0             # the controller's Δt for the next step
    dt_cap: float | None = None      # failure-memory cap after this step
    state_consistent: bool = True
    src_dt: tuple | None = None

    def as_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SimResult:
    u: torch.Tensor
    t: float
    steps: int
    records: list
    total_newton: int
    total_ksp: int
    wall_s: float


class Simulator:
    """The implicit step and the adaptive-Δt host loop, on ``device``."""

    def __init__(
        self,
        model: ThermalModelBase,
        data: ProblemData,
        precond: str = "cptr",
        pc_cfg: CPRConfig | None = None,
        newton_cfg: NewtonConfig = NewtonConfig(),
        time_cfg: TimeConfig = TimeConfig(),
        device: torch.device | str = "cuda",
    ):
        self.device = require_cuda(device)
        self.model = model
        self.data = data
        self.newton_cfg = newton_cfg
        self.time_cfg = time_cfg
        if pc_cfg is not None and (
            pc_cfg.gmg.coarsen == "adaptive"
            or (pc_cfg.gmg_t is not None and pc_cfg.gmg_t.coarsen == "adaptive")
        ):
            # bake the matrix-dependent coarsening schedule once, from the
            # initial state's Jacobian at dt_init
            u0 = model.initial_state(data)
            st = model.assemble_stencil(u0, u0, float(time_cfg.dt_init), data)
            pc_cfg = resolve_adaptive_coarsening(st, pc_cfg)
        self.pc_cfg = pc_cfg
        self._advance = make_step_fn(model, precond, newton_cfg, pc_cfg,
                                     device=self.device)

    def step(self, u_old: torch.Tensor, dt: float,
             u_guess: torch.Tensor | None = None) -> tuple[torch.Tensor, NewtonStats]:
        """One Newton solve (no Δt adaptivity); ``u_guess`` moves only the
        start point."""
        return self._advance(u_old, dt, self.data, u_guess)

    def _predict(self, u, u_prev, dt, dt_prev):
        """Linear-extrapolation initial guess, saturation clipped to [0, 1]."""
        fac = dt / max(dt_prev, 1e-30)
        g = u + fac * (u - u_prev)
        if u.shape[0] >= 3:
            g = torch.cat([g[:2], torch.clamp(g[2:3], 0.0, 1.0), g[3:]])
        return g

    def run(
        self,
        t_end: float,
        u0: torch.Tensor | None = None,
        dt0: float | None = None,
        t0: float = 0.0,
        step0: int = 0,
        max_steps: int = 100000,
        callback: Callable[[int, float, torch.Tensor, StepRecord], None] | None = None,
        verbose: bool = False,
        dt_cap0: float | None = None,
    ) -> SimResult:
        """Advance from (t0, u0) to t_end (or ``max_steps`` steps)."""
        tc = self.time_cfg
        u = self.model.initial_state(self.data) if u0 is None else u0
        t = t0
        dt = tc.dt_init if dt0 is None else dt0
        records: list[StepRecord] = []
        run_start = time.perf_counter()
        step_idx = step0
        u_prev = None
        dt_prev = 0.0
        dt_cap = float("inf") if dt_cap0 is None else float(dt_cap0)

        while t < t_end - 1e-12 * max(t_end, 1.0) and step_idx < max_steps:
            dt = min(dt, tc.dt_max, t_end - t)
            retries = 0
            step_start = time.perf_counter()
            while True:
                guess = None
                if tc.predictor == "linear" and u_prev is not None:
                    guess = self._predict(u, u_prev, dt, dt_prev)
                u_new, stats = self.step(u, dt, guess)
                if not stats.failed:
                    break
                if tc.fail_frac is not None:
                    dt_cap = min(dt_cap, dt * tc.fail_frac)
                retries += 1
                if retries > tc.max_retries or dt <= tc.dt_min:
                    raise RuntimeError(
                        f"step {step_idx}: Newton failed at dt={dt:.3e} after "
                        f"{retries - 1} retries (|F| {stats.norm:.3e} of "
                        f"{stats.norm0:.3e})")
                dt = max(dt * tc.cutback, tc.dt_min)

            t += dt
            step_idx += 1
            rec = StepRecord(
                step=step_idx, t=t, dt=dt, newton_iters=stats.iters,
                ksp_iters=stats.ksp_iters, retries=retries,
                residual_norm0=stats.norm0, residual_norm=stats.norm,
                wall_s=time.perf_counter() - step_start,
            )
            # Δt policy for the next step
            if tc.fail_frac is not None and dt_cap != float("inf"):
                dt_cap *= tc.fail_relax
            rec.dt_cap = dt_cap if dt_cap != float("inf") else None
            if rec.newton_iters < tc.grow_below:
                dt = max(min(dt * tc.growth, tc.dt_max, dt_cap), tc.dt_min)
            elif rec.newton_iters > tc.shrink_above:
                dt = max(dt * tc.cutback, tc.dt_min)
            rec.next_dt = dt

            records.append(rec)
            u_prev, dt_prev = u, rec.dt
            u = u_new
            if verbose:
                print(f"step {step_idx:4d}  t={t:.4e}  dt={rec.dt:.3e}  "
                      f"newton={rec.newton_iters}  ksp={rec.ksp_iters}  "
                      f"retries={retries}")
            if callback is not None:
                callback(step_idx, t, u, rec)

        return SimResult(
            u=u, t=t, steps=len(records), records=records,
            total_newton=sum(r.newton_iters for r in records),
            total_ksp=sum(r.ksp_iters for r in records),
            wall_s=time.perf_counter() - run_start,
        )
