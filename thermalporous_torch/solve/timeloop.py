"""The implicit step and the adaptive-Δt time loop (counterpart of
``thermalporous_tpu/solve/timeloop.py``).

``make_step_fn`` builds ``advance(u_old, dt, data, u_guess=None)``: one
backward-Euler step as a Newton solve — stencil assembly, CPTR setup,
FGMRES with the stencil or (``NewtonConfig.krylov_op="jvp"``) the
matrix-free J·v as the Krylov operator, the Appleyard saturation chop when
``NewtonConfig.ds_max`` is set (models with a saturation), line search — with
material-balance-scaled convergence norms.  :class:`Simulator` drives it
with the adaptive Δt controller: grow after an easy step, shrink after a
hard one, cut back and retry on failure, and (``TimeConfig.fail_frac``)
remember failed Δt as a regrowth cap.

The residual goes through the ``fused_residual`` kernel wrapper, the Krylov
operator through ``block_matvec`` or ``fused_jvp``, the assembly on the card
through ``fused_jvp`` too (coloured probing, ``models/base.py:probe_stencil``),
the preconditioner through the scalar matvec, Chebyshev, red-black Gauss–Seidel and
coarse-subtree wrappers: on a CUDA device they launch the hand-written
kernels, on the CPU they run their plain PyTorch versions.  Every entry point runs on the card unless the
caller passes ``device="cpu"``.

Blocked stepping (``TimeConfig.block_steps > 1``, :func:`make_block_step_fn`)
advances several controller steps per call with the reference's in-block
controller and records, and :meth:`Simulator.run_schedule` runs
piecewise-constant well and heater controls.

Over a grid decomposition the data is
:func:`~thermalporous_torch.dist.sharding.shard_problem_data`'s and the
states :func:`~thermalporous_torch.dist.sharding.shard_state`'s (this
rank's extended blocks): the step extends each Newton iterate by one
exchange, evaluates the residual and assembles the Jacobian on the extended
block, keeps the owned rows, and runs Newton and FGMRES on owned blocks
with every reduction through the mesh, so that the Δt controller, its
retries and its failure-memory cap take the same values on every rank
(every ``ksp_orth``, and ``ksp_recycle`` with its recycle space's dots
through the mesh too).  Under ``krylov_op="jvp"`` the Krylov operator is
``fused_jvp`` on the extended block, the direction exchanged once a
product.  Every preconditioner and every option runs decomposed
(``precond/cpr.py:make_preconditioner``'s decomposed closures).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from thermalporous_torch._device import require_cuda
from thermalporous_torch.core.stencil import BlockStencil, ScalarStencil
from thermalporous_torch.kernels.residual import fused_jvp, fused_residual
from thermalporous_torch.models.base import ProblemData, ThermalModelBase
from thermalporous_torch.precond.cpr import (
    CPRConfig,
    make_preconditioner,
    resolve_adaptive_coarsening,
)
from thermalporous_torch.solve.newton import NewtonConfig, NewtonStats, newton_solve
from thermalporous_torch.tracing import OFF, host_read, span


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
        if getattr(data, "block", None) is not None:
            return _advance_blocks(model, precond, pc_cfg, newton_cfg, chop, u_old, dt, data,
                                   u_guess)
        jvp_at = lambda u: (lambda v: fused_jvp(model, u, v, u_old, dt, data))
        return newton_solve(
            residual=lambda u: fused_residual(model, u, u_old, dt, data),
            jvp_at=jvp_at,
            # on the card by coloured probing through J(u)·v
            assemble=lambda u: model.assemble_stencil(u, u_old, dt, data, jvp=jvp_at(u)),
            pc_setup=pc_setup,
            pc_apply=pc_apply,
            u0=u_old if u_guess is None else u_guess,
            cfg=newton_cfg,
            scale=model.residual_scales(u_old, dt, data),
            norm_from=None if u_guess is None else u_old,
            chop=chop,
        )

    return advance


def _advance_blocks(model, precond, pc_cfg, newton_cfg, chop, u_old, dt, data, u_guess):
    """One step over a grid decomposition (see the module's docstring):
    ``u_old``, ``u_guess`` and the result are extended blocks, Newton's
    iterates owned blocks."""
    from thermalporous_torch.dist.halo import HaloStencil
    from thermalporous_torch.dist.sharding import block_model

    blk = data.block
    model = block_model(model, blk)
    pc_setup, pc_apply = make_preconditioner(precond, pc_cfg, block=blk)
    last = {}

    def ext(u):
        # the extended iterate, exchanged once: the residual of an accepted
        # line-search trial and the next assembly share it
        if last.get("u") is not u:
            last.update(u=u, ext=blk.extend(u, lead=1))
        return last["ext"]

    u_own = blk.owned(u_old, lead=1)
    u, stats = newton_solve(
        residual=lambda u: blk.owned(fused_residual(model, ext(u), u_old, dt, data), lead=1),
        # J(u)·v on the extended block, v exchanged once a product
        jvp_at=lambda u: (lambda v: blk.owned(
            fused_jvp(model, ext(u), blk.extend(v, lead=1), u_old, dt, data), lead=1)),
        assemble=lambda u: HaloStencil(model.assemble_stencil(
            ext(u), u_old, dt, data,
            jvp=lambda v: fused_jvp(model, ext(u), v, u_old, dt, data)), blk),
        pc_setup=lambda op: pc_setup(op.st),
        pc_apply=pc_apply,
        u0=u_own if u_guess is None else blk.owned(u_guess, lead=1),
        cfg=newton_cfg,
        scale=blk.owned(model.residual_scales(u_old, dt, data), lead=1),
        norm_from=None if u_guess is None else u_own,
        chop=chop,
        mesh=blk.mesh,
    )
    return ext(u), stats


@dataclasses.dataclass
class BlockStats:
    """Per-step telemetry of one block, CPU tensors of length ``n_steps``
    (entries after the last active step are zero): the reference's
    ``BlockStats``."""

    newton: torch.Tensor   # (n,) int32
    ksp: torch.Tensor      # (n,) int32
    retries: torch.Tensor  # (n,) int32
    dt_used: torch.Tensor  # (n,) f64, accepted Δt per step
    ok: torch.Tensor       # (n,) bool, step accepted
    norm0: torch.Tensor    # (n,) f64, initial residual norm
    norm: torch.Tensor     # (n,) f64, final residual norm
    # (n, nc) f64: the implicit-Euler source integral Δtₙ·Q(uₙ) of each
    # accepted step, so that the balance audit closes without the
    # intermediate states
    src_dt: torch.Tensor


def make_block_step_fn(
    model: ThermalModelBase,
    precond: str = "cptr",
    newton_cfg: NewtonConfig = NewtonConfig(),
    pc_cfg: CPRConfig | None = None,
    time_cfg: "TimeConfig" = None,
    n_steps: int = 8,
    device: torch.device | str = "cuda",
):
    """``n_steps`` adaptive steps per call, with the Δt controller's
    grow/cutback/retry logic: the semantics of the reference's jitted block.

    Returns ``block(u, dt, t, t_end, data, dt_cap=inf) -> (u, dt, t, dead,
    dt_cap, BlockStats)``, the clock and the caps Python floats.  Per step:
    the first attempt runs at ``min(dt, dt_max, max(t_end − t, 1e-30))``
    with no ``dt_min`` floor (the final partial step may be shorter), a
    retry at ``max(dt·cutback, dt_min)`` while retries remain and the last
    failed attempt was above ``dt_min``; every failed attempt lowers the
    failure-memory cap (``fail_frac``), every accepted step relaxes it; the
    next Δt grows or shrinks by the step's Newton count.  A step that
    exhausts its retries marks the block dead (later steps do nothing; the
    caller raises), and steps at ``t_end`` do nothing.  No predictor.  The
    Newton solve already syncs with the host every iteration, so the block
    is a host loop: the source integrals stay on the device until the
    block's one transfer.
    """
    tc = time_cfg if time_cfg is not None else TimeConfig()
    advance = make_step_fn(model, precond, newton_cfg, pc_cfg, device=device)

    def block(u, dt, t, t_end, data, dt_cap=float("inf")):
        dt, t, t_end, cap = float(dt), float(t), float(t_end), float(dt_cap)
        dead = False
        zero = torch.zeros(model.nc, dtype=torch.float64, device=u.device)
        rows, src = [], []
        for _ in range(n_steps):
            inactive = dead or t >= t_end - 1e-12 * max(t_end, 1.0)
            dt_eff0 = min(min(dt, tc.dt_max), max(t_end - t, 1e-30))
            a, dt_try, ok, st, u_new = 0, dt_eff0, False, None, u
            with (OFF if inactive else span("step")) as sp:
                while (not (ok or inactive) and a <= tc.max_retries
                       and not (a > 0 and dt_try <= tc.dt_min)):
                    dt_try = dt_eff0 if a == 0 else max(dt_try * tc.cutback, tc.dt_min)
                    with span("attempt").set("dt", dt_try) as at:
                        u_new, st = advance(u, dt_try, data)
                        at.set("failed", st.failed)
                    if tc.fail_frac is not None and st.failed:
                        cap = min(cap, dt_try * tc.fail_frac)
                    a += 1
                    ok = not st.failed
                sp.set("retries", max(a - 1, 0))
            if ok:
                q = model.source_totals(u_new, data).to(torch.float64)
                src.append(torch.where(torch.isfinite(q), q, 0.0) * dt_try)
                u = u_new
                t = t + dt_try
                grow_lim = min(dt_try * tc.growth, tc.dt_max)
                if tc.fail_frac is not None:
                    cap = cap * tc.fail_relax
                    grow_lim = max(min(grow_lim, cap), tc.dt_min)
                if st.iters < tc.grow_below:
                    dt = grow_lim
                elif st.iters > tc.shrink_above:
                    dt = max(dt_try * tc.cutback, tc.dt_min)
                else:
                    dt = dt_try
            else:
                src.append(zero)
                dead = dead or not inactive
            rows.append((st.iters if ok else 0, st.ksp_iters if ok else 0, max(a - 1, 0),
                         dt_try if ok else 0.0, ok, 0.0 if st is None else st.norm0,
                         0.0 if st is None else st.norm))
        newton, ksp, retries, dt_used, ok_s, norm0, norm = zip(*rows)
        i32 = lambda v: torch.tensor(v, dtype=torch.int32)
        f64 = lambda v: torch.tensor(v, dtype=torch.float64)
        stats = BlockStats(newton=i32(newton), ksp=i32(ksp), retries=i32(retries),
                           dt_used=f64(dt_used), ok=torch.tensor(ok_s, dtype=torch.bool),
                           norm0=f64(norm0), norm=f64(norm),
                           src_dt=host_read(torch.stack(src)))
        return u, dt, t, dead, cap, stats

    return block


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
    # > 1: advance this many controller steps per block (make_block_step_fn);
    # callbacks then fire per block, per-step walls are the block's average,
    # and the predictor is not applied
    block_steps: int = 1

    def __post_init__(self):
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
        with span("setup.simulator"):
            self.device = require_cuda(device)
            self.model = model
            self.data = data
            self.newton_cfg = newton_cfg
            self.time_cfg = time_cfg
            blk = getattr(data, "block", None)
            if blk is not None:
                from thermalporous_torch.dist.sharding import block_model

                self.model = model = block_model(model, blk)
            if pc_cfg is not None and (
                pc_cfg.gmg.coarsen == "adaptive"
                or (pc_cfg.gmg_t is not None and pc_cfg.gmg_t.coarsen == "adaptive")
            ):
                # bake the matrix-dependent coarsening schedule once, from the
                # initial state's Jacobian at dt_init (decomposed: the owned
                # rows, each decoupled block gathered whole on every rank)
                with span("setup.coarsening_bake"):
                    u0 = model.initial_state(data)
                    dt0 = float(time_cfg.dt_init)
                    st = model.assemble_stencil(
                        u0, u0, dt0, data,
                        jvp=lambda v: fused_jvp(model, u0, v, u0, dt0, data))
                    gather = None
                    if blk is not None:
                        st = BlockStencil(blk.owned(st.coef, lead=3))
                        gather = lambda s: ScalarStencil(blk.gather(s.packed, lead=1))
                    pc_cfg = resolve_adaptive_coarsening(st, pc_cfg, gather=gather)
            self.pc_cfg = pc_cfg
            self._precond_name = precond
            self._advance = make_step_fn(model, precond, newton_cfg, pc_cfg,
                                         device=self.device)
            self._block = None

    def step(self, u_old: torch.Tensor, dt: float,
             u_guess: torch.Tensor | None = None) -> tuple[torch.Tensor, NewtonStats]:
        """One Newton solve (no Δt adaptivity); ``u_guess`` moves only the
        start point."""
        with span("attempt").set("dt", dt) as sp:
            u, stats = self._advance(u_old, dt, self.data, u_guess)
            sp.set("failed", stats.failed)
        return u, stats

    def _run_blocked(self, t_end, u, dt, t, step0, max_steps, callback, verbose,
                     dt_cap0=None) -> SimResult:
        """``time_cfg.block_steps`` controller steps per block (see
        :func:`make_block_step_fn`), with the reference's records: ``t``
        walked back from the block-final clock, every record's ``next_dt``
        the block-final Δt, ``dt_cap`` on the last record only, every record
        but the last not state-consistent, each wall the block's average, and
        every callback given the block-final ``u``."""
        tc = self.time_cfg
        if self._block is None:
            self._block = make_block_step_fn(
                self.model, self._precond_name, self.newton_cfg, self.pc_cfg, tc,
                n_steps=tc.block_steps, device=self.device)
        records: list[StepRecord] = []
        run_start = time.perf_counter()
        step_idx = step0
        dt_cap = float("inf") if dt_cap0 is None else float(dt_cap0)

        while t < t_end - 1e-12 * max(t_end, 1.0) and step_idx < max_steps:
            blk_start = time.perf_counter()
            u, dt, t, dead, dt_cap, stats = self._block(u, dt, t, t_end, self.data, dt_cap)
            blk_wall = time.perf_counter() - blk_start
            n_ok = int(stats.ok.sum())
            if n_ok:
                per_step_wall = blk_wall / n_ok
                for i in range(tc.block_steps):
                    if not bool(stats.ok[i]):
                        continue
                    step_idx += 1
                    records.append(StepRecord(
                        step=step_idx,
                        t=float("nan"),  # walked back below
                        dt=float(stats.dt_used[i]),
                        newton_iters=int(stats.newton[i]),
                        ksp_iters=int(stats.ksp[i]),
                        retries=int(stats.retries[i]),
                        residual_norm0=float(stats.norm0[i]),
                        residual_norm=float(stats.norm[i]),
                        wall_s=per_step_wall,
                        src_dt=tuple(float(x) for x in stats.src_dt[i]),
                    ))
                acc = t
                for rec in reversed(records[-n_ok:]):
                    rec.t = acc
                    rec.next_dt = dt
                    acc -= rec.dt
                # the block-final cap pairs with the block-final record, the
                # only state-consistent (checkpointable) one
                records[-1].dt_cap = dt_cap if dt_cap != float("inf") else None
                if verbose:
                    last = records[-1]
                    print(f"block -> step {step_idx:4d}  t={t:.4e}  dt={last.dt:.3e}  "
                          f"newton={last.newton_iters}  ksp={last.ksp_iters}")
                for rec in records[-n_ok:-1]:
                    rec.state_consistent = False
                if callback is not None:
                    for rec in records[-n_ok:]:
                        callback(rec.step, rec.t, u, rec)
            if dead:
                raise RuntimeError(
                    f"blocked run: Newton failed and retries were exhausted near "
                    f"t={t:.4e} (dt={dt:.3e})")
            if n_ok == 0:
                break  # t_end reached inside the block

        return SimResult(
            u=u, t=t, steps=len(records), records=records,
            total_newton=sum(r.newton_iters for r in records),
            total_ksp=sum(r.ksp_iters for r in records),
            wall_s=time.perf_counter() - run_start,
        )

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
        """Advance from (t0, u0) to t_end (or to step index ``max_steps``);
        ``t0``, ``step0``, ``dt0`` and ``dt_cap0`` resume a checkpoint
        exactly."""
        with span("episode"):
            tc = self.time_cfg
            u = self.model.initial_state(self.data) if u0 is None else u0
            t = t0
            dt = tc.dt_init if dt0 is None else dt0
            if tc.block_steps > 1:
                return self._run_blocked(t_end, u, dt, t, step0, max_steps, callback,
                                         verbose, dt_cap0=dt_cap0)
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
                with span("step") as sp:
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
                    sp.set("retries", retries)

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

    def run_schedule(
        self,
        schedule,
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
        """Advance to ``t_end`` under piecewise-constant well and heater
        controls.

        ``schedule`` is a sequence of ``(t_start, WellFields)`` (build each
        with ``physics.wells.build_well_fields``; the first ``t_start`` must
        be ≤ ``t0``): segment *i*'s controls apply on ``[t_i, t_{i+1})``.
        A step lands exactly on every boundary (the ``t_end`` clamp of
        :meth:`run`), the controller's Δt and failure-memory cap thread
        across boundaries as in an exact resume, and ``max_steps`` is an
        absolute step-index cap.  Each segment runs on
        ``ProblemData.with_wells`` of the data in force (``self.data`` is
        rebound; no tensor of the case is written), and a callback with a
        ``set_data(data)`` method (``BalanceAuditor``) is rebound per
        segment.
        """
        segs = sorted(schedule, key=lambda s: s[0])
        if not segs or segs[0][0] > t0:
            raise ValueError(
                f"schedule must start at/before t0={t0} (first segment at "
                f"{segs[0][0] if segs else 'none'})")
        u = self.model.initial_state(self.data) if u0 is None else u0
        t, step, dt = t0, step0, (self.time_cfg.dt_init if dt0 is None else dt0)
        dt_cap = dt_cap0
        records: list[StepRecord] = []
        run_start = time.perf_counter()

        for i, (_, wf) in enumerate(segs):
            te = min(segs[i + 1][0] if i + 1 < len(segs) else t_end, t_end)
            if te <= t or step >= max_steps:
                continue  # a segment wholly before the window (resume)
            self.data = self.data.with_wells(wf)
            if callback is not None and hasattr(callback, "set_data"):
                callback.set_data(self.data)
            res = self.run(t_end=te, u0=u, dt0=dt, t0=t, step0=step, max_steps=max_steps,
                           callback=callback, verbose=verbose, dt_cap0=dt_cap)
            records.extend(res.records)
            u, t, step = res.u, res.t, step + res.steps
            if res.records:
                dt = res.records[-1].next_dt or dt
                dt_cap = res.records[-1].dt_cap
            if t >= t_end - 1e-12 * max(t_end, 1.0):
                break

        return SimResult(
            u=u, t=t, steps=len(records), records=records,
            total_newton=sum(r.newton_iters for r in records),
            total_ksp=sum(r.ksp_iters for r in records),
            wall_s=time.perf_counter() - run_start,
        )
