"""Discrete adjoint of the implicit time stepper: exact gradients of
trajectory functionals with respect to the problem's arrays (counterpart of
``thermalporous_tpu/solve/adjoint.py``).

With j = terminal(u_N, data) + Σ_k running(u_k, dt_k, data) over a recorded
backward-Euler trajectory F_k(u_k, u_{k−1}, dt_k, θ) = 0:

    (∂F_N/∂u_N)ᵀ μ_N = (∂j/∂u_N)ᵀ
    λ_{k−1} = (∂j/∂u_{k−1})ᵀ − (∂F_k/∂u_{k−1})ᵀ μ_k,   (∂F_k/∂u_k)ᵀ μ_k = λ_k
    dJ/dθ = ∂j/∂θ − Σ_k (∂F_k/∂θ)ᵀ μ_k,   dJ/du₀ = λ₀

Each backward step is one linear solve with the transposed Jacobian.  The
Krylov operator is exact and matrix-free: ``torch.func.vjp`` of the model's
plain residual (``ThermalModelBase.residual``, the function the reference
differentiates) in the ``u_new`` slot.  The ``fused_residual`` kernel is the
forward path's and is not differentiated.  The preconditioner is the
CPR/CPTR stack set up on ``BlockStencil.transpose()`` of the assembled
Jacobian, so on the card its stencil kernels run on the transposed
hierarchy.  The cotangents with respect to ``ProblemData`` come back as a
``ProblemData`` of the same packed layout (``tgeo``, ``tcond``, ``phi`` and
the well fields as its views): the VJP takes the one ``fields`` tensor as
its primal, nothing detached.

The ensemble forms (:func:`ensemble_adjoint_gradients`,
:func:`record_ensemble_trajectory`) run the same sweep member by member over
the stacked members of ``solve/ensemble_data.py``, and report the reference's
lockstep FGMRES count: in each backward step the batched solve of the
reference iterates until its slowest member has converged.

Over a grid decomposition the sweep runs on each rank's owned block: the
transposed product is the VJP of the residual on the extended block (the
decomposed step's), of its owned rows, folded back onto the owned cells
(``Block.fold``: a ghost's cotangent belongs to its owner, so a face that
two ranks both evaluate is counted once, in the row that owns it); the
preconditioner is the decomposed one of its name (``make_preconditioner``'s
decomposed closures) on ``HaloStencil.transpose()``;
FGMRES reduces through the mesh; the objectives see the gathered whole
state and data.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
from torch.func import vjp

from thermalporous_torch.kernels.residual import fused_jvp
from thermalporous_torch.models.base import ProblemData
from thermalporous_torch.precond.cpr import CPRConfig, make_preconditioner
from thermalporous_torch.solve.deflate import empty_recycle, fgmres_dr
from thermalporous_torch.solve.ensemble_data import (
    EnsembleData,
    members,
    refuse_adaptive,
    restack,
)
from thermalporous_torch.solve.fgmres import fgmres


@dataclasses.dataclass
class AdjointResult:
    value: torch.Tensor         # J on the trajectory (0-dim)
    grad_data: ProblemData      # dJ/d(data), the ProblemData layout
    grad_u0: torch.Tensor       # dJ/du₀ (state-shaped)
    ksp_iters: int              # FGMRES iterations over the sweep
    converged: bool             # every adjoint solve met its tolerance
    step_iters: list = dataclasses.field(default_factory=list)  # per backward step, newest first


def _objective_vjp(fn, u: torch.Tensor, fields: torch.Tensor):
    """(value, ∂/∂u, ∂/∂fields) of a scalar ``fn(u, fields)``."""
    val, pull = vjp(fn, u, fields)
    du, dfields = pull(torch.ones_like(val))
    return val, du, dfields


class _Whole:
    """The undecomposed sweep's layout: every tensor whole."""

    mesh = None

    def __init__(self, model, data, precond, pc_cfg):
        self.model = model
        self.setup, self.apply = make_preconditioner(precond, pc_cfg)

    def whole(self, t: torch.Tensor) -> torch.Tensor:
        return t

    cut = owned = pad = fold = extend = whole

    def preconditioner(self, st):
        return self.setup(st.transpose())

    def grad_data(self, data, grad: torch.Tensor) -> ProblemData:
        return ProblemData(grad)


class _Decomposed(_Whole):
    """The sweep over a grid decomposition: states and data are the rank's
    extended blocks, the sweep's vectors its owned blocks.  The transposed
    product is the VJP of the residual on the extended block, of the
    owned rows (the cotangent padded with a zero ring), folded back onto
    the owned cells (:meth:`Block.fold`, the adjoint of the exchange);
    the named preconditioner is the decomposed one on
    :meth:`HaloStencil.transpose`; the objectives see the gathered whole
    state and data, and each rank keeps its owned part of their
    cotangents."""

    def __init__(self, model, data, precond, pc_cfg):
        from thermalporous_torch.dist.sharding import block_model

        self.blk = data.block
        self.mesh = self.blk.mesh
        self.model = block_model(model, self.blk)
        self.setup, self.apply = make_preconditioner(precond, pc_cfg, block=self.blk)

    def owned(self, t: torch.Tensor) -> torch.Tensor:
        """The owned block of an extended-block tensor."""
        return self.blk.owned(t, lead=1)

    def whole(self, t: torch.Tensor) -> torch.Tensor:
        return self.blk.gather(self.owned(t), lead=1)

    def cut(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's owned block of a whole tensor."""
        return self.blk.cut(t, lead=1, ghosts=False)

    def pad(self, t: torch.Tensor) -> torch.Tensor:
        return self.blk.pad(t, lead=1)

    def fold(self, t: torch.Tensor) -> torch.Tensor:
        return self.blk.fold(t, lead=1)

    def extend(self, t: torch.Tensor) -> torch.Tensor:
        return self.blk.extend(t, lead=1)

    def preconditioner(self, st):
        from thermalporous_torch.dist.halo import HaloStencil

        return self.setup(HaloStencil(st, self.blk).transpose().st)

    def grad_data(self, data, grad: torch.Tensor) -> ProblemData:
        from thermalporous_torch.dist.sharding import ShardedProblemData

        return ShardedProblemData(self.blk.extend(grad, lead=1), self.blk)


def adjoint_gradients(
    model,
    data: ProblemData,
    states: Sequence[torch.Tensor],
    dts: Sequence[float],
    terminal: Callable | None = None,
    running: Callable | None = None,
    precond: str = "cptr",
    pc_cfg: CPRConfig | None = None,
    rtol: float = 1e-10,
    maxiter: int = 200,
    recycle: int = 0,
    orth: str = "cgs2",
) -> AdjointResult:
    """Backward sweep over a recorded trajectory.

    ``states`` are [u_0, …, u_N], the accepted states of a forward run
    (:func:`record_trajectory`), ``dts`` the N accepted step sizes;
    ``terminal(u_N, data)`` and ``running(u_k, dt_k, data)`` (summed over k
    = 1..N) are scalar objectives, at least one of them.  ``precond`` and
    ``pc_cfg`` name the preconditioner, set up on the transposed stencil;
    ``rtol``/``maxiter`` the adjoint FGMRES's; ``recycle`` = k > 0 carries a
    k-column recycle space from each backward solve to the next
    (:func:`~thermalporous_torch.solve.deflate.fgmres_dr`, classic CGS2);
    ``orth`` the Gram–Schmidt form otherwise ("cgs2", "cgs1", "cgs2g",
    "cgs2g2").

    Over a grid decomposition (``data`` and ``states`` the rank's extended
    blocks, as the decomposed step gives them) the objectives still see
    the whole state and ``ProblemData`` (gathered: every rank must call);
    ``grad_data`` and ``grad_u0`` come back in the layout of ``data`` and
    ``states[0]``, and gathered they are the undecomposed sweep's; every
    rank holds the same value and counts (the ``_Decomposed`` layout)."""
    if terminal is None and running is None:
        raise ValueError("need at least one of terminal/running objective")
    n = len(dts)
    if len(states) != n + 1:
        raise ValueError(f"states ({len(states)}) must be dts+1 ({n + 1})")
    lay = (_Whole if getattr(data, "block", None) is None else _Decomposed)(
        model, data, precond, pc_cfg)
    fields = data.fields
    whole_fields = lay.whole(fields)

    def objective(fn, u):
        val, du, dfields = _objective_vjp(fn, lay.whole(u), whole_fields)
        return val, lay.cut(du), lay.cut(dfields)

    u_n = states[n]
    if terminal is None:
        value = torch.zeros((), dtype=u_n.dtype, device=fields.device)
        lam, grad = torch.zeros_like(lay.owned(u_n)), torch.zeros_like(lay.owned(fields))
    else:
        value, lam, grad = objective(lambda u, f: terminal(u, ProblemData(f)), u_n)
    if recycle > 0:
        U, u_mask = empty_recycle(lam.shape, recycle, u_n.dtype, fields.device)
    total, all_conv, step_iters = 0, True, []
    for k in range(n, 0, -1):
        dt_k = float(dts[k - 1])
        if running is not None:
            rval, rlam, rgrad = objective(lambda u, f: running(u, dt_k, ProblemData(f)),
                                          states[k])
            value = value + rval
            lam = lam + rlam
            grad = grad + rgrad
        u_k, u_km1 = states[k], states[k - 1]
        pcs = lay.preconditioner(lay.model.assemble_stencil(
            u_k, u_km1, dt_k, data,
            jvp=lambda v: fused_jvp(lay.model, u_k, v, u_km1, dt_k, data)))
        _, pull = vjp(lambda un, uo, f: lay.model.residual(un, uo, dt_k, ProblemData(f)),
                      states[k], states[k - 1], fields)
        matvec_t = lambda v: lay.fold(pull(lay.pad(v))[0])
        precond_t = lambda r: lay.apply(pcs, r)
        if recycle > 0:
            res, U, u_mask = fgmres_dr(matvec_t, lam, precond=precond_t, U=U, u_mask=u_mask,
                                       rtol=rtol, maxiter=maxiter, mesh=lay.mesh)
        else:
            res = fgmres(matvec_t, lam, precond=precond_t, rtol=rtol, maxiter=maxiter,
                         orth_passes=1 if orth == "cgs1" else 2,
                         orth_gram={"cgs2g": 3, "cgs2g2": 2}.get(orth, 0), mesh=lay.mesh)
        _, w_old, w_fields = pull(lay.pad(res.x))
        grad = grad + (-lay.fold(w_fields))
        lam = -lay.fold(w_old)
        total += res.iters
        all_conv = all_conv and res.converged
        step_iters.append(res.iters)
    return AdjointResult(value=value, grad_data=lay.grad_data(data, grad),
                         grad_u0=lay.extend(lam), ksp_iters=total, converged=all_conv,
                         step_iters=step_iters)


def ensemble_adjoint_gradients(
    model,
    data_e,
    states_e: Sequence,
    dts: Sequence[float],
    terminal: Callable | None = None,
    running: Callable | None = None,
    precond: str = "cptr",
    pc_cfg: CPRConfig | None = None,
    rtol: float = 1e-10,
    maxiter: int = 200,
) -> AdjointResult:
    """The backward sweep of E members at once: the ensemble form of
    :func:`adjoint_gradients` (plain FGMRES with its defaults).

    ``data_e`` is an :class:`~thermalporous_torch.solve.ensemble_data.EnsembleData`,
    ``states_e`` the recorded [u_0, …, u_N], each (E, nc, *grid) (or its
    ``Blocks``; :func:`record_ensemble_trajectory`), ``dts`` the N step sizes
    shared by the members; ``terminal`` and ``running`` see one member's state
    and ``ProblemData``.  Each member's sweep is its solo sweep (decomposed
    members, ``data_e.block`` set: its decomposed sweep, every rank in
    step).  The result
    carries the member axis: ``value`` (E,), ``grad_u0`` in the layout of
    ``states_e[0]``, ``grad_data`` an ``EnsembleData``; ``step_iters`` holds
    the largest member count of each backward step (newest first) and
    ``ksp_iters`` their sum, the reference's lockstep count; ``converged``
    holds when every member's every solve converged.  An adaptive coarsening
    schedule must be planned first, as for ``make_ensemble_step_fn``."""
    if terminal is None and running is None:
        raise ValueError("need at least one of terminal/running objective")
    refuse_adaptive(pc_cfg, "adjoints")
    n = len(dts)
    if len(states_e) != n + 1:
        raise ValueError(f"states ({len(states_e)}) must be dts+1 ({n + 1})")
    per_step = [members(s) for s in states_e]
    results = [
        adjoint_gradients(model, data_e.member(i), [s[i].clone() for s in per_step], dts,
                          terminal=terminal, running=running, precond=precond,
                          pc_cfg=pc_cfg, rtol=rtol, maxiter=maxiter)
        for i in range(len(data_e))]
    step_iters = [max(r.step_iters[s] for r in results) for s in range(n)]
    return AdjointResult(
        value=torch.stack([r.value.to(results[0].value.device) for r in results]),
        grad_data=EnsembleData(restack(data_e.fields, [r.grad_data.fields for r in results]),
                               data_e.block),
        grad_u0=restack(states_e[0], [r.grad_u0 for r in results]),
        ksp_iters=sum(step_iters), converged=all(r.converged for r in results),
        step_iters=step_iters)


def record_ensemble_trajectory(step_e, u0_e, dts: Sequence[float], data_e) -> list:
    """[u_0, …, u_N] of an ensemble over a fixed Δt schedule shared by the
    members: ``step_e`` from
    :func:`~thermalporous_torch.dist.ensemble.make_ensemble_step_fn`, Δt in the
    state's dtype.  Raises ``RuntimeError`` naming the members that did not
    converge."""
    dtype = members(u0_e)[0].dtype
    states = [u0_e]
    for dt in dts:
        dt_e = torch.full((len(data_e),), float(dt), dtype=dtype)
        u, stats = step_e(states[-1], dt_e, data_e)
        if not bool(stats.converged.all()):
            raise RuntimeError(
                f"ensemble forward step dt={dt}: members "
                f"{[int(i) for i in torch.nonzero(~stats.converged).flatten()]} "
                f"did not converge")
        states.append(u)
    return states


def record_trajectory(sim, u0: torch.Tensor, dts: Sequence[float]) -> list[torch.Tensor]:
    """[u_0, …, u_N]: ``sim.step`` over the given Δt sequence with no
    controller (the adjoint needs the exact accepted schedule; take it from
    a controller run's records when Δt was adaptive).  Raises
    ``RuntimeError`` when a step does not converge."""
    states = [u0]
    for dt in dts:
        u, stats = sim.step(states[-1], float(dt))
        if not stats.converged:
            raise RuntimeError(f"forward step dt={dt} did not converge")
        states.append(u)
    return states
