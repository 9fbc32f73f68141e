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
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
from torch.func import vjp

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
    "cgs2g2")."""
    from thermalporous_torch.dist.sharding import refuse_decomposed

    refuse_decomposed(data, "adjoint_gradients")
    if terminal is None and running is None:
        raise ValueError("need at least one of terminal/running objective")
    n = len(dts)
    if len(states) != n + 1:
        raise ValueError(f"states ({len(states)}) must be dts+1 ({n + 1})")
    setup, apply = make_preconditioner(precond, pc_cfg)
    fields = data.fields
    u_n = states[n]
    if terminal is None:
        value = torch.zeros((), dtype=u_n.dtype, device=fields.device)
        lam, grad = torch.zeros_like(u_n), torch.zeros_like(fields)
    else:
        value, lam, grad = _objective_vjp(lambda u, f: terminal(u, ProblemData(f)), u_n,
                                          fields)
    if recycle > 0:
        U, u_mask = empty_recycle(u_n.shape, recycle, u_n.dtype, fields.device)
    total, all_conv, step_iters = 0, True, []
    for k in range(n, 0, -1):
        dt_k = float(dts[k - 1])
        if running is not None:
            rval, rlam, rgrad = _objective_vjp(
                lambda u, f: running(u, dt_k, ProblemData(f)), states[k], fields)
            value = value + rval
            lam = lam + rlam
            grad = grad + rgrad
        st = model.assemble_stencil(states[k], states[k - 1], dt_k, data)
        pcs = setup(st.transpose())
        _, pull = vjp(lambda un, uo, f: model.residual(un, uo, dt_k, ProblemData(f)),
                      states[k], states[k - 1], fields)
        matvec_t = lambda v: pull(v)[0]
        if recycle > 0:
            res, U, u_mask = fgmres_dr(matvec_t, lam, precond=lambda r: apply(pcs, r), U=U,
                                       u_mask=u_mask, rtol=rtol, maxiter=maxiter)
        else:
            res = fgmres(matvec_t, lam, precond=lambda r: apply(pcs, r), rtol=rtol,
                         maxiter=maxiter, orth_passes=1 if orth == "cgs1" else 2,
                         orth_gram={"cgs2g": 3, "cgs2g2": 2}.get(orth, 0))
        _, w_old, w_fields = pull(res.x)
        grad = grad + (-w_fields)
        lam = -w_old
        total += res.iters
        all_conv = all_conv and res.converged
        step_iters.append(res.iters)
    return AdjointResult(value=value, grad_data=ProblemData(grad), grad_u0=lam,
                         ksp_iters=total, converged=all_conv, step_iters=step_iters)


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
    and ``ProblemData``.  Each member's sweep is its solo sweep.  The result
    carries the member axis: ``value`` (E,), ``grad_u0`` in the layout of
    ``states_e[0]``, ``grad_data`` an ``EnsembleData``; ``step_iters`` holds
    the largest member count of each backward step (newest first) and
    ``ksp_iters`` their sum, the reference's lockstep count; ``converged``
    holds when every member's every solve converged.  An adaptive coarsening
    schedule must be planned first, as for ``make_ensemble_step_fn``."""
    from thermalporous_torch.dist.sharding import refuse_decomposed

    refuse_decomposed(data_e, "ensemble_adjoint_gradients")
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
        grad_data=EnsembleData(restack(data_e.fields, [r.grad_data.fields for r in results])),
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
