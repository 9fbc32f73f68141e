"""Rank functions of the grid-decomposition tests (not collected).

Spawned ranks import this module by name, so it imports the port only:
the JAX references are computed in the test process and handed over as
arrays.  Each function runs on one rank of a
:class:`~thermalporous_torch.dist.sharding.GridMesh` and asserts on its
own block, or returns what the test compares across ranks.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from thermalporous_torch.dist.halo import make_halo_residual
from thermalporous_torch.dist.sharding import (
    Block,
    block_model,
    gather_state,
    replicated,
    shard_problem_data,
    shard_state,
)
from thermalporous_torch.kernels import stencil as kst
from thermalporous_torch.physics.wells import well_rates
from thermalporous_torch.precond.cpr import CPRConfig, cpr_apply, cpr_setup
from thermalporous_torch.precond.gmg import GMGConfig
from thermalporous_torch.solve.timeloop import Simulator
from thermalporous_torch.utils import all_finite


def _close(got: torch.Tensor, ref: torch.Tensor, scale: float) -> None:
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12 * scale)


def halo_rank(mesh, cases) -> None:
    """The explicit halo residual and the residual of the extended block
    against the reference's whole residual, on this rank's owned cells."""
    for model, data, u, u_old, dt, ref in cases:
        data_s = shard_problem_data(data, mesh)
        blk = data_s.block
        u_s, uo_s = shard_state(u, mesh), shard_state(u_old, mesh)
        ref = torch.as_tensor(ref)
        scale = float(ref.abs().max())
        want = blk.cut(ref, lead=1, ghosts=False)
        halo = make_halo_residual(model, mesh, data_s)(u_s, uo_s, dt, data_s)
        _close(halo, want, scale)
        res = block_model(model, blk).residual(u_s, uo_s, dt, data_s)
        _close(blk.owned(res, lead=1), want, scale)


#: the kernels' block test: a 3D grid cut at odd boundaries, so that two
#: of the four extended blocks have an origin of odd index sum
KERNEL_SHAPE = (15, 21, 5)
KERNEL_BOUNDS = ((0, 7, 15), (0, 10, 21))
KERNEL_DEGREE = 3


def kernels_rank(mesh, g: dict) -> int:
    """B1, B2, B3 (both second outputs), B5 and the half-sweep on this
    rank's block, its vectors extended by exchange, against the plain
    versions on the whole grid: bitwise on the owned cells.  Returns the
    stage-2 block's parity."""
    g = {k: torch.as_tensor(v) for k, v in g.items()}
    blk = lambda w: Block(mesh, KERNEL_SHAPE, KERNEL_BOUNDS, w)

    def on_block(w, whole_out, fn, vecs, coefs, lead=1):
        b = blk(w)
        ext = [b.extend(b.cut(v, lead=lead, ghosts=False), lead=lead) for v in vecs]
        outs = fn(*[b.cut(c, lead=c.dim() - len(KERNEL_SHAPE)) for c in coefs], *ext)
        outs = outs if isinstance(outs, tuple) else (outs,)
        whole_out = whole_out if isinstance(whole_out, tuple) else (whole_out,)
        for got, ref in zip(outs, whole_out):
            assert torch.equal(b.owned(got, lead=got.dim() - len(KERNEL_SHAPE)),
                               b.cut(ref, lead=ref.dim() - len(KERNEL_SHAPE), ghosts=False))

    coef, v, x1, packed, b, x, r = (g[k] for k in ("coef", "v", "x1", "packed", "b", "x", "r"))
    on_block(1, kst.block_matvec_plain(coef, v), lambda c, vv: kst.block_matvec(c, vv, 3),
             [v], [coef])
    on_block(1, kst.block_matvec_plain(coef, x1), lambda c, vv: kst.block_matvec(c, vv, 2),
             [x1], [coef])
    on_block(1, kst.matvec_plain(packed, b), kst.matvec, [b], [packed], lead=0)
    lam = g["lam"]
    for second in ("residual", "product"):
        ref = kst.chebyshev_smooth_plain(packed, b, x, lam, KERNEL_DEGREE, 0.3, second=second)
        on_block(KERNEL_DEGREE + 1, ref,
                 lambda c, bb, xx: kst.chebyshev_smooth(c, bb, xx, lam, KERNEL_DEGREE, 0.3,
                                                        second=second),
                 [b, x], [packed], lead=0)
    ref = kst.chebyshev_smooth_plain(packed, b, None, lam, KERNEL_DEGREE, 0.3)
    on_block(KERNEL_DEGREE, ref,
             lambda c, bb: kst.chebyshev_smooth(c, bb, None, lam, KERNEL_DEGREE, 0.3),
             [b], [packed], lead=0)
    dinv = g["dinv"]
    b2 = blk(2)
    ref = kst.fused_stage2_rbgs_plain(coef, dinv, r, x1)
    on_block(2, ref, lambda c, d, rr, xx: kst.fused_stage2_rbgs(c, d, rr, xx,
                                                               parity=b2.parity),
             [r, x1], [coef, dinv])
    # the local colouring (no parity) sweeps the colours the wrong way
    # round where the block's origin has an odd index sum (the exchange is
    # collective: every rank takes part)
    ext = [b2.extend(b2.cut(t, ghosts=False)) for t in (r, x1)]
    wrong = kst.fused_stage2_rbgs(b2.cut(coef, lead=3), b2.cut(dinv, lead=2), *ext)
    assert torch.equal(b2.owned(wrong), b2.cut(ref, ghosts=False)) == (b2.parity == 0)
    for colour in (0, 1):
        ref = kst.block_rbgs_half_sweep_plain(coef, dinv, r, v, colour)
        on_block(1, ref, lambda c, d, rr, vv: kst.block_rbgs_half_sweep(
            c, d, rr, vv, colour, parity=blk(1).parity), [r, v], [coef, dinv])
    return b2.parity


def halo_and_kernels_rank(mesh, arrays: dict, cases) -> int:
    """:func:`kernels_rank` then :func:`halo_rank`, in one spawn; and
    ``replicated`` gives every rank rank 0's tensor."""
    parity = kernels_rank(mesh, arrays)
    halo_rank(mesh, cases)
    assert torch.equal(replicated(torch.arange(3.0) + mesh.rank, mesh), torch.arange(3.0))
    return parity


def step_rank(mesh, model, data, newton_cfg, pc_cfg, dt: float, coarsest: bool = False,
              precond: str = "cptr"):
    """One decomposed ``Simulator.step`` from the initial state: (Newton,
    FGMRES, converged, the gathered state, the corner wells' rates[, the
    decomposed level count and the coarsest diagonal of the pressure
    hierarchy, or of the coupled one under ``stage2="bgmg"``])."""
    if callable(pc_cfg):
        pc_cfg = pc_cfg(mesh)
    data_s = shard_problem_data(data, mesh)
    sim = Simulator(model, data_s, precond=precond, pc_cfg=pc_cfg, newton_cfg=newton_cfg,
                    device="cpu")
    u0 = shard_state(model.initial_state(data), mesh)
    u, st = sim.step(u0, dt)
    assert all_finite(u, mesh)
    out = (st.iters, st.ksp_iters, st.converged, gather_state(u, mesh).numpy(),
           well_rates(sim.model, u, data_s, corner_masks(data_s.block.shape)))
    if coarsest:
        blk = data_s.block
        stencil = block_model(model, blk).assemble_stencil(u0, u0, dt, data_s)
        state = cpr_setup(stencil, dataclasses.replace(pc_cfg or CPRConfig(),
                                                       variant="cptr"), block=blk)
        hier = state.bgmg if state.bgmg is not None else state.gmg_p
        out += (len(hier.blocks), hier.stencils[-1].diag.numpy())
    return out


def corner_masks(shape) -> dict:
    """Well masks of the ``_case`` wells, the first and the last cell, and
    of the 3D cases' wells, the columns through the first and the last
    (x, y) corner."""
    first, last = np.zeros(shape, dtype=bool), np.zeros(shape, dtype=bool)
    first[0, 0] = last[shape[0] - 1, shape[1] - 1] = True
    return {"INJ": first, "PROD": last}


def replicated_pc(mesh) -> CPRConfig:
    """The pressure hierarchy of the replicated-coarse-level case."""
    return CPRConfig(gmg=GMGConfig(mesh=mesh, replicate_below=256))


def steps_rank(mesh, jobs) -> list:
    """:func:`step_rank` of each job (its keyword arguments)."""
    return [step_rank(mesh, **job) for job in jobs]


def apply_rank(mesh, model, data, u, dt: float, r, pc_cfg, levels: bool = False):
    """The decomposed CPTR apply of ``pc_cfg`` to the whole residual ``r``
    (this rank's owned block of it), set up from the Jacobian at the state
    ``u`` (the step from ``u``), gathered whole (with ``levels``, also the
    pressure hierarchy's decomposed level count and the classes of its
    decomposed levels' stencils)."""
    data_s = shard_problem_data(data, mesh)
    blk = data_s.block
    u_s = shard_state(torch.as_tensor(u), mesh)
    stencil = block_model(model, blk).assemble_stencil(u_s, u_s, dt, data_s)
    state = cpr_setup(stencil, pc_cfg, block=blk)
    y = cpr_apply(state, blk.cut(torch.as_tensor(r), lead=1, ghosts=False), pc_cfg)
    y = blk.gather(y, lead=1).numpy()
    if not levels:
        return y
    hier = state.gmg_p
    return y, [type(s).__name__ for s in hier.stencils[:len(hier.blocks)]]


def options_rank(mesh, jobs, applies=()) -> dict:
    """:func:`step_rank` of each job with this rank's collective counts of
    its step appended (exchanges, all-reduces, all-gathers), and
    :func:`apply_rank` of each of ``applies`` (its keyword arguments)."""
    steps = []
    for job in jobs:
        mesh.reset_stats()
        got = step_rank(mesh, **job)
        steps.append(got + ((mesh.stats["exchanges"], mesh.stats["allreduces"],
                             mesh.stats["gathers"]),))
    return {"steps": steps, "applies": [apply_rank(mesh, **a) for a in applies]}


# ------------------------------------------------------------------------
# the adjoint, the transfers, krylov_op="jvp" and the ensemble over ranks
# (tests/test_torch_sharding_adjoint.py)

#: the fold check's grid and its splits by label prefix: cut at odd
#: boundaries along both axes, and a thin split whose narrowest ranges are
#: as deep as the deepest ring
FOLD_SHAPE = (13, 11, 3)
FOLD_SPLITS = {"": ((0, 7, 13), (0, 5, 11)), "thin split ": ((0, 3, 13), (0, 8, 11))}


def _sum(mesh, t: torch.Tensor) -> float:
    """The sum of ``t`` over every rank, exact (``math.fsum`` of each
    rank's part, and of the parts, each all-reduced in a slot of its own),
    so that the two sides of an identity differ only by their products'
    rounding."""
    parts = torch.zeros(mesh.size, dtype=torch.float64)
    parts[mesh.rank] = math.fsum(t.double().reshape(-1).tolist())
    return math.fsum(mesh.allreduce_sum(parts).tolist())


def fold_rank(mesh, seed: int) -> dict:
    """The inner-product identities of the exchange and its adjoint,
    summed over the ranks: ⟨extend(x), y⟩ = ⟨x, fold(y)⟩ for rings 1–3
    (one ring per axis too) and with zero to two leading axes, and ``pad``
    the adjoint of ``owned``, on each of :data:`FOLD_SPLITS`.  Returns
    {label: (left, right)}."""
    g = torch.Generator().manual_seed(seed + mesh.rank)
    # normal draws on a 2⁻¹⁰ lattice: every product and sum below is exact
    # in f64, so a misrouted slab shows and rounding does not
    rnd = lambda shape: torch.round(
        torch.randn(shape, generator=g, dtype=torch.float64) * 1024) / 1024
    out = {}
    for split, bounds in FOLD_SPLITS.items():
        for width in (1, 2, 3, (2, 1)):
            for lead in ((), (3,), (2, 3)):
                blk = Block(mesh, FOLD_SHAPE, bounds, width)
                assert blk.fits()
                x = rnd(lead + blk.owned_shape)
                y = rnd(lead + blk.ext_shape)
                n = len(lead)
                out[f"{split}extend width={width} lead={n}"] = (
                    _sum(mesh, blk.extend(x, lead=n) * y), _sum(mesh, x * blk.fold(y, lead=n)))
        blk = Block(mesh, FOLD_SHAPE, bounds, 2)
        x, y = rnd((3,) + blk.owned_shape), rnd((3,) + blk.ext_shape)
        out[f"{split}pad"] = (_sum(mesh, blk.owned(y) * x), _sum(mesh, y * blk.pad(x)))
    return out


def transpose_rank(mesh, model, data, u, dt: float) -> float:
    """``HaloStencil.transpose()`` of the decomposed Jacobian at ``u``
    against the whole Jacobian's ``BlockStencil.transpose()`` cut to the
    extended block: the largest gap over every held row, relative to the
    largest coefficient."""
    from thermalporous_torch.dist.halo import HaloStencil

    data_s = shard_problem_data(data, mesh)
    blk = data_s.block
    u_s = shard_state(u, mesh)
    st = block_model(model, blk).assemble_stencil(u_s, u_s, dt, data_s)
    got = HaloStencil(st, blk).transpose().st.coef
    want = blk.cut(model.assemble_stencil(u, u, dt, data).transpose().coef, lead=3)
    return float((got - want).abs().max() / want.abs().max())


def terminal_mean(u, d):
    """The reference adjoint check's objective: the mean temperature of the
    grid's 5×6 corner (whole state)."""
    return torch.mean(u[1, :5, :6])


def running_mean(u, dt, d):
    """A running objective (summed over the recorded states): Δt times the
    mean pressure of a 5×7 window across the 8×16 grid's 2×2 split, scaled
    to order one (whole state)."""
    return dt * torch.mean(u[0, 2:7, 5:12]) * 1e-12


#: the adjoint checks' objectives, by name: (terminal, running)
OBJECTIVES = {"terminal": (terminal_mean, None), "running": (None, running_mean)}


def adjoint_rank(mesh, model, data, dts, newton_cfg, sweep: dict, pc_cfg=None) -> dict:
    """A decomposed trajectory over ``dts`` (``Simulator.step``) and its
    adjoint with each of :data:`OBJECTIVES`, by name: value, the gathered
    gradients, FGMRES counts and the step counts, on this rank."""
    from thermalporous_torch.solve.adjoint import adjoint_gradients, record_trajectory

    data_s = shard_problem_data(data, mesh)
    sim = Simulator(model, data_s, precond="cptr", pc_cfg=pc_cfg, newton_cfg=newton_cfg,
                    device="cpu")
    states = record_trajectory(sim, shard_state(model.initial_state(data), mesh), dts)
    blk = data_s.block
    out = {}
    for name, (terminal, running) in OBJECTIVES.items():
        mesh.reset_stats()
        res = adjoint_gradients(model, data_s, states, dts, terminal=terminal, running=running,
                                pc_cfg=pc_cfg, **sweep)
        out[name] = {
            "value": float(res.value), "converged": res.converged, "ksp": res.ksp_iters,
            "step_iters": res.step_iters, "exchanges": mesh.stats["exchanges"],
            "grad_fields": blk.gather(blk.owned(res.grad_data.fields, lead=1), lead=1).numpy(),
            "grad_u0": gather_state(res.grad_u0, mesh).numpy()}
    return out


def ensemble_rank(mesh, model, datas, dts, newton_cfg, sweep: dict) -> dict:
    """The ensemble over ranks, both ways: (a) ``shard_ensemble(tree,
    mesh)`` of the four whole members, this rank's one stepped by
    ``make_ensemble_step_fn`` with no collective, then put back together;
    (b) two members each decomposed over the mesh, stacked, two steps of
    the ensemble step, each member's gathered state beside its solo
    decomposed step's, and the ensemble adjoint of :func:`terminal_mean`."""
    from thermalporous_torch.dist.ensemble import (
        gather_ensemble,
        make_ensemble_step_fn,
        shard_ensemble,
        stack_ensemble,
    )
    from thermalporous_torch.solve.adjoint import (
        ensemble_adjoint_gradients,
        record_ensemble_trajectory,
    )
    from thermalporous_torch.solve.timeloop import make_step_fn

    step_e = make_ensemble_step_fn(model, "cptr", newton_cfg, device="cpu")
    whole = stack_ensemble(datas)
    u0 = torch.stack([model.initial_state(d) for d in datas])
    dt_e = torch.tensor(dts[:len(datas)], dtype=torch.float64)
    local_u, local_dt, local_d = shard_ensemble([u0, dt_e, whole], mesh)
    mesh.reset_stats()
    u1, st = step_e(local_u, local_dt, local_d)
    collectives = dict(mesh.stats)
    a = {"u": gather_ensemble(u1, mesh).numpy(), "members": len(local_u),
         "iters": gather_ensemble(st.iters, mesh).tolist(),
         "ksp": gather_ensemble(st.ksp_iters, mesh).tolist(), "collectives": collectives}
    pair = [shard_problem_data(d, mesh) for d in datas[:2]]
    data_e = stack_ensemble(pair)
    u0_e = torch.stack([shard_state(model.initial_state(d), mesh) for d in datas[:2]])
    states = record_ensemble_trajectory(step_e, u0_e, dts[:2], data_e)
    solo = make_step_fn(model, "cptr", newton_cfg, device="cpu")
    bitwise = []
    for i, d in enumerate(pair):
        u = u0_e[i]
        for k, dt in enumerate(dts[:2]):
            u, _ = solo(u, dt, d)
            bitwise.append(torch.equal(u, states[k + 1][i]))
    res = ensemble_adjoint_gradients(model, data_e, states, dts[:2], terminal=terminal_mean,
                                     **sweep)
    blk = data_e.block
    return {"a": a, "bitwise": bitwise,
            "states": [gather_state(states[-1][i], mesh).numpy() for i in range(2)],
            "value": res.value.numpy(), "ksp": res.ksp_iters, "converged": res.converged,
            "grad_fields": [blk.gather(blk.owned(f, lead=1), lead=1).numpy()
                            for f in res.grad_data.fields]}


def family_rank(mesh, steps, applies, transposes, adjoints, ensembles, folds) -> dict:
    """Every multi-rank job of the adjoint-and-transfers checks, in one
    spawn: :func:`options_rank`'s steps (with their collectives) and
    applies, then each of the other functions' jobs (their keyword
    arguments)."""
    out = options_rank(mesh, steps, applies)
    out["transposes"] = [transpose_rank(mesh, **j) for j in transposes]
    out["adjoints"] = [adjoint_rank(mesh, **j) for j in adjoints]
    out["ensembles"] = [ensemble_rank(mesh, **j) for j in ensembles]
    out["folds"] = [fold_rank(mesh, **j) for j in folds]
    return out


# ------------------------------------------------------------------------
# the line solves along x and y, the sparsified and bf16 stage 2, batch_pt,
# every smoother and preconditioner and the audit over ranks
# (tests/test_torch_sharding_rest.py)

def thomas_rank(mesh, shape, axis: int, scalar, block) -> dict:
    """The pipelined line solves along ``axis`` on this rank's block of
    ``shape`` (``scalar``: lower, diag, upper, b of the scalar Thomas;
    ``block``: those of the block one, (nc, nc, *grid) and (nc, *grid)),
    gathered whole: {"scalar", "block"}."""
    from thermalporous_torch.precond.chebyshev import (
        block_tridiag_factor,
        block_tridiag_solve_factored,
        tridiag_solve_along,
    )

    blk = Block.of(mesh, shape)
    cut = lambda t, lead: blk.cut(torch.as_tensor(t), lead=lead, ghosts=False)
    lo, d, up, b = (cut(t, 0) for t in scalar)
    x = tridiag_solve_along(axis, lo, d, up, b, block=blk)
    blo, bd, bup, bb = (cut(t, lead) for t, lead in zip(block, (2, 2, 2, 1)))
    fac = block_tridiag_factor(axis, blo, bd, bup, block=blk)
    xb = block_tridiag_solve_factored(axis, fac, bb, block=blk)
    return {"scalar": blk.gather(x, lead=0).numpy(), "block": blk.gather(xb, lead=1).numpy(),
            "carries": mesh.stats["carries"]}


def audit_rank(mesh, model, data, newton_cfg, dt: float, steps: int) -> dict:
    """A decomposed ``Simulator.run`` of ``steps`` steps of ``dt`` with a
    ``BalanceAuditor`` as its callback: the auditor's totals and report,
    the steps' (Δt, Newton, FGMRES) and the gathered final state."""
    from thermalporous_torch.io.balance import BalanceAuditor
    from thermalporous_torch.solve.timeloop import TimeConfig

    data_s = shard_problem_data(data, mesh)
    sim = Simulator(model, data_s, newton_cfg=newton_cfg,
                    time_cfg=TimeConfig(dt_init=dt, dt_max=dt), device="cpu")
    u0 = shard_state(model.initial_state(data), mesh)
    aud = BalanceAuditor(sim.model, data_s, u0)
    res = sim.run(dt * steps, u0=u0, callback=aud)
    out = {k: getattr(aud, k) for k in ("m0", "m_last", "cum", "cum_abs", "steps", "skipped")}
    out.update(report=aud.report(), u=gather_state(res.u, mesh).numpy(),
               records=[(r.dt, r.newton_iters, r.ksp_iters) for r in res.records])
    return out


def rest_rank(mesh, thomas, steps, applies, audit) -> dict:
    """Every multi-rank job of the remaining options' checks, in one spawn:
    :func:`thomas_rank`'s solves, :func:`options_rank`'s steps (with their
    collectives) and applies, and :func:`audit_rank`'s run."""
    out = {"thomas": []}
    for job in thomas:
        mesh.reset_stats()
        out["thomas"].append(thomas_rank(mesh, **job))
    out.update(options_rank(mesh, steps, applies))
    out["audit"] = audit_rank(mesh, **audit)
    return out
