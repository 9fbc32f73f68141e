"""The grid decomposition (``thermalporous_torch/dist/sharding.py``) against
the reference's checks in ``tests/test_sharding.py``, on 4 gloo ranks on
the CPU (a 2×2 mesh).

- ``mesh_shape`` is the reference's ``make_grid_mesh(n).devices.shape``;
  the owned ranges and the blocks' coarsening follow their rule.
- A one-rank mesh is the undecomposed ``Simulator.step`` bit for bit.
- The decomposed Newton step of the reference's ``_case`` (16×16) takes
  the JAX single-device step's Newton and FGMRES counts, within that
  test's tolerances; so does the counterpart of
  ``test_gmg_replicated_coarse_levels_match`` (32×32,
  ``replicate_below=256``), whose coarsest level is the same on every
  rank; the Gram-matrix CGS2 forms ("cgs2g", "cgs2g2", the counterpart of
  ``test_sharded_ksp_orth_gram_match``) take the undecomposed port's
  counts.  Every rank holds the same counts, state and well records, the
  records those of the gathered state.  One spawn runs the ranks' steps
  while this process computes the references.
- Every option, preconditioner and path the decomposition runs is, on a
  one-rank mesh, the undecomposed step (or sweep, or audit) bit for bit
  (their 2×2 checks are ``test_torch_sharding_options.py``,
  ``test_torch_sharding_adjoint.py`` and ``test_torch_sharding_rest.py``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from _torch_parity import carry_model_data
from thermalporous_torch.dist import ensemble as tens
from thermalporous_torch.dist.launch import run_ranks
from thermalporous_torch.dist.sharding import (
    Block,
    gather_state,
    make_grid_mesh,
    mesh_shape,
    shard_problem_data,
    shard_state,
    split_ranges,
)
from thermalporous_torch.io.balance import BalanceAuditor
from thermalporous_torch.physics.wells import well_rates
from thermalporous_torch.precond.cpr import CPRConfig
from thermalporous_torch.precond.gmg import GMGConfig
from thermalporous_torch.solve.adjoint import adjoint_gradients
from thermalporous_torch.solve.newton import NewtonConfig as TNewtonConfig
from thermalporous_torch.solve.timeloop import Simulator as TSimulator
from thermalporous_tpu.core import Grid
from thermalporous_tpu.dist import make_grid_mesh as j_make_grid_mesh
from thermalporous_tpu.models import SinglePhaseModel, TwoPhaseModel, make_problem_data
from thermalporous_tpu.physics import PhysicalParams, Well
from thermalporous_tpu.solve import NewtonConfig, Simulator

DT = 3600.0


def _case(model_cls, n=16, seed=0):
    """The reference test's ``_case``."""
    pp = PhysicalParams()
    g = Grid(shape=(n, n), spacing=(10.0, 10.0), thickness=5.0)
    rng = np.random.default_rng(seed)
    k = 1e-13 * np.exp(0.5 * rng.standard_normal(g.shape))
    wells = [
        Well(cells=((0, 0),), control="bhp", p_bh=3.0e7, T_inj=420.0),
        Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7),
    ]
    return model_cls(g, pp), make_problem_data(g, pp, kx=k, phi=0.2, wells=wells)


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_is_the_reference(n):
    assert mesh_shape(n) == j_make_grid_mesh(n).devices.shape


def test_owned_ranges_and_coarsened_blocks():
    # the flagship's axes over 2: boundaries on multiples of 32 and 16
    assert split_ranges(60, 2) == (0, 32, 60)
    assert split_ranges(220, 2) == (0, 112, 220)
    for n, m in ((8, 2), (15, 2), (220, 4), (7, 3), (3, 3)):
        b = split_ranges(n, m)
        assert b[0] == 0 and b[-1] == n and all(hi > lo for lo, hi in zip(b, b[1:]))
    mesh = make_grid_mesh(1, device="cpu")
    blk = Block(mesh, (60, 220, 85), (split_ranges(60, 2), split_ranges(220, 2)), 5)
    assert blk.aligned((2, 2, 2)) and blk.fits()
    c = blk.coarsen((2, 2, 1))
    assert c.shape == (30, 110, 85) and c.bounds == ((0, 16, 30), (0, 56, 110))
    odd = Block(mesh, (15, 21), ((0, 7, 15), (0, 10, 21)), 1)
    assert not odd.aligned((2, 1)) and odd.aligned((1, 2))


def test_one_rank_mesh_is_the_undecomposed_step():
    """The flagship's solver configuration on a small two-phase case, with
    the fused coarse subtree on: the one-rank decomposed step takes the
    undecomposed step's bits and counts."""
    jm, jd = _case(TwoPhaseModel, n=12)
    model, data = carry_model_data(jm, jd)
    newton = TNewtonConfig(rtol=1e-9, ksp_rtol=1e-7, ds_max=0.2, ksp_ew=True,
                           ls_mode="nonmonotone", ksp_orth="cgs2g")
    gmg = dict(cycle_type="k", degree=4, max_coarse_cells=8, kcycle_min_cells=64,
               fuse_below=40, replicate_below=36)
    pc = lambda mesh: CPRConfig(stage2="rbgs", gmg=GMGConfig(mesh=mesh, **gmg),
                                gmg_t=GMGConfig(cycle_type="v", degree=2, max_coarse_cells=8,
                                                mesh=mesh, replicate_below=36))
    u0 = model.initial_state(data)
    ref, st_ref = TSimulator(model, data, pc_cfg=pc(None), newton_cfg=newton,
                             device="cpu").step(u0, DT)
    mesh = make_grid_mesh(1, device="cpu")
    sim = TSimulator(model, shard_problem_data(data, mesh), pc_cfg=pc(mesh),
                     newton_cfg=newton, device="cpu")
    got, st = sim.step(shard_state(u0, mesh), DT)
    assert (st.iters, st.ksp_iters) == (st_ref.iters, st_ref.ksp_iters)
    assert torch.equal(gather_state(got, mesh), ref)


def _jax_step(jm, jd, cfg, pc=None):
    u, st = Simulator(jm, jd, precond="cptr", newton_cfg=cfg, pc_cfg=pc).step(
        jm.initial_state(jd), DT)
    return int(st.iters), int(st.ksp_iters), np.asarray(u)


def test_decomposed_steps_match_the_references():
    sp, sp_data = _case(SinglePhaseModel)
    sp32, sp32_data = _case(SinglePhaseModel, n=32)
    tp, tp_data = _case(TwoPhaseModel)
    jcfg = NewtonConfig(rtol=1e-9, ksp_rtol=1e-7)
    tcfg = TNewtonConfig(rtol=1e-9, ksp_rtol=1e-7)
    m_sp, d_sp = carry_model_data(sp, sp_data)
    m_32, d_32 = carry_model_data(sp32, sp32_data)
    m_tp, d_tp = carry_model_data(tp, tp_data)
    orth = ("cgs2g", "cgs2g2")
    jobs = [dict(model=m_sp, data=d_sp, newton_cfg=tcfg, pc_cfg=None, dt=DT),
            dict(model=m_32, data=d_32, newton_cfg=tcfg, pc_cfg=ranks.replicated_pc, dt=DT,
                 coarsest=True)]
    jobs += [dict(model=m_tp, data=d_tp, pc_cfg=None, dt=DT,
                  newton_cfg=dataclasses.replace(tcfg, ksp_orth=o)) for o in orth]

    def references():
        refs = [_jax_step(sp, sp_data, jcfg),
                _jax_step(sp32, sp32_data, jcfg)]
        for o in orth:
            u, st = TSimulator(m_tp, d_tp, newton_cfg=dataclasses.replace(tcfg, ksp_orth=o),
                               device="cpu").step(m_tp.initial_state(d_tp), DT)
            refs.append((st.iters, st.ksp_iters, u.numpy()))
        return refs

    outs, refs = run_ranks(ranks.steps_rank, 4, jobs, meanwhile=references)
    for r in range(1, 4):       # every rank holds the same counts, state and rates
        for a, b in zip(outs[0], outs[r]):
            assert a[:3] == b[:3] and np.array_equal(a[3], b[3]) and a[4] == b[4]
    for (iters, ksp, conv, u, rates, *rest), (r_iters, r_ksp, r_u), atol_last, job in zip(
            outs[0], refs, (1e-6, 1e-6, 1e-8, 1e-8), jobs):
        assert conv
        assert (iters, ksp) == (r_iters, r_ksp)
        np.testing.assert_allclose(u[0], r_u[0], atol=5.0)
        np.testing.assert_allclose(u[-1], r_u[-1], atol=atol_last)
        # the decomposed well records: the whole grid's at the gathered state
        whole = well_rates(job["model"], torch.as_tensor(u), job["data"],
                           ranks.corner_masks(u.shape[1:]))
        for name, rec in whole.items():
            for key, val in rec.items():
                assert rates[name][key] == pytest.approx(val, rel=1e-12, abs=1e-12)
    # the replicated coarse levels: a decomposed finest level, and the
    # coarsest stencil the same on every rank
    n_dec, coarse = outs[0][1][5], outs[0][1][6]
    assert n_dec >= 1 and coarse.shape == (8, 8)
    assert all(np.array_equal(o[1][6], coarse) for o in outs[1:])


@pytest.fixture(scope="module")
def one_rank_case():
    jm, jd = _case(TwoPhaseModel, n=8)
    model, data = carry_model_data(jm, jd)
    mesh = make_grid_mesh(1, device="cpu")
    return model, data, mesh, shard_problem_data(data, mesh)


#: the options the stage-2 and Krylov slice lifted, then the adjoint and
#: transfer slice, then the rest: the line solves along x and y, the
#: sparsified stage 2, batch_pt and bf16 storage ("pc+levels": with the
#: finest level of each hierarchy decomposed), every smoother and cycle
#: count, and every preconditioner
_LIFTED = [
    ("newton", dict(ksp_orth="cgs1")), ("newton", dict(ksp_orth="cgs2s")),
    ("newton", dict(ksp_recycle=2)), ("pc", dict(s_stage="rbgs")),
    ("pc", dict(inner_iters=2)), ("pc", dict(stage2="bgmg")),
    ("pc", dict(stage2="rbgs", stage2_sweeps=2)), ("pc", dict(stage2="jacobi2")),
    ("newton", dict(krylov_op="jvp")),
    ("gmg", dict(transfer="weighted")), ("gmg", dict(transfer="variational")),
    ("pc", dict(stage2="zebra")), ("pc", dict(stage2="zebra", stage2_axis=0)),
    ("pc", dict(s_stage="line")), ("pc", dict(s_stage="zebra", s_axis=1)),
    ("pc", dict(stage2="rbgs", stage2_axes=(0,))),
    ("pc", dict(stage2="rbgs", stage2_fused=True)),
    ("pc", dict(stage2="rbgs", stage2_fused=True, stage2_axes=(1,), stage2_sweeps=2)),
    ("pc+levels", dict(batch_pt=True, triangular=False)),
    ("pc+levels", dict(pc_dtype="bf16")), ("pc+levels", dict(pc_dtype="bf16_gmg")),
    ("pc+levels", dict(pc_dtype="bf16_s2", stage2="rbgs", stage2_sweeps=2)),
    ("gmg", dict(smoother="rbgs")), ("gmg", dict(smoother="jacobi")),
    ("gmg", dict(smoother="line")), ("gmg", dict(smoother="zebra", line_axis=0)),
    ("gmg", dict(cycles=2)),
    ("precond", "none"), ("precond", "jacobi"), ("precond", "rbgs"), ("precond", "lu"),
]


@pytest.mark.parametrize("kind,option", _LIFTED, ids=[f"{k}-{o}" for k, o in _LIFTED])
def test_lifted_options_one_rank_mesh_is_undecomposed(one_rank_case, kind, option):
    """Each lifted option on the one-rank fixture's mesh: the undecomposed
    step's bits and counts (bgmg with a two-level coupled hierarchy whose
    finest level is decomposed)."""
    model, data, mesh, data_s = one_rank_case
    kw = dict(device="cpu")
    if kind == "newton":
        kw["newton_cfg"] = TNewtonConfig(**option)
    elif kind == "gmg":
        # the finest level decomposed, its transfer set up on the block
        kw["pc_cfg"] = CPRConfig(gmg=GMGConfig(**option, max_coarse_cells=16,
                                               replicate_below=32))
    elif kind == "pc+levels":
        kw["pc_cfg"] = CPRConfig(**option, gmg=GMGConfig(max_coarse_cells=16,
                                                         replicate_below=32))
    elif kind == "precond":
        kw["precond"] = option
        if option == "none":
            # unpreconditioned, the default Krylov tolerance leaves Newton's
            # line search short of convergence (undecomposed too)
            kw["newton_cfg"] = TNewtonConfig(ksp_rtol=1e-8)
    else:
        if option.get("stage2") == "bgmg":
            option = dict(option, bgmg_coarse_cells=16, gmg=GMGConfig(replicate_below=32))
        kw["pc_cfg"] = CPRConfig(**option)
    u0 = model.initial_state(data)
    ref, st_ref = TSimulator(model, data, **kw).step(u0, DT)
    got, st = TSimulator(model, data_s, **kw).step(shard_state(u0, mesh), DT)
    assert st.converged and (st.iters, st.ksp_iters) == (st_ref.iters, st_ref.ksp_iters)
    assert torch.equal(gather_state(got, mesh), ref)


def test_lifted_paths_one_rank_mesh_is_undecomposed(one_rank_case):
    """The adjoint, ``stack_ensemble`` of decomposed members and
    ``shard_ensemble`` over the mesh, on the one-rank fixture's mesh: the
    undecomposed sweep's gradients and counts bit for bit, the members'
    fields stacked with their block, every member on the one rank."""
    model, data, mesh, data_s = one_rank_case
    u0 = model.initial_state(data)
    sim = TSimulator(model, data, device="cpu")
    u1, _ = sim.step(u0, DT)
    obj = dict(terminal=lambda u, d: torch.mean(u[1, :3, :4]))
    ref = adjoint_gradients(model, data, [u0, u1], [DT], **obj)
    got = adjoint_gradients(model, data_s, [shard_state(u0, mesh), shard_state(u1, mesh)],
                            [DT], **obj)
    assert got.step_iters == ref.step_iters and got.converged
    assert torch.equal(got.grad_data.fields, ref.grad_data.fields)
    assert torch.equal(got.grad_u0, ref.grad_u0) and torch.equal(got.value, ref.value)
    stacked = tens.stack_ensemble([data_s, data_s])
    assert stacked.block is data_s.block and torch.equal(stacked.fields[1], data.fields)
    assert stacked.member(1).block is data_s.block
    placed = tens.shard_ensemble(u0[None], mesh)
    assert torch.equal(placed, u0[None])


def test_jacobi_adjoint_and_audit_one_rank_mesh_are_undecomposed(one_rank_case):
    """The adjoint under ``precond="jacobi"`` and the balance audit over a
    step, on the one-rank fixture's mesh: the undecomposed sweep's
    gradients and counts, and the undecomposed auditor's report, bit for
    bit."""
    model, data, mesh, data_s = one_rank_case
    u0 = model.initial_state(data)
    u1, _ = TSimulator(model, data, device="cpu").step(u0, DT)
    obj = dict(terminal=lambda u, d: torch.mean(u[1, :3, :4]), precond="jacobi")
    ref = adjoint_gradients(model, data, [u0, u1], [DT], **obj)
    u0_s, u1_s = shard_state(u0, mesh), shard_state(u1, mesh)
    got = adjoint_gradients(model, data_s, [u0_s, u1_s], [DT], **obj)
    assert got.step_iters == ref.step_iters
    assert torch.equal(got.grad_data.fields, ref.grad_data.fields)
    assert torch.equal(got.grad_u0, ref.grad_u0)
    rec = type("Rec", (), dict(dt=DT))()
    reports = []
    for d, a, b in ((data, u0, u1), (data_s, u0_s, u1_s)):
        aud = BalanceAuditor(model, d, a)
        aud(1, DT, b, rec)
        reports.append(aud.report())
    assert reports[0] == reports[1] and reports[0]["steps"] == 1


def test_reference_mesh_has_eight_devices():
    """The JAX side of these checks: the forced 8-device CPU mesh."""
    assert len(jax.devices()) == 8
