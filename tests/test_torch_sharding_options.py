"""The stage-2 and Krylov options over a grid decomposition against the
reference's option checks in ``tests/test_sharding.py``, on 4 gloo ranks on
the CPU (a 2×2 mesh), in one spawn.

- The counterparts of ``test_sharded_s_stage_match``,
  ``test_sharded_stage2_zebra_z_match``, ``test_sharded_stage2_bgmg_match``
  and ``test_sharded_ksp_recycle_match``, on those tests' grids, seeds,
  wells, ``NewtonConfig`` and ``CPRConfig``: the Newton and FGMRES counts of
  the reference, p within 10 Pa and S within 1e-8 (those tests'
  tolerances).  The ``bgmg`` step is held against the JAX single-device
  step, with ``replicate_below`` low enough that the coupled hierarchy's
  finest level is decomposed, and its coarsest level is the same on every
  rank; the other three against the undecomposed port's CPU step (the
  port's parity tests hold each option against JAX).
- The reference's 16×16 ``_case`` with "cgs1", "cgs2s", ``jacobi2``, two
  rbgs sweeps, two inner iterations of each ``inner_method`` and
  ``s_stage="rbgs"``, held against the undecomposed port; and grids that
  split at an odd index (14 cells over 2 ranks: owned origins 7), so that
  the red-black continuation sweeps, the saturation leg's red-black and
  zebra smoothers and the z-line zebra stage 2 run in a colour offset.
- Every rank holds the same counts, state bits and well records, the
  records those of the gathered state.
- The decomposed CPTR apply of each lifted preconditioner option, gathered,
  equals the undecomposed apply to rounding (1e-12 of each component's
  largest entry)
  on a 14×14×4 grid split at the odd index 7 (bgmg on a 16×16×4 grid,
  whose coupled hierarchy keeps two decomposed levels): a colour offset or
  a ghost ring wrong anywhere shows here, where a Newton step's counts and
  bands may not see it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from _torch_parity import carry_model_data
from thermalporous_torch.dist.launch import run_ranks
from thermalporous_torch.dist.sharding import split_ranges
from thermalporous_torch.physics.wells import well_rates
from thermalporous_torch.precond.cpr import CPRConfig as TCPRConfig
from thermalporous_torch.precond.cpr import cpr_apply, cpr_setup
from thermalporous_torch.precond.gmg import GMGConfig as TGMGConfig
from thermalporous_torch.solve.newton import NewtonConfig as TNewtonConfig
from thermalporous_torch.solve.timeloop import Simulator as TSimulator
from thermalporous_tpu.core import Grid
from thermalporous_tpu.models import TwoPhaseModel, make_problem_data
from thermalporous_tpu.physics import PhysicalParams, Well
from thermalporous_tpu.precond import CPRConfig
from thermalporous_tpu.solve import NewtonConfig, Simulator

DT = 3600.0


def _case(n=16, seed=0):
    """The reference test's ``_case`` (two-phase)."""
    pp = PhysicalParams()
    g = Grid(shape=(n, n), spacing=(10.0, 10.0), thickness=5.0)
    rng = np.random.default_rng(seed)
    k = 1e-13 * np.exp(0.5 * rng.standard_normal(g.shape))
    wells = [
        Well(cells=((0, 0),), control="bhp", p_bh=3.0e7, T_inj=420.0),
        Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7),
    ]
    return TwoPhaseModel(g, pp), make_problem_data(g, pp, kx=k, phi=0.2, wells=wells)


def _case_3d(seed, sigma, shape=(8, 16, 6)):
    """The 8×16×6 grid of the reference's s_stage, zebra and bgmg checks:
    gravity, kz = 0.3 kx, BHP wells on the corner columns."""
    pp = PhysicalParams()
    nx, ny, nz = shape
    g = Grid(shape=shape, spacing=(10.0, 10.0, 4.0), gravity=9.81)
    rng = np.random.default_rng(seed)
    k = 1e-13 * np.exp(sigma * rng.standard_normal(g.shape))
    wells = [
        Well(cells=tuple((0, 0, iz) for iz in range(nz)), control="bhp",
             p_bh=4.0e7, T_inj=420.0),
        Well(cells=tuple((nx - 1, ny - 1, iz) for iz in range(nz)), control="bhp",
             p_bh=1.5e7),
    ]
    data = make_problem_data(g, pp, kx=k, kz=0.3 * k, phi=0.2, wells=wells)
    return TwoPhaseModel(g, pp), data


#: the 2D options on ``_case`` (the reference's sharded-step NewtonConfig):
#: (label, NewtonConfig overrides, CPRConfig overrides)
CASE_OPTIONS = (
    ("cgs1", dict(ksp_orth="cgs1"), {}),
    ("cgs2s", dict(ksp_orth="cgs2s"), {}),
    ("jacobi2", {}, dict(stage2="jacobi2")),
    ("rbgs sweeps=2", {}, dict(stage2="rbgs", stage2_sweeps=2)),
    ("inner fgmres", {}, dict(inner_iters=2)),
    ("inner richardson", {}, dict(inner_iters=2, inner_method="richardson")),
    ("s_stage=rbgs 2D", {}, dict(s_stage="rbgs")),
)
#: the reference checks' options (label, CPRConfig keywords of both
#: packages, the port's GMGConfig keywords, NewtonConfig overrides)
REF_NEWTON = dict(rtol=1e-8, ksp_rtol=1e-6, ksp_maxiter=80)
LABELS = [c[0] for c in CASE_OPTIONS] + ["s_stage", "zebra z", "bgmg", "ksp_recycle",
                                         "odd split 2D", "odd split 3D"]


#: the preconditioner options whose decomposed apply is held to the whole
#: apply (label, CPRConfig keywords); "bgmg" runs on APPLY_BGMG_SHAPE
APPLY_OPTIONS = (
    ("rbgs sweeps=2", dict(stage2="rbgs", stage2_sweeps=2)),
    ("rbgs sweeps=3 s_stage=rbgs", dict(stage2="rbgs", stage2_sweeps=3, s_stage="rbgs")),
    ("jacobi2", dict(stage2="jacobi2")),
    ("zebra z sweeps=2", dict(stage2="zebra", stage2_axis=2, stage2_sweeps=2)),
    ("s_stage=jacobi", dict(s_stage="jacobi")),
    ("s_stage=zebra z", dict(s_stage="zebra", s_axis=2)),
    ("s_stage=line z", dict(s_stage="line", s_axis=2)),
    ("inner fgmres", dict(inner_iters=2)),
    ("inner richardson", dict(inner_iters=2, inner_method="richardson")),
    ("bgmg cycles=2", dict(stage2="bgmg", bgmg_coarse_cells=16, bgmg_cycles=2,
                           gmg=TGMGConfig(replicate_below=50))),
)
APPLY_SHAPE = (14, 14, 4)
APPLY_BGMG_SHAPE = (16, 16, 4)


@pytest.fixture(scope="module")
def spawned():
    """One spawn of 4 gloo ranks for every job, the references computed in
    this process meanwhile: (rank outputs per job per rank, references per
    job, jobs by label)."""
    tp, tp_data = _case()
    m2, d2 = carry_model_data(tp, tp_data)
    base = TNewtonConfig(rtol=1e-9, ksp_rtol=1e-7)
    jobs = {}
    for label, nkw, pkw in CASE_OPTIONS:
        jobs[label] = dict(model=m2, data=d2, newton_cfg=dataclasses.replace(base, **nkw),
                           pc_cfg=TCPRConfig(**pkw) if pkw else None, dt=DT)
    ref3 = TNewtonConfig(**REF_NEWTON)
    s_m, s_d = _case_3d(11, 1.5)
    z_m, z_d = _case_3d(13, 1.0)
    r_m, r_d = _case(seed=3)
    o2_m, o2_d = _case(n=14)
    o3_m, o3_d = _case_3d(13, 1.0, shape=(14, 14, 4))
    for label, (jm, jd), pc, newton in (
            ("s_stage", (s_m, s_d), TCPRConfig(stage2="rbgs", s_stage="rbgs", s_sweeps=2), ref3),
            ("zebra z", (z_m, z_d), TCPRConfig(stage2="zebra", stage2_axis=2, stage2_sweeps=1),
             ref3),
            # the coupled hierarchy 8x16x6 -> 4x8x3: the finest level (768
            # cells) decomposed, the coarsest (96) replicated
            ("bgmg", (z_m, z_d), TCPRConfig(stage2="bgmg", bgmg_coarse_cells=96,
                                            gmg=TGMGConfig(replicate_below=100)), ref3),
            ("ksp_recycle", (r_m, r_d), None, dataclasses.replace(ref3, ksp_recycle=4)),
            ("odd split 2D", (o2_m, o2_d),
             TCPRConfig(stage2="rbgs", stage2_sweeps=2, s_stage="rbgs"), base),
            ("odd split 3D", (o3_m, o3_d),
             TCPRConfig(stage2="zebra", stage2_axis=2, s_stage="zebra", s_axis=2), ref3)):
        model, data = carry_model_data(jm, jd)
        jobs[label] = dict(model=model, data=data, newton_cfg=newton, pc_cfg=pc, dt=DT,
                           coarsest=label == "bgmg")
    jobs = {label: jobs[label] for label in LABELS}
    applies = []
    for label, pkw in APPLY_OPTIONS:
        shape = APPLY_BGMG_SHAPE if label.startswith("bgmg") else APPLY_SHAPE
        model, data = carry_model_data(*_case_3d(13, 1.0, shape=shape))
        # a state far off equilibrium with both phases mobile, so that the
        # saturation couples across cells as strongly as it does (at the
        # hydrostatic initial state its fluxes' S-derivatives vanish and the
        # S-S operator is diagonal: no colouring would show)
        rng = np.random.default_rng(7)
        u = model.initial_state(data).numpy()
        u[2] = 0.5
        u = u + np.array([1e6, 1.0, 0.1]).reshape(3, 1, 1, 1) * rng.standard_normal((3,) + shape)
        u[2] = np.clip(u[2], 0.05, 0.95)
        r = rng.standard_normal((3,) + shape)
        applies.append(dict(model=model, data=data, u=u, dt=DT, r=r,
                            pc_cfg=TCPRConfig(**pkw)))

    def references():
        refs = {}
        u, st = Simulator(z_m, z_d, precond="cptr", newton_cfg=NewtonConfig(**REF_NEWTON),
                          pc_cfg=CPRConfig(stage2="bgmg", bgmg_coarse_cells=96)).step(
            z_m.initial_state(z_d), DT)
        refs["bgmg"] = (int(st.iters), int(st.ksp_iters), np.asarray(u))
        for label, job in jobs.items():
            if label == "bgmg":
                continue
            model, data = job["model"], job["data"]
            u, st = TSimulator(model, data, pc_cfg=job["pc_cfg"], newton_cfg=job["newton_cfg"],
                               device="cpu").step(model.initial_state(data), DT)
            refs[label] = (st.iters, st.ksp_iters, u.numpy())
        for (label, _), a in zip(APPLY_OPTIONS, applies):
            model, data, u = a["model"], a["data"], torch.as_tensor(a["u"])
            state = cpr_setup(model.assemble_stencil(u, u, DT, data), a["pc_cfg"])
            refs[label, "apply"] = cpr_apply(state, torch.as_tensor(a["r"]), a["pc_cfg"]).numpy()
        return refs

    outs, refs = run_ranks(ranks.options_rank, 4, list(jobs.values()), applies,
                           meanwhile=references)
    steps = {label: [o["steps"][i] for o in outs] for i, label in enumerate(jobs)}
    for i, (label, _) in enumerate(APPLY_OPTIONS):
        steps[label, "apply"] = [o["applies"][i] for o in outs]
    return steps, refs, jobs


@pytest.mark.parametrize("label", LABELS)
def test_option_over_2x2_ranks_takes_the_reference_counts(spawned, label):
    outs, refs, jobs = spawned
    iters, ksp, conv, u, rates = outs[label][0][:5]
    r_iters, r_ksp, r_u = refs[label]
    assert conv
    assert (iters, ksp) == (r_iters, r_ksp)
    np.testing.assert_allclose(u[0], r_u[0], atol=10.0)
    np.testing.assert_allclose(u[2], r_u[2], atol=1e-8)
    # every rank holds the same counts, state bits and well records
    for o in outs[label][1:]:
        assert o[:3] == (iters, ksp, conv) and np.array_equal(o[3], u) and o[4] == rates
    # the decomposed well records: the whole grid's at the gathered state
    job = jobs[label]
    whole = well_rates(job["model"], torch.as_tensor(u), job["data"],
                       ranks.corner_masks(u.shape[1:]))
    for name, rec in whole.items():
        for key, val in rec.items():
            assert rates[name][key] == pytest.approx(val, rel=1e-12, abs=1e-12)
    # the step exchanged ghosts and reduced through the mesh on every rank
    assert all(o[-1][0] > 0 and o[-1][1] > 0 for o in outs[label])


@pytest.mark.parametrize("label", [a[0] for a in APPLY_OPTIONS])
def test_decomposed_apply_is_the_whole_apply(spawned, label):
    outs, refs, _ = spawned
    got, ref = outs[label, "apply"], refs[label, "apply"]
    assert all(np.array_equal(g, got[0]) for g in got[1:])
    for c in range(ref.shape[0]):       # per component: p, T and S differ in scale
        np.testing.assert_allclose(got[0][c], ref[c], rtol=0,
                                   atol=1e-12 * float(np.abs(ref[c]).max()))


def test_bgmg_finest_block_level_is_decomposed(spawned):
    """The coupled hierarchy over 2x2: its finest level decomposed, its
    coarsest (replicated) level the same on every rank."""
    outs, _, _ = spawned
    n_dec, coarse = outs["bgmg"][0][5], outs["bgmg"][0][6]
    assert n_dec >= 1 and coarse.shape == (3, 3, 4, 8, 3)
    assert all(o[5] == n_dec and np.array_equal(o[6], coarse) for o in outs["bgmg"][1:])


def test_odd_split_jobs_split_at_an_odd_index():
    """The odd-split jobs' grids: 14 cells over 2 ranks split at 7, so the
    blocks of mesh coordinate 1 have an odd owned origin (the halo view's
    colour offset) and an odd extended origin (the kernels')."""
    assert split_ranges(14, 2) == (0, 7, 14)
    assert split_ranges(16, 2) == (0, 8, 16) and split_ranges(8, 2) == (0, 4, 8)
