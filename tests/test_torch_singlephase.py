"""Port parity of the single-phase model family (f64, CPU): the model, its
fused-residual kernel's plain path, the CPTR apply on a two-unknown stencil,
and the single-phase presets through each package's ``Simulator``.

The Simulator runs are the presets ``sp_hot_injection_2d`` at 8×8 and
``sp_geothermal_3d`` at 8×8×6, built in the JAX package and carried into
the port with ``interop.case_from_numpy``, cut to size: both hierarchies
coarsen to at most 8 cells (the preset's 64 would leave these grids with
one level), and the geothermal K-cycle runs from 64 cells (the preset's 4096
would leave it a V-cycle here).  Three controller steps each.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import F64, assert_close, block_pair, model_case, n, t, torch_block
from tests.test_kernels import _fused_case
from thermalporous_torch.core import Grid
from thermalporous_torch.interop import case_from_numpy, problem_data_from_numpy
from thermalporous_torch.kernels import launch_counts
from thermalporous_torch.kernels.residual import fused_residual
from thermalporous_torch.models import SinglePhaseModel
from thermalporous_torch.physics import PhysicalParams, empty_well_fields, well_rates
from thermalporous_torch.precond import CPRConfig, GMGConfig, cpr_apply, cpr_setup
from thermalporous_tpu import presets as jpre
from thermalporous_tpu.kernels.residual_pallas import fused_residual as j_fused_residual
from thermalporous_tpu.models import SinglePhaseModel as JSinglePhaseModel
from thermalporous_tpu.physics import empty_well_fields as j_empty_well_fields
from thermalporous_tpu.physics.wells import well_rates as j_well_rates
from thermalporous_tpu.precond import CPRConfig as JCPRConfig
from thermalporous_tpu.precond import GMGConfig as JGMGConfig
from thermalporous_tpu.precond import cpr_apply as j_cpr_apply
from thermalporous_tpu.precond import cpr_setup as j_cpr_setup
from thermalporous_tpu.solve import Simulator as JSimulator

torch.set_num_threads(1)

RTOL = 1e-12


@pytest.fixture(scope="module", params=[(8, 6), (5, 4, 6)], ids=["2d", "3d"])
def case(request):
    return model_case(request.param, single_phase=True)


def test_residual_scales_initial_state_and_totals(case):
    c = case
    jm, jd, tm, td, dt = c["jm"], c["jd"], c["tm"], c["td"], c["dt"]
    assert tm.nc == jm.nc == 2 and tm.eq_labels == jm.eq_labels
    assert_close(tm.initial_state(td), jm.initial_state(jd), RTOL)
    assert_close(tm.residual(c["tu"], c["tu0"], dt, td),
                 jm.residual(c["ju"], c["ju0"], dt, jd), RTOL, 1e-12)
    assert_close(tm.residual_scales(c["tu0"], dt, td),
                 jm.residual_scales(c["ju0"], dt, jd), RTOL)
    assert_close(tm.in_place_totals(c["tu"], td), jm.in_place_totals(c["ju"], jd), RTOL)
    assert_close(tm.source_totals(c["tu"], td), jm.source_totals(c["ju"], jd), RTOL)
    assert_close(tm.well_sources(c["tu"], td.wells), jm.well_sources(c["ju"], jd.wells),
                 RTOL, 1e-14)


def test_assemble_stencil(case):
    c = case
    js = jax.jit(c["jm"].assemble_stencil)(c["ju"], c["ju0"], c["dt"], c["jd"])
    ts = c["tm"].assemble_stencil(c["tu"], c["tu0"], c["dt"], c["td"])
    assert ts.nc == 2
    assert_close(ts.coef, torch_block(js).coef, RTOL, 1e-14)


def test_well_rates_and_empty_fields(case):
    c = case
    masks = {"INJ": np.zeros(c["tgrid"].shape, bool), "REST": np.ones(c["tgrid"].shape, bool)}
    masks["INJ"][(0,) * len(c["tgrid"].shape)] = True
    got = well_rates(c["tm"], c["tu"], c["td"], masks)
    ref = j_well_rates(c["jm"], c["ju"], c["jd"], masks)
    assert list(got) == list(ref) and list(got["INJ"]) == ["mass_kg_s", "energy_W"]
    for name in ref:
        for key in ref[name]:
            assert got[name][key] == pytest.approx(ref[name][key], rel=RTOL)
    assert got["INJ"]["mass_kg_s"] > 0          # the hot injector injects
    wf = empty_well_fields(c["tgrid"], dtype=F64, device="cpu")
    jw = j_empty_well_fields(c["jm"].grid)
    for name in ("wi", "pbh", "tinj", "has_tinj", "qrate", "qheat"):
        assert_close(getattr(wf, name), getattr(jw, name), 0.0)


@pytest.mark.parametrize("shape", [(64, 64), (12, 16, 8)])
def test_fused_residual_plain_path(shape):
    """The wrappers on CPU tensors are the plain residual, which matches the
    Pallas kernel (interpret mode) at the reference's kernel-test shapes."""
    jm, jd, ju0, ju, _ = _fused_case(JSinglePhaseModel, shape)
    ref = j_fused_residual(jm, ju, ju0, 1200.0, jd, interpret=True)
    w = jd.wells
    td = problem_data_from_numpy(
        [np.asarray(a) for a in jd.tgeo], [np.asarray(a) for a in jd.tcond],
        np.asarray(jd.phi), *(np.asarray(getattr(w, k)) for k in
                              ("wi", "pbh", "tinj", "has_tinj", "qrate", "qheat")),
        dtype=F64, device="cpu")
    tm = SinglePhaseModel(Grid(**dataclasses.asdict(jm.grid)), PhysicalParams())
    got = fused_residual(tm, t(ju), t(ju0), 1200.0, td)
    assert_close(got, ref, RTOL, 1e-12)
    assert launch_counts()["fused_residual_sp"] == 0


# ------------------------------------------------------------ CPTR at nc = 2

@pytest.mark.parametrize("shape", [(16, 16), (8, 6, 4)])
def test_cpr_apply_two_unknowns(shape):
    """cpr_apply on an nc = 2 stencil with stage2_cols on: x₁ has full
    support, so the stage-2 residual is the full matvec, as the reference's
    ``k_active < nc`` rule has it."""
    rng = np.random.default_rng(5)
    js, ts = block_pair(rng, shape, 2)
    r = rng.standard_normal((2,) + shape)
    for stage2 in ("block_jacobi", "rbgs"):
        kw = dict(stage2=stage2, stage2_cols=True)
        gmg = dict(max_coarse_cells=8, degree=2)
        jcfg = JCPRConfig(**kw, gmg=JGMGConfig(**gmg), gmg_t=JGMGConfig(cycle_type="v", **gmg))
        tcfg = CPRConfig(**kw, gmg=GMGConfig(**gmg), gmg_t=GMGConfig(cycle_type="v", **gmg))
        ref = j_cpr_apply(j_cpr_setup(js, jcfg), jnp.asarray(r), jcfg)
        got = cpr_apply(cpr_setup(ts, tcfg), t(r), tcfg)
        assert_close(got, ref, 1e-11, 1e-13)


def test_stage2_cols_takes_the_full_matvec_at_two_unknowns(monkeypatch):
    from thermalporous_torch.core.stencil import BlockStencil

    rng = np.random.default_rng(6)
    _, ts = block_pair(rng, (8, 8), 2)
    called = []
    real = BlockStencil.matvec_cols
    monkeypatch.setattr(BlockStencil, "matvec_cols",
                        lambda self, v, k: called.append(k) or real(self, v, k))
    cfg = CPRConfig(stage2_cols=True, gmg=GMGConfig(max_coarse_cells=8))
    cpr_apply(cpr_setup(ts, cfg), t(rng.standard_normal((2, 8, 8))), cfg)
    assert called == []
    _, ts3 = block_pair(rng, (8, 8), 3)
    cpr_apply(cpr_setup(ts3, cfg), t(rng.standard_normal((3, 8, 8))), cfg)
    assert called == [2]


# ------------------------------------------------------------- the Simulator

SMALL = {"sp_hot_injection_2d": dict(n=8), "sp_geothermal_3d": dict(nx=8, ny=8, nz=6)}
STEPS = 3


def _cut(pc):
    """The preset's CPTR configuration cut to size (module docstring)."""
    pc = pc or JCPRConfig()
    gmg = dict(max_coarse_cells=8)
    if pc.gmg.kcycle_min_cells > 256:
        gmg_p = dict(gmg, kcycle_min_cells=64)
    else:
        gmg_p = gmg
    gmg_t = pc.gmg_t or pc.gmg
    return dataclasses.replace(pc, gmg=dataclasses.replace(pc.gmg, **gmg_p),
                               gmg_t=dataclasses.replace(gmg_t, **gmg))


def _carry(jcase, pc):
    m, d = jcase.model, jcase.data
    w = d.wells
    arrays = dict(tgeo=[np.asarray(a) for a in d.tgeo], tcond=[np.asarray(a) for a in d.tcond],
                  phi=np.asarray(d.phi), **{k: np.asarray(getattr(w, k)) for k in
                                             ("wi", "pbh", "tinj", "has_tinj", "qrate",
                                              "qheat")})
    return case_from_numpy(
        model=type(m).__name__, grid=dataclasses.asdict(m.grid),
        params=dataclasses.asdict(m.pp), data=arrays,
        newton=dataclasses.asdict(jcase.newton_cfg), pc=dataclasses.asdict(pc),
        time=dataclasses.asdict(jcase.time_cfg), t_end=jcase.t_end, dtype=F64,
        device="cpu", name=jcase.name)


@pytest.fixture(scope="module", params=sorted(SMALL))
def sim_runs(request):
    name = request.param
    jcase = jpre.get_case(name, **SMALL[name])
    pc = _cut(jcase.pc_cfg)
    jsim = JSimulator(jcase.model, jcase.data, "cptr", pc, jcase.newton_cfg, jcase.time_cfg)
    jres = jsim.run(jcase.t_end, max_steps=STEPS)
    tcase = _carry(jcase, pc)
    tres = tcase.simulator().run(tcase.t_end, max_steps=STEPS)
    return name, jcase, tcase, jres, tres


def _record(r):
    return (r.step, r.t, r.dt, r.newton_iters, r.ksp_iters, r.retries, r.next_dt)


def test_simulator_matches_the_reference(sim_runs):
    """Identical accepted Δt, Newton and FGMRES counts per step, and states
    within 1e-8 of each equation's largest value."""
    name, jcase, tcase, jres, tres = sim_runs
    assert isinstance(tcase.model, SinglePhaseModel)
    assert [_record(r) for r in tres.records] == [_record(r) for r in jres.records]
    assert tres.steps == STEPS and tres.total_ksp > 0
    ju, tu = np.asarray(jres.u), n(tres.u)
    scale = np.abs(ju).reshape(2, -1).max(axis=1).reshape((2,) + (1,) * (ju.ndim - 1))
    assert (np.abs(tu - ju) <= 1e-8 * scale).all()
    # the hot front: warmer than the initial state somewhere; the upwinding
    # gives no undershoot
    t_init = jcase.model.pp.T_init
    assert tu[1].max() > t_init + 1e-3 and tu[1].min() >= t_init - 1.0
