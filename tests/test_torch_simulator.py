"""Port parity of the time loop (f64, CPU): the flagship configuration
(``tp_spe10_full``'s Newton, CPTR and controller settings) through each
package's ``Simulator`` on the same small synthetic SPE10 grid, and the
port's entry points' device default.

The case is built once in the JAX package and carried into the port with
``interop.case_from_numpy`` (plain arrays and ``dataclasses.asdict`` of the
configurations), so both run literally the same case.  Cut to size: an
8×14×6 grid with ``max_coarse_cells=8`` (each hierarchy keeps at least four
levels), K-cycles from 64 cells and the coarse subtree fused below 100
cells.  ``max_iters=5`` forces a failed attempt in the fourth controller
step, so the cutback and the failure memory (``dt_cap``) run, and
``ds_max=0.05`` (the preset's is 0.2) makes the Appleyard chop clamp in
these short early steps.  The Krylov
basis is the working dtype (``ksp_basis="same"``): a bf16 basis rounds
differently in the two packages.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests._torch_parity import F64, PORT_DIR
from thermalporous_torch import presets as tpre
from thermalporous_torch.interop import case_from_numpy, config_from_dict, state_to_numpy
from thermalporous_torch.precond import CPRConfig, GMGConfig
from thermalporous_torch.solve import NewtonConfig, make_step_fn
from thermalporous_torch.solve import newton as tnewton
from thermalporous_torch.solve import timeloop as ttimeloop
from thermalporous_torch.solve.timeloop import Simulator, TimeConfig
from thermalporous_tpu.core import Grid as JGrid
from thermalporous_tpu.data.spe10 import SPE10_SPACING_M, synthetic_spe10
from thermalporous_tpu.models import TwoPhaseModel as JTwoPhaseModel
from thermalporous_tpu.models import make_problem_data as j_make_problem_data
from thermalporous_tpu.physics import PhysicalParams as JPhysicalParams
from thermalporous_tpu.physics import Well as JWell
from thermalporous_tpu.precond import CPRConfig as JCPRConfig
from thermalporous_tpu.precond import GMGConfig as JGMGConfig
from thermalporous_tpu.solve import NewtonConfig as JNewtonConfig
from thermalporous_tpu.solve import Simulator as JSimulator
from thermalporous_tpu.solve import TimeConfig as JTimeConfig

torch.set_num_threads(1)

SHAPE = (8, 14, 6)
STEPS = 4
SMALL_GMG = dict(max_coarse_cells=8, fuse_below=100)


def _jax_configs():
    """The flagship's configurations as the reference's objects, cut to
    size as the module docstring says."""
    time_cfg, newton_cfg, pc_cfg = tpre.flagship_configs()
    gmg = lambda g, **kw: JGMGConfig(**dict(dataclasses.asdict(g), **SMALL_GMG, **kw))
    pc = dataclasses.asdict(pc_cfg)
    pc.update(gmg=gmg(pc_cfg.gmg, kcycle_min_cells=64), gmg_t=gmg(pc_cfg.gmg_t))
    newton = dict(dataclasses.asdict(newton_cfg), max_iters=5, ksp_basis="same", ds_max=0.05)
    return (JTimeConfig(**dataclasses.asdict(time_cfg)), JNewtonConfig(**newton),
            JCPRConfig(**pc))


def _jax_case():
    nx, ny, nz = SHAPE
    fields = synthetic_spe10(shape=SHAPE, seed=2020)
    g = JGrid(shape=SHAPE, spacing=SPE10_SPACING_M, gravity=9.81,
              depth_top=3600.0 * 0.3048)
    wells = [JWell(cells=w.cells, control=w.control, p_bh=w.p_bh, T_inj=w.T_inj,
                   name=w.name) for w in tpre._flagship_wells(nx, ny, nz)]
    pp = JPhysicalParams()
    data = j_make_problem_data(g, pp, kx=fields.kx, ky=fields.ky, kz=fields.kz,
                               phi=fields.phi, wells=wells)
    return g, pp, JTwoPhaseModel(g, pp, s_init=0.15), data


def _carry(g, pp, model, data, time_cfg, newton_cfg, pc_cfg):
    w = data.wells
    arrays = dict(tgeo=[np.asarray(a) for a in data.tgeo],
                  tcond=[np.asarray(a) for a in data.tcond], phi=np.asarray(data.phi),
                  wi=np.asarray(w.wi), pbh=np.asarray(w.pbh), tinj=np.asarray(w.tinj),
                  has_tinj=np.asarray(w.has_tinj), qrate=np.asarray(w.qrate),
                  qheat=np.asarray(w.qheat))
    return case_from_numpy(
        grid=dataclasses.asdict(g), params=dataclasses.asdict(pp),
        relperm=dataclasses.asdict(model.relperm), s_init=model.s_init, data=arrays,
        newton=dataclasses.asdict(newton_cfg), pc=dataclasses.asdict(pc_cfg),
        time=dataclasses.asdict(time_cfg), t_end=30 * 86400.0, dtype=F64, device="cpu")


def _record(r):
    return (r.step, r.t, r.dt, r.newton_iters, r.ksp_iters, r.retries, r.next_dt,
            r.dt_cap)


@pytest.fixture(scope="module")
def runs():
    """Both packages' runs, the port's with its chop, its Krylov tolerances
    and its coarse-subtree calls recorded."""
    time_cfg, newton_cfg, pc_cfg = _jax_configs()
    g, pp, model, data = _jax_case()
    jsim = JSimulator(model, data, "cptr", pc_cfg, newton_cfg, time_cfg)
    jres = jsim.run(30 * 86400.0, max_steps=STEPS)

    case = _carry(g, pp, model, data, time_cfg, newton_cfg, pc_cfg)
    seen = {"chopped": 0, "rtols": [], "fused": 0}
    real_solve, real_fgmres = ttimeloop.newton_solve, tnewton.fgmres
    from thermalporous_torch.precond import gmg as tgmg
    real_fused = tgmg._fused_correction

    def solve(*args, chop=None, **kw):
        def counted_chop(u, dx):
            out = chop(u, dx)
            seen["chopped"] += int(not torch.equal(out, dx))
            return out
        return real_solve(*args, chop=None if chop is None else counted_chop, **kw)

    def fgmres(*args, rtol, **kw):
        seen["rtols"].append(float(rtol))
        return real_fgmres(*args, rtol=rtol, **kw)

    def fused(*args):
        seen["fused"] += 1
        return real_fused(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttimeloop, "newton_solve", solve)
        mp.setattr(tnewton, "fgmres", fgmres)
        mp.setattr(tgmg, "_fused_correction", fused)
        tsim = case.simulator()
        tres = tsim.run(case.t_end, max_steps=STEPS,
                        callback=lambda i, t, u, r: seen.setdefault("states", []).append(u))
    return jsim, jres, tsim, tres, seen


def test_simulator_matches_the_reference(runs):
    """Identical baked schedules, accepted Δt, Newton and FGMRES counts,
    retries, next Δt and failure-memory caps per step, and states within
    1e-8 of each equation's largest value."""
    jsim, jres, tsim, tres, _ = runs
    for name in ("gmg", "gmg_t"):
        assert (getattr(tsim.pc_cfg, name).level_factors
                == getattr(jsim.pc_cfg, name).level_factors)
    assert len(tsim.pc_cfg.gmg.level_factors) >= 3
    assert [_record(r) for r in tres.records] == [_record(r) for r in jres.records]
    assert (tres.steps, tres.t, tres.total_newton, tres.total_ksp) == (
        jres.steps, jres.t, jres.total_newton, jres.total_ksp)
    # the forced failure: one retry, and the cap it leaves behind
    assert sum(r.retries for r in tres.records) >= 1
    assert tres.records[-1].dt_cap is not None
    ju, tu = np.asarray(jres.u), state_to_numpy(tres.u)
    scale = np.abs(ju).max(axis=(1, 2, 3), keepdims=True)
    assert (np.abs(tu - ju) <= 1e-8 * scale).all()


def test_newton_options_ran(runs):
    """The parity above covers the Appleyard chop, Eisenstat–Walker forcing
    and the fused coarse subtree: each of them acted in the port's run."""
    *_, seen = runs
    assert seen["chopped"] > 0
    rtols = seen["rtols"]
    assert len(set(rtols)) > 2 and min(rtols) >= 1e-2 and max(rtols) <= 0.9
    assert seen["fused"] > 0


def test_dt_cap_seeds_and_resumes(runs):
    """A run resumed from the third record (state, clock, Δt and cap)
    repeats the fourth step exactly."""
    _, _, tsim, tres, seen = runs
    third = tres.records[2]
    again = tsim.run(30 * 86400.0, u0=seen["states"][2], dt0=third.next_dt, t0=third.t,
                     step0=third.step, max_steps=4, dt_cap0=third.dt_cap)
    assert [_record(r) for r in again.records] == [_record(tres.records[3])]
    assert torch.equal(again.u, tres.u)


def test_time_config_and_interop_refuse_what_is_not_ported():
    with pytest.raises(NotImplementedError):
        TimeConfig(block_steps=4)
    assert ({f.name for f in dataclasses.fields(TimeConfig)}
            == {f.name for f in dataclasses.fields(JTimeConfig)})
    # a reference field the port lacks passes at its default only
    jpc = dataclasses.asdict(JCPRConfig())
    assert config_from_dict(CPRConfig, jpc) == CPRConfig()
    with pytest.raises(ValueError):
        config_from_dict(CPRConfig, dict(jpc, inner_iters=2))
    with pytest.raises(ValueError):
        config_from_dict(GMGConfig, dict(dataclasses.asdict(JGMGConfig()), smoother="jacobi"))
    assert config_from_dict(NewtonConfig, dataclasses.asdict(JNewtonConfig())) == NewtonConfig()


@pytest.mark.skipif(torch.cuda.is_available(), reason="this process has a CUDA device")
def test_make_step_fn_defaults_to_cuda():
    case = tpre.get_case("tp_spe10_full", device="cpu", dtype=F64, shape=(6, 8, 3))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        make_step_fn(case.model)
    make_step_fn(case.model, device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="this process has a CUDA device")
def test_entry_points_default_to_cuda():
    """Simulator and get_case, given no device, ask for the card."""
    case = tpre.get_case("tp_spe10_full", device="cpu", dtype=F64, shape=(6, 8, 3))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Simulator(case.model, case.data)
    for name, kw in (("tp_spe10_full", dict(shape=(6, 8, 3))), ("tp_thermal_2d", dict(n=8)),
                     ("tp_spe10_3d", dict(nx=6, ny=8, nz=3))):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            tpre.get_case(name, **kw)


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a process where ``jax`` and
    ``thermalporous_tpu`` cannot be imported."""
    modules = sorted(
        ".".join(("thermalporous_torch",) + p.relative_to(PORT_DIR).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT_DIR.rglob("*.py"))
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'thermalporous_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "print('imported', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PORT_DIR.parent)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout
    assert len(modules) > 20
