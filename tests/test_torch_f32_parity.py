"""Port parity at the production dtype (CPU): the 16×16 benchmark step and
the 8×14×6 flagship configuration in f32 (f32 state and kernels, f64
reductions), with a working-dtype and with a bf16 Krylov basis, through both
packages from the same numpy inputs.

The two packages' f32 arithmetic rounds at different places (XLA fuses and
reorders elementwise chains, the port runs them op by op), so the runs are
not bitwise and are held to bands:

- Newton iterations per step: identical;
- FGMRES iterations: within ``KSP_STEP_BAND`` per step and
  ``KSP_TOTAL_BAND`` of the reference's total;
- the true residual of each step's final state, F(u_k; u_{k−1}, Δt_k)
  evaluated in f64 by the reference model and scaled as its Newton test
  scales it (``residual_scales``, root mean square): within a factor
  ``NORM_RATIO`` of the reference's, and both under the Newton test's
  threshold.  Never the FGMRES Givens estimate, which drifts in f32 and
  floors near 4e-3 with a bf16 basis (``solve/fgmres.py``);
- the final states: within ``STATE_RTOL`` of each equation's largest value.

Cut to size as ``tests/test_torch_step.py`` (bench step: three steps from
600 s, ``max_coarse_cells=16``) and ``tests/test_torch_simulator.py``
(flagship: ``max_coarse_cells=8``, K-cycles from 64 cells, the subtree fused
below 100 cells; here the preset's own Newton settings and two controller
steps), so that the flagship's rbgs stage 2 runs the stage-2 kernel's plain
version in f32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thermalporous_torch.core as tc
import thermalporous_torch.models as tm
import thermalporous_torch.physics as tp
from tests.test_torch_simulator import SHAPE, SMALL_GMG
from thermalporous_torch import presets as tpre
from thermalporous_torch.interop import case_from_numpy, state_to_numpy
from thermalporous_torch.kernels import launch_counts, reset_launch_counts, wrappers
from thermalporous_torch.precond import CPRConfig, GMGConfig
from thermalporous_torch.solve import NewtonConfig, make_step_fn
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
from thermalporous_tpu.solve import make_step_fn as j_make_step_fn

torch.set_num_threads(1)

KSP_STEP_BAND = 2
KSP_TOTAL_BAND = 0.1
NORM_RATIO = 2.0
STATE_RTOL = 1e-4

# ------------------------------------------------------------ bench step

N = 16
BENCH_NEWTON = dict(rtol=1e-4, atol=2e-5, ksp_rtol=1e-2, ksp_maxiter=24, max_iters=14,
                    pc_lag="every", krylov_op="stencil", ksp_orth="cgs2g")
GMG_P = dict(cycle_type="k", max_coarse_cells=16, degree=4)
GMG_T = dict(cycle_type="v", max_coarse_cells=16, degree=2)


def _bench_inputs():
    rng = np.random.default_rng(11)
    kx = 2e-13 * np.exp(0.5 * rng.standard_normal((N, N)))
    wells = [dict(cells=((0, 0),), control="bhp", p_bh=4.0e7, T_inj=420.0),
             dict(cells=((N - 1, N - 1),), control="bhp", p_bh=1.0e7)]
    return kx, wells


def _bench_jax(dtype):
    kx, wells = _bench_inputs()
    g = JGrid(shape=(N, N), spacing=(5.0, 5.0), thickness=10.0)
    pp = JPhysicalParams()
    data = j_make_problem_data(g, pp, kx=kx, phi=0.2, wells=[JWell(**w) for w in wells],
                               dtype=dtype)
    return JTwoPhaseModel(g, pp, s_init=0.2), data


def _bench_runs(basis: str):
    """Three steps (600 s, then doubling) of each package in f32: per step
    (Newton, FGMRES, state before, state after, Δt)."""
    model, data = _bench_jax(jnp.float32)
    pc = JCPRConfig(stage2_cols=True, gmg=JGMGConfig(**GMG_P), gmg_t=JGMGConfig(**GMG_T))
    step = jax.jit(j_make_step_fn(model, "cptr", JNewtonConfig(ksp_basis=basis, **BENCH_NEWTON),
                                  pc))
    u, dt, jout = model.initial_state(data, dtype=jnp.float32), 600.0, []
    for _ in range(3):
        u_new, st = step(u, jnp.asarray(dt, jnp.float32), data)
        st = jax.device_get(st)
        assert bool(st.converged)
        jout.append((int(st.iters), int(st.ksp_iters), np.asarray(u), np.asarray(u_new), dt))
        u, dt = u_new, 2.0 * dt

    kx, wells = _bench_inputs()
    g = tc.Grid(shape=(N, N), spacing=(5.0, 5.0), thickness=10.0)
    pp = tp.PhysicalParams()
    tdata = tm.make_problem_data(g, pp, kx=kx, phi=0.2, wells=[tp.Well(**w) for w in wells],
                                 dtype=torch.float32, device="cpu")
    tmodel = tm.TwoPhaseModel(g, pp, s_init=0.2)
    tpc = CPRConfig(stage2_cols=True, gmg=GMGConfig(**GMG_P), gmg_t=GMGConfig(**GMG_T))
    tstep = make_step_fn(tmodel, "cptr", NewtonConfig(ksp_basis=basis, **BENCH_NEWTON), tpc,
                         device="cpu")
    u, dt, tout = tmodel.initial_state(tdata), 600.0, []
    assert u.dtype == torch.float32
    for _ in range(3):
        u_new, st = tstep(u, dt, tdata)
        assert st.converged and not st.failed
        tout.append((st.iters, st.ksp_iters, state_to_numpy(u), state_to_numpy(u_new), dt))
        u, dt = u_new, 2.0 * dt
    model64, data64 = _bench_jax(jnp.float64)
    return jout, tout, model64, data64, BENCH_NEWTON


# -------------------------------------------------------------- flagship

def _flagship_jax(dtype):
    nx, ny, nz = SHAPE
    fields = synthetic_spe10(shape=SHAPE, seed=2020)
    g = JGrid(shape=SHAPE, spacing=SPE10_SPACING_M, gravity=9.81, depth_top=3600.0 * 0.3048)
    wells = [JWell(cells=w.cells, control=w.control, p_bh=w.p_bh, T_inj=w.T_inj, name=w.name)
             for w in tpre._flagship_wells(nx, ny, nz)]
    pp = JPhysicalParams()
    data = j_make_problem_data(g, pp, kx=fields.kx, ky=fields.ky, kz=fields.kz,
                               phi=fields.phi, wells=wells, dtype=dtype)
    return g, pp, JTwoPhaseModel(g, pp, s_init=0.15), data


FLAGSHIP_STEPS = 2


def _flagship_runs(basis: str, pc_dtype: str = "f32"):
    """Each package's Simulator on the flagship configuration in f32 (with
    ``pc_dtype`` coefficient storage) for FLAGSHIP_STEPS controller steps:
    per step (Newton, FGMRES, state before, state after, Δt)."""
    time_cfg, newton_cfg, pc_cfg = tpre.flagship_configs()
    gmg = lambda g, **kw: JGMGConfig(**dict(dataclasses.asdict(g), **SMALL_GMG, **kw))
    pc = dataclasses.asdict(pc_cfg)
    pc.update(gmg=gmg(pc_cfg.gmg, kcycle_min_cells=64), gmg_t=gmg(pc_cfg.gmg_t),
              pc_dtype=pc_dtype)
    jtime = JTimeConfig(**dataclasses.asdict(time_cfg))
    jnewton = JNewtonConfig(**dict(dataclasses.asdict(newton_cfg), ksp_basis=basis))
    jpc = JCPRConfig(**pc)
    g, pp, model, data = _flagship_jax(jnp.float32)

    def collect(states):
        return lambda i, t, u, rec: states.append(
            (rec.newton_iters, rec.ksp_iters, rec.dt, rec.retries,
             np.asarray(u) if isinstance(u, jax.Array) else state_to_numpy(u)))

    jstates = []
    u0 = model.initial_state(data, dtype=jnp.float32)
    JSimulator(model, data, "cptr", jpc, jnewton, jtime).run(
        30 * 86400.0, u0=u0, max_steps=FLAGSHIP_STEPS, callback=collect(jstates))

    w = data.wells
    arrays = dict(tgeo=[np.asarray(a) for a in data.tgeo],
                  tcond=[np.asarray(a) for a in data.tcond], phi=np.asarray(data.phi),
                  wi=np.asarray(w.wi), pbh=np.asarray(w.pbh), tinj=np.asarray(w.tinj),
                  has_tinj=np.asarray(w.has_tinj), qrate=np.asarray(w.qrate),
                  qheat=np.asarray(w.qheat))
    case = case_from_numpy(
        grid=dataclasses.asdict(g), params=dataclasses.asdict(pp),
        relperm=dataclasses.asdict(model.relperm), s_init=model.s_init, data=arrays,
        newton=dataclasses.asdict(jnewton), pc=dataclasses.asdict(jpc),
        time=dataclasses.asdict(jtime), t_end=30 * 86400.0, dtype=torch.float32, device="cpu")
    tstates = []
    case.simulator().run(case.t_end, max_steps=FLAGSHIP_STEPS, callback=collect(tstates))

    def steps(states, first):
        out, prev = [], first
        for newton, ksp, dt, retries, u in states:
            assert retries == 0
            out.append((newton, ksp, prev, u, dt))
            prev = u
        return out

    first = np.asarray(u0)
    _, _, model64, data64 = _flagship_jax(jnp.float64)
    return (steps(jstates, first), steps(tstates, first), model64, data64,
            dataclasses.asdict(newton_cfg))


# ------------------------------------------------------------- the check

def true_norm(model64, data64, u_old, u, dt) -> float:
    """The scaled residual norm of the reference's Newton test, in f64, of
    state ``u`` one step of ``dt`` after ``u_old``."""
    u_old, u = jnp.asarray(u_old, jnp.float64), jnp.asarray(u, jnp.float64)
    f = model64.residual(u, u_old, dt, data64)
    q = f / model64.residual_scales(u_old, dt, data64)
    return float(jnp.sqrt(jnp.sum(q * q) / q.size))


@pytest.mark.parametrize("basis", ["same", "bf16"])
@pytest.mark.parametrize("case", ["bench_step", "flagship"])
def test_f32_runs_match_the_reference(case, basis):
    runs = _bench_runs if case == "bench_step" else _flagship_runs
    check_f32_runs(*runs(basis))


def check_f32_runs(jout, tout, model64, data64, newton) -> None:
    """The bands of the module docstring, step by step, and no launch (the
    port ran on the CPU)."""
    assert len(tout) == len(jout) >= 2
    assert [s[0] for s in tout] == [s[0] for s in jout]
    for (_, jk, *_), (_, tk, *_) in zip(jout, tout):
        assert abs(tk - jk) <= KSP_STEP_BAND
    jk_total = sum(s[1] for s in jout)
    assert abs(sum(s[1] for s in tout) - jk_total) <= KSP_TOTAL_BAND * jk_total
    threshold = max(newton["atol"], 50.0 * float(np.finfo(np.float32).eps))
    for (_, _, ju_old, ju, dt), (_, _, tu_old, tu, tdt) in zip(jout, tout):
        assert tdt == dt
        jn = true_norm(model64, data64, ju_old, ju, dt)
        tn = true_norm(model64, data64, tu_old, tu, dt)
        assert 1.0 / NORM_RATIO <= tn / jn <= NORM_RATIO, (tn, jn)
        # converged: under the atol floor of the scaled test, or the rtol
        # target anchored on the step start, as the reference decides
        start = true_norm(model64, data64, ju_old, ju_old, dt)
        assert max(jn, tn) <= max(threshold, newton["rtol"] * start), (jn, tn, start)
    ju, tu = jout[-1][3], tout[-1][3]
    scale = np.abs(ju).reshape(ju.shape[0], -1).max(axis=1)
    err = np.abs(tu - ju).reshape(ju.shape[0], -1).max(axis=1)
    assert (err <= STATE_RTOL * scale).all(), err / scale
    # the port ran on the CPU: no kernel launched
    assert launch_counts() == {name: 0 for name in wrappers()}
    reset_launch_counts()
