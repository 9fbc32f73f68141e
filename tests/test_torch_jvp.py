"""Port parity of the matrix-free Krylov operator (f64, CPU): ``model.jvp``
and the ``fused_jvp`` kernel's plain path for both models, the saturation
clip's tie rule, and whole steps with ``krylov_op="jvp"`` against the JAX
package's ``make_step_fn(..., fuse=False)``.

The steps: the benchmark step at 16×16 (``tests/test_torch_step.py``'s
configuration), the flagship configuration at 8×14×6 and
``sp_hot_injection_2d`` at 8×8 through each package's ``Simulator``
(``tests/test_torch_simulator.py``'s and ``tests/test_torch_singlephase.py``'s
cuts), three steps each.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_torch_simulator as tsim_case
from tests import test_torch_singlephase as tsp_case
from tests import test_torch_step as tstep_case
from tests._torch_parity import (
    F64,
    PORT_DIR,
    assert_close,
    forbidden_imports,
    model_case,
    n,
    t,
    torch_block,
)
from thermalporous_torch.kernels import launch_counts
from thermalporous_torch.kernels.residual import fused_jvp
from thermalporous_torch.models import ProblemData
from thermalporous_torch.physics import CoreyRelPerm
from thermalporous_torch.solve import NewtonConfig, make_step_fn, newton_solve
from thermalporous_tpu import presets as jpre
from thermalporous_tpu.core import Grid as JGrid
from thermalporous_tpu.kernels.residual_pallas import fused_jvp as j_fused_jvp
from thermalporous_tpu.models import TwoPhaseModel as JTwoPhaseModel
from thermalporous_tpu.models import make_problem_data as j_make_problem_data
from thermalporous_tpu.physics import CoreyRelPerm as JCoreyRelPerm
from thermalporous_tpu.physics import PhysicalParams as JPhysicalParams
from thermalporous_tpu.physics import Well as JWell
from thermalporous_tpu.precond import CPRConfig as JCPRConfig
from thermalporous_tpu.precond import GMGConfig as JGMGConfig
from thermalporous_tpu.solve import NewtonConfig as JNewtonConfig
from thermalporous_tpu.solve import Simulator as JSimulator
from thermalporous_tpu.solve import make_step_fn as j_make_step_fn

torch.set_num_threads(1)

RTOL = 1e-12


@pytest.fixture(scope="module", params=[("tp", (8, 6)), ("tp", (5, 4, 6)),
                                        ("sp", (8, 6)), ("sp", (5, 4, 6))],
                ids=["tp-2d", "tp-3d", "sp-2d", "sp-3d"])
def case(request):
    kind, shape = request.param
    return model_case(shape, single_phase=kind == "sp")


def test_jvp_matches_the_reference(case):
    """``model.jvp`` and the plain ``fused_jvp`` against the reference's
    ``model.jvp`` and its Pallas ``fused_jvp`` (interpret mode)."""
    c = case
    jm, jd, ju, ju0, dt = c["jm"], c["jd"], c["ju"], c["ju0"], c["dt"]
    v = c["v"]
    ref = jm.jvp(ju, ju0, dt, jd)(jnp.asarray(v))
    pallas = j_fused_jvp(jm, ju, jnp.asarray(v), ju0, dt, jd, interpret=True)
    assert_close(pallas, ref, RTOL, 1e-12)
    tv = t(v)
    got = c["tm"].jvp(c["tu"], c["tu0"], dt, c["td"])(tv)
    assert_close(got, ref, RTOL, 1e-12)
    assert_close(fused_jvp(c["tm"], c["tu"], tv, c["tu0"], dt, c["td"]), pallas, RTOL, 1e-12)
    # J·v is the stencil's product: one Jacobian, two operators
    st = c["tm"].assemble_stencil(c["tu"], c["tu0"], dt, c["td"])
    assert_close(st.matvec(tv), got, 1e-10, 1e-12)


# --------------------------------------------------------------- tie rule

def _tie_case():
    """The two-phase test problem with saturations at exactly 0 and 1 in
    several cells, the injector's and the producer's among them."""
    c = model_case((6, 5), seed=4)
    s = np.array(c["ju"][2])
    s[0, 0] = 0.0
    s[5, 4] = 1.0
    s[2, 1:4] = [0.0, 1.0, 0.0]
    s[4, 2] = 1.0
    ju = c["ju"].at[2].set(jnp.asarray(s))
    return c, ju, t(ju)


def test_relperm_tangents_at_the_clip_bounds():
    """d/dS of k_rw and k_ro at S = 0, ½, 1: half the tangent at the
    bounds, as JAX's clip gives (``torch.clamp`` would give all of it)."""
    jr, tr = JCoreyRelPerm(), CoreyRelPerm()
    s = np.array([0.0, 0.5, 1.0])
    for name in ("krw", "kro", "effective_saturation"):
        jf, tf = getattr(jr, name), getattr(tr, name)
        ref = jax.jvp(jf, (jnp.asarray(s),), (jnp.ones(3),))[1]
        got = torch.func.jvp(tf, (t(s),), (torch.ones(3, dtype=F64),))[1]
        assert np.array_equal(n(got), np.asarray(ref)), name
    got = torch.func.jvp(tr.kro, (t(s[:1]),), (torch.ones(1, dtype=F64),))[1]
    assert float(got[0]) == -1.0


def test_stencil_and_jvp_at_saturation_bounds():
    c, ju, tu = _tie_case()
    jm, jd, dt = c["jm"], c["jd"], c["dt"]
    js = jax.jit(jm.assemble_stencil)(ju, c["ju0"], dt, jd)
    ts = c["tm"].assemble_stencil(tu, c["tu0"], dt, c["td"])
    assert_close(ts.coef, torch_block(js).coef, RTOL, 1e-14)
    v = c["v"]
    ref = jm.jvp(ju, c["ju0"], dt, jd)(jnp.asarray(v))
    got = fused_jvp(c["tm"], tu, t(v), c["tu0"], dt, c["td"])
    assert_close(got, ref, RTOL, 1e-12)


# ------------------------------------------------------- steps with JVP

def test_bench_step_with_jvp_operator():
    """The 16×16 benchmark step, three steps: identical Newton and FGMRES
    counts and states within 1e-8 (the moved ``krylov_op="jvp"`` case of
    the step's unported-options test)."""
    kx, wells = tstep_case._problem()
    N = tstep_case.N
    g = JGrid(shape=(N, N), spacing=(5.0, 5.0), thickness=10.0)
    pp = JPhysicalParams()
    jdata = j_make_problem_data(g, pp, kx=kx, phi=0.2, wells=[JWell(**w) for w in wells])
    jmodel = JTwoPhaseModel(g, pp, s_init=0.2)
    kw = dict(tstep_case.NEWTON_KW, krylov_op="jvp")
    jpc = JCPRConfig(stage2_cols=True, gmg=JGMGConfig(**tstep_case.GMG_P),
                     gmg_t=JGMGConfig(**tstep_case.GMG_T))
    jstep = jax.jit(j_make_step_fn(jmodel, "cptr", JNewtonConfig(ksp_basis="same", **kw),
                                   jpc, fuse=False))
    model, data, step = tstep_case._torch_step("same", krylov_op="jvp")
    ju, tu, dt = jmodel.initial_state(jdata), model.initial_state(data), tstep_case.DT0
    counts = []
    for _ in range(3):
        ju, jst = jstep(ju, jnp.asarray(dt), jdata)
        tu, tst = step(tu, dt, data)
        assert bool(jst.converged) and tst.converged and not tst.failed
        counts.append((tst.iters, tst.ksp_iters))
        assert counts[-1] == (int(jst.iters), int(jst.ksp_iters))
        scale = np.abs(np.asarray(ju)).max(axis=(1, 2), keepdims=True)
        assert (np.abs(n(tu) - np.asarray(ju)) <= 1e-8 * scale).all()
        dt *= 2.0
    assert sum(k for _, k in counts) >= 8


def _flagship_jvp_runs():
    time_cfg, newton_cfg, pc_cfg = tsim_case._jax_configs()
    newton_cfg = dataclasses.replace(newton_cfg, krylov_op="jvp")
    g, pp, model, data = tsim_case._jax_case()
    jsim = JSimulator(model, data, "cptr", pc_cfg, newton_cfg, time_cfg)
    jres = jsim.run(30 * 86400.0, max_steps=3)
    case = tsim_case._carry(g, pp, model, data, time_cfg, newton_cfg, pc_cfg)
    return jres, case.simulator().run(case.t_end, max_steps=3)


def _sp_jvp_runs():
    jcase = jpre.get_case("sp_hot_injection_2d", n=8)
    jcase = dataclasses.replace(
        jcase, newton_cfg=dataclasses.replace(jcase.newton_cfg, krylov_op="jvp"))
    pc = tsp_case._cut(jcase.pc_cfg)
    jsim = JSimulator(jcase.model, jcase.data, "cptr", pc, jcase.newton_cfg, jcase.time_cfg)
    jres = jsim.run(jcase.t_end, max_steps=3)
    tcase = tsp_case._carry(jcase, pc)
    assert tcase.newton_cfg.krylov_op == "jvp"
    return jres, tcase.simulator().run(tcase.t_end, max_steps=3)


@pytest.mark.parametrize("runs", [_flagship_jvp_runs, _sp_jvp_runs],
                         ids=["flagship-8x14x6", "sp_hot_injection_2d-8x8"])
def test_simulator_with_jvp_operator(runs):
    """Identical accepted Δt, Newton and FGMRES counts and retries per step,
    states within 1e-8 of each equation's largest value; every wrapper took
    its plain path."""
    jres, tres = runs()
    rec = lambda r: (r.step, r.t, r.dt, r.newton_iters, r.ksp_iters, r.retries, r.next_dt)
    assert [rec(r) for r in tres.records] == [rec(r) for r in jres.records]
    assert tres.total_ksp > 0
    ju, tu = np.asarray(jres.u), n(tres.u)
    nc = ju.shape[0]
    scale = np.abs(ju).reshape(nc, -1).max(axis=1).reshape((nc,) + (1,) * (ju.ndim - 1))
    assert (np.abs(tu - ju) <= 1e-8 * scale).all()
    assert launch_counts()["fused_jvp"] == launch_counts()["fused_jvp_sp"] == 0


def test_jvp_operator_is_used_and_needs_jvp_at(monkeypatch):
    """With krylov_op="jvp" FGMRES multiplies by fused_jvp, never by the
    stencil; "stencil_pallas" is the stencil; newton_solve refuses "jvp"
    without jvp_at."""
    from thermalporous_torch.core.stencil import BlockStencil
    from thermalporous_torch.solve import timeloop as ttimeloop

    calls = {"jvp": 0, "stencil": 0}
    real_jvp, real_mv = ttimeloop.fused_jvp, BlockStencil.matvec

    def counted_jvp(*args):
        calls["jvp"] += 1
        return real_jvp(*args)

    def counted_mv(self, v):
        calls["stencil"] += 1
        return real_mv(self, v)

    monkeypatch.setattr(ttimeloop, "fused_jvp", counted_jvp)
    monkeypatch.setattr(BlockStencil, "matvec", counted_mv)
    for op in ("jvp", "stencil_pallas"):
        calls.update(jvp=0, stencil=0)
        model, data, step = tstep_case._torch_step("same", krylov_op=op)
        _, st = step(model.initial_state(data), tstep_case.DT0, data)
        assert st.converged and st.ksp_iters > 0
        if op == "jvp":
            assert calls["jvp"] == st.ksp_iters and calls["stencil"] == 0
        else:
            assert calls["jvp"] == 0 and calls["stencil"] >= st.ksp_iters
    with pytest.raises(ValueError, match="jvp_at"):
        newton_solve(lambda u: u, lambda u: None, lambda s: None, lambda s, r: r,
                     torch.ones(3, dtype=F64), NewtonConfig(krylov_op="jvp"))


def test_fused_jvp_off_the_cpu():
    """A request for the card without one raises; tensors that are neither
    on the CPU nor on the card are refused; the CPU runs launched nothing."""
    c = model_case((4, 3), seed=2, single_phase=True)
    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA device")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        make_step_fn(c["tm"], newton_cfg=NewtonConfig(krylov_op="jvp"))
    meta = lambda x: torch.empty_like(x, device="meta")
    with pytest.raises(ValueError):
        fused_jvp(c["tm"], meta(c["tu"]), meta(c["tu"]), meta(c["tu0"]), 1.0,
                  ProblemData(meta(c["td"].fields)))
    with pytest.raises(ValueError):       # a direction of the wrong shape
        fused_jvp(c["tm"], c["tu"], c["tu"][:1].contiguous(), c["tu0"], 1.0, c["td"])
    assert launch_counts()["fused_jvp"] == launch_counts()["fused_jvp_sp"] == 0


def test_chip_smoke_imports_no_jax():
    """The card's driver script imports neither jax nor the JAX package."""
    script = PORT_DIR.parent / "chip_smoke.py"
    assert forbidden_imports(script) == []
    assert "fused_jvp" in script.read_text()
