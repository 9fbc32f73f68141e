"""Port parity of the CPR / CPTR options (f64, CPU) against the JAX package.

- ``cpr_apply`` under each option on one two-phase Jacobian (a 3D 6×5×4
  grid, nc = 3): each decoupling, the CPR variant, the block-diagonal stage
  1, inner FGMRES and Richardson iterations, each saturation stage, each
  stage 2 (zebra along every axis), the premasked rbgs sweep with and
  without a sparsified coupling — at 1e-12 of the reference's largest
  value.  The reference's continuation sweeps after a premasked sweep take
  the full coupling whatever ``stage2_axes`` says; the port copies that and
  a test pins it.
- One Newton step per option (options that do not interact share a step)
  on the 6×6 two-phase case of
  ``tests/test_newton_cptr.py`` (stage 2 ``"none"``: the single-phase
  case, see the test) through both packages' ``Simulator.step``
  (``tests/_torch_parity.py:newton_option_parity``): identical Newton and
  FGMRES counts, states within 1e-8, and within the reference's oracle
  bound of the port's oracle.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import (
    OPTION_GMG,
    assert_close,
    carry_model_data,
    model_case,
    newton_option_parity,
    t,
    torch_block,
)
from tests.test_newton_cptr import _sp_case, _tp_case
from thermalporous_torch.interop import config_from_dict
from thermalporous_torch.precond import cpr as tcpr
from thermalporous_torch.precond.chebyshev import block_red_black_gauss_seidel
from thermalporous_torch.precond.chebyshev import block_rbgs_fused_zero
from thermalporous_torch.kernels import stencil as kst
from thermalporous_torch.solve.oracle import oracle_run
from thermalporous_tpu.precond import cpr as jcpr
from thermalporous_tpu.precond import gmg as jgmg

torch.set_num_threads(1)

RTOL = 1e-12


@pytest.fixture(scope="module")
def system():
    """The assembled Jacobian of a 3D two-phase model case and a right-hand
    side, in both packages."""
    c = model_case((6, 5, 4), seed=7)
    js = jax.jit(c["jm"].assemble_stencil)(c["ju"], c["ju0"], c["dt"], c["jd"])
    rhs = -np.asarray(c["jm"].residual(c["ju"], c["ju0"], c["dt"], c["jd"]))
    return js, torch_block(js), rhs


def _configs(**kw):
    jcfg = jcpr.CPRConfig(**kw, gmg=jgmg.GMGConfig(**OPTION_GMG),
                          gmg_t=jgmg.GMGConfig(**dict(OPTION_GMG, cycle_type="v")))
    return jcfg, config_from_dict(tcpr.CPRConfig, dataclasses.asdict(jcfg))


APPLY_OPTIONS = [
    dict(decoupling="qimpes"), dict(decoupling="timpes"), dict(decoupling="abf"),
    dict(variant="cpr"), dict(variant="cpr", stage2="rbgs", stage2_cols=False),
    dict(triangular=False), dict(inner_iters=2),
    dict(inner_iters=3, inner_method="richardson", stage2="rbgs"),
    dict(s_stage="rbgs"), dict(s_stage="jacobi", s_sweeps=3),
    dict(s_stage="zebra", s_axis=2), dict(s_stage="line", s_axis=1, stage2="rbgs"),
    dict(stage2="none"), dict(stage2="block_jacobi"), dict(stage2="jacobi2", stage2_omega=0.7),
    dict(stage2="rbgs", stage2_sweeps=2), dict(stage2="rbgs", stage2_axes=(0, 2),
                                              stage2_sweeps=2),
    dict(stage2="rbgs", stage2_fused=True),
    dict(stage2="rbgs", stage2_fused=True, stage2_axes=(2,)),
    dict(stage2="zebra", stage2_axis=0), dict(stage2="zebra", stage2_axis=1,
                                             stage2_sweeps=2),
    dict(stage2="zebra", stage2_axis=2, stage2_omega=0.8),
    dict(inner_iters=2, s_stage="rbgs", stage2="zebra", decoupling="timpes"),
]


@pytest.mark.parametrize("kw", APPLY_OPTIONS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_cpr_apply_option(system, kw):
    js, ts, rhs = system
    jcfg, tcfg = _configs(**kw)
    jset, japply = jcpr.make_preconditioner(jcfg.variant, jcfg)
    tset, tapply = tcpr.make_preconditioner(tcfg.variant, tcfg)
    jstate, tstate = jax.jit(jset)(js), tset(ts)
    assert_close(tstate.w, jstate.w, RTOL, 1e-15)
    assert_close(tcpr._decoupling_weights(ts, tcfg),
                 jcpr._decoupling_weights(js, jcfg), RTOL, 1e-15)
    ref = jax.jit(japply)(jstate, jnp.asarray(rhs))
    assert_close(tapply(tstate, t(rhs)), ref, RTOL, 1e-13)


def test_fused_stage2_continuation_ignores_the_axes(system):
    """The reference's quirk, copied: with ``stage2_fused`` the sweeps after
    the first take the full coupling, while the looped form restricts every
    sweep to ``stage2_axes``.  Both forms match the reference, and they
    differ from each other."""
    js, ts, rhs = system
    axes = (2,)
    outs = {}
    for fused in (True, False):
        jcfg, tcfg = _configs(stage2="rbgs", stage2_fused=fused, stage2_axes=axes,
                              stage2_sweeps=2)
        jstate, tstate = jax.jit(lambda s: jcpr.cpr_setup(s, jcfg))(js), tcpr.cpr_setup(ts, tcfg)
        ref = jax.jit(lambda s, r: jcpr.cpr_apply(s, r, jcfg))(jstate, jnp.asarray(rhs))
        outs[fused] = tcpr.cpr_apply(tstate, t(rhs), tcfg)
        assert_close(outs[fused], ref, RTOL, 1e-13)
    assert not torch.allclose(outs[True], outs[False], rtol=1e-6)
    # the fused form is the premasked sweep with the axes, then one
    # full-coupling sweep from it, on the same stage-2 residual
    _, tcfg = _configs(stage2="rbgs", stage2_fused=True, stage2_axes=axes, stage2_sweeps=2)
    st = tcpr.cpr_setup(ts, tcfg)
    w = tcpr.apply_blocks(st.w, t(rhs))
    x1 = tcpr._stage1(st, w, tcfg)
    r2 = t(rhs) - ts.matvec_cols(x1, 2)
    x2 = block_rbgs_fused_zero(ts, st.dinv_red, st.dinv_black, r2, axes=axes)
    x2 = block_red_black_gauss_seidel(ts, st.dinv, r2, x=x2, sweeps=1)
    x2[0:2] += x1
    assert torch.equal(outs[True], x2)


def test_stage2_routes(system):
    """Which form each rbgs configuration takes: the one-launch stage 2 with
    the full coupling and one sweep (fused or not), the plain sparsified
    forms with axes; the premasked halves are built only where they are
    used."""
    js, ts, rhs = system
    seen = []
    real = kst.fused_stage2_rbgs

    def spy(coef, dinv, r, x1):
        seen.append(x1.shape[0])
        return real(coef, dinv, r, x1)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kst, "fused_stage2_rbgs", spy)
        for kw, k in ((dict(), 2), (dict(stage2_fused=True), 2), (dict(stage2_cols=False), 3),
                      (dict(variant="cpr"), 1), (dict(s_stage="jacobi"), 3),
                      (dict(stage2_axes=(2,)), None)):
            _, tcfg = _configs(stage2="rbgs", **kw)
            st = tcpr.cpr_setup(ts, tcfg)
            assert (st.dinv_red is None) == (not (tcfg.stage2_fused and tcfg.stage2_axes))
            seen.clear()
            tcpr.cpr_apply(st, t(rhs), tcfg)
            assert seen == ([] if k is None else [k])


# ------------------------------------------------------------ Newton steps

@pytest.fixture(scope="module")
def tp6():
    """The 6×6 two-phase case in both packages and the port's oracle state
    one step on."""
    jm, jd = _tp_case(n=6)
    tm, td = carry_model_data(jm, jd)
    return jm, jd, tm, td, oracle_run(tm, td, [3600.0])[0]


@pytest.fixture(scope="module")
def sp6():
    """The same for the 6×6 single-phase case."""
    jm, jd = _sp_case(n=6)
    tm, td = carry_model_data(jm, jd)
    return jm, jd, tm, td, oracle_run(tm, td, [3600.0])[0]


# options that do not interact share a step (each reference step costs a
# JAX compile of the whole Newton loop)
NEWTON_OPTIONS = [
    ("cptr", dict(decoupling="timpes", s_stage="rbgs")),
    ("cptr", dict(decoupling="abf", s_stage="jacobi")),
    ("cptr", dict(variant="cpr", stage2="jacobi2")),
    ("cptr", dict(triangular=False, s_stage="zebra", s_axis=1)),
    ("cptr", dict(inner_iters=2, s_stage="line")),
    ("cptr", dict(inner_iters=2, inner_method="richardson", stage2="zebra")),
    ("cptr", dict(stage2="none")),
    ("cptr", dict(stage2="rbgs", stage2_sweeps=2)),
    ("cptr", dict(stage2="rbgs", stage2_fused=True)),
    ("cptr", dict(stage2="rbgs", stage2_fused=True, stage2_axes=(0,), stage2_sweeps=2)),
    ("cpr", dict(stage2="rbgs")), ("rbgs", None), ("lu", None),
]


@pytest.mark.parametrize("precond,pc", NEWTON_OPTIONS, ids=lambda v: str(v))
def test_newton_step_option(tp6, sp6, precond, pc):
    # with no stage 2 the two-phase preconditioner never touches the
    # saturation (x₁ has no S component), so no Krylov solve converges in
    # either package: that option runs on the single-phase case, where
    # stage 1 covers both unknowns
    none = pc is not None and pc.get("stage2") == "none"
    jm, jd, tm, td, oracle = sp6 if none else tp6
    _, tst = newton_option_parity(jm, jd, tm, td, oracle, precond=precond, pc=pc)
    if precond == "lu":
        assert tst.ksp_iters == tst.iters        # the exact inverse: one iteration each
