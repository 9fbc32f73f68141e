"""Port parity: FGMRES, geometric multigrid and the CPR/CPTR preconditioner
against the JAX package on a two-phase stencil system (12×12, nc = 3, f64,
CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thermalporous_torch.core as tc
from tests._torch_parity import assert_close, model_case, n, t, torch_block, torch_scalar
from thermalporous_torch.precond import cpr as tcpr
from thermalporous_torch.precond import gmg as tgmg
from thermalporous_torch.solve.fgmres import fgmres as t_fgmres
from thermalporous_tpu.core import ScalarStencil as JScalarStencil
from thermalporous_tpu.core import apply_blocks as j_apply_blocks
from thermalporous_tpu.precond import cpr as jcpr
from thermalporous_tpu.precond import gmg as jgmg
from thermalporous_tpu.solve.fgmres import fgmres as j_fgmres

torch.set_num_threads(1)

RTOL = 1e-10
GMG_KW = dict(max_coarse_cells=4, degree=4, kcycle_min_cells=16)


@pytest.fixture(scope="module")
def system():
    """The assembled Jacobian of the 2D model case and a right-hand side."""
    c = model_case((12, 12), seed=4)
    js = jax.jit(c["jm"].assemble_stencil)(c["ju"], c["ju0"], c["dt"], c["jd"])
    rhs = -np.asarray(c["jm"].residual(c["ju"], c["ju0"], c["dt"], c["jd"]))
    return js, torch_block(js), rhs


@pytest.mark.parametrize("orth", ["cgs2", "cgs2g"])
def test_fgmres(system, orth):
    js, ts, rhs = system
    jdinv, tdinv = js.diag_inverse(), ts.diag_inverse()
    gram = 3 if orth == "cgs2g" else 0
    jr = j_fgmres(js.matvec, jnp.asarray(rhs),
                  precond=lambda r: j_apply_blocks(jdinv, r),
                  rtol=1e-6, maxiter=30, orth_gram=gram)
    tr = t_fgmres(ts.matvec, t(rhs), precond=lambda r: tc.apply_blocks(tdinv, r),
                  rtol=1e-6, maxiter=30, orth_gram=gram)
    assert tr.iters == int(jr.iters) > 3
    assert tr.converged and bool(jr.converged)
    true_t = np.linalg.norm(rhs - n(ts.matvec(tr.x)))
    true_j = np.linalg.norm(rhs - np.asarray(js.matvec(jr.x)))
    assert abs(true_t - true_j) <= 1e-10 * np.linalg.norm(rhs)
    assert_close(tr.x, jr.x, RTOL, 1e-12)


def test_fgmres_unported_options_raise(system):
    """Every option of the reference's FGMRES is ported; what it refuses,
    the port refuses: an unknown Gram variant, and an iteration cap beside
    restarts (the restart driver owns the cycles' caps)."""
    js, ts, rhs = system
    for fg, mv, b in ((t_fgmres, ts.matvec, t(rhs)), (j_fgmres, js.matvec, jnp.asarray(rhs))):
        with pytest.raises(ValueError, match="orth_gram"):
            fg(mv, b, maxiter=10, orth_gram=1)
        with pytest.raises(ValueError, match="iter_cap"):
            fg(mv, b, maxiter=10, restart=4, iter_cap=3)


def _pressure_blocks(js):
    """The decoupled pressure block of the reference's CPTR setup."""
    w = jcpr._impes_weights(js.diag)
    return js.scale_rows(w).scalar(0, 0)


@pytest.mark.parametrize("cycle", ["v", "k"])
def test_gmg_apply(system, cycle):
    js, _, rhs = system
    japp = _pressure_blocks(js)
    tapp = torch_scalar(japp)
    jcfg = jgmg.GMGConfig(cycle_type=cycle, **GMG_KW)
    tcfg = tgmg.GMGConfig(cycle_type=cycle, **GMG_KW)
    jst = jax.jit(lambda a: jgmg.gmg_setup(a, jcfg))(japp)
    tst = tgmg.gmg_setup(tapp, tcfg)
    assert len(tst.stencils) == len(jst.stencils) == 4
    for a, b in zip(tst.stencils, jst.stencils):
        assert_close(a.packed, torch_scalar(b).packed, 1e-12, 1e-15)
    assert_close(tst.coarse_inv, jst.coarse_inv, 1e-10, 1e-14)
    b = rhs[0]
    assert_close(tgmg.gmg_apply(tst, t(b), tcfg),
                 jax.jit(lambda s, x: jgmg.gmg_apply(s, x, jcfg))(jst, jnp.asarray(b)),
                 RTOL, 1e-13)


@pytest.mark.parametrize("cols", [True, False])
def test_cpr_apply(system, cols):
    js, ts, rhs = system
    kw = dict(stage2_cols=cols, gmg=GMG_KW, gmg_t=dict(GMG_KW, cycle_type="v", degree=2))
    jcfg = jcpr.CPRConfig(stage2_cols=cols, gmg=jgmg.GMGConfig(**kw["gmg"]),
                          gmg_t=jgmg.GMGConfig(**kw["gmg_t"]))
    tcfg = tcpr.CPRConfig(stage2_cols=cols, gmg=tgmg.GMGConfig(**kw["gmg"]),
                          gmg_t=tgmg.GMGConfig(**kw["gmg_t"]))
    jset, japply = jcpr.make_preconditioner("cptr", jcfg)
    tset, tapply = tcpr.make_preconditioner("cptr", tcfg)
    jstate, tstate = jax.jit(jset)(js), tset(ts)
    assert_close(tstate.w, jstate.w, 1e-12, 1e-15)
    assert_close(tapply(tstate, t(rhs)), jax.jit(japply)(jstate, jnp.asarray(rhs)),
                 RTOL, 1e-13)


def test_trivial_preconditioners(system):
    _, ts, rhs = system
    r = t(rhs)
    setup, apply = tcpr.make_preconditioner("none")
    assert apply(setup(ts), r) is r
    setup, apply = tcpr.make_preconditioner("jacobi")
    assert_close(apply(setup(ts), r), tc.apply_blocks(ts.diag_inverse(), r), 0)


def test_cpr_unported_options_raise():
    """The bgmg stage 2 with its sizes and the weighted and variational
    transfers construct (their parity: tests/test_torch_block_gmg.py,
    tests/test_torch_transfer.py); an unknown transfer is refused; the
    Pallas stage-2 switch and the TPU/multi-device GMG options have no
    field; unknown names are refused (bf16 coefficient storage and the
    batched p/T traversal are ported: tests/test_torch_pc_dtype.py,
    tests/test_torch_batch_pt.py; the grid decomposition's
    ``replicate_below`` and ``mesh``: tests/test_torch_sharding.py)."""
    assert tcpr.CPRConfig(stage2="bgmg", bgmg_cycles=2, bgmg_coarse_cells=64).bgmg_cycles == 2
    for transfer in ("constant", "weighted", "variational"):
        assert tgmg.GMGConfig(transfer=transfer, transfer_floor=0.5).transfer == transfer
    with pytest.raises(ValueError, match="transfer"):
        tgmg.GMGConfig(transfer="linear")
    for cls, kw in ((tcpr.CPRConfig, dict(stage2_pallas=True)),
                    (tgmg.GMGConfig, dict(use_pallas=True))):
        with pytest.raises(TypeError):
            cls(**kw)
    assert tgmg.GMGConfig(replicate_below=16).replicate_below == 16
    for kw in (dict(stage2="ilu"), dict(decoupling="x"), dict(variant="cprs"),
               dict(inner_method="cg"), dict(s_stage="ilu"), dict(pc_dtype="f16")):
        with pytest.raises(ValueError):
            tcpr.CPRConfig(**kw)
    for kw in (dict(cycle_type="f"), dict(smoother="sor"), dict(cycles=0)):
        with pytest.raises(ValueError):
            tgmg.GMGConfig(**kw)
    with pytest.raises(ValueError):
        tcpr.make_preconditioner("ilu")
    # the options the reference has are constructed
    tcpr.CPRConfig(variant="cpr", stage2="zebra", decoupling="abf", triangular=False,
                   inner_iters=2, stage2_fused=True, stage2_axes=(2,), s_stage="line")
    tgmg.GMGConfig(cycle_type="w", smoother="zebra", cycles=2, semicoarsen_z=True)
    for name in ("cpr", "rbgs", "lu"):
        tcpr.make_preconditioner(name)


def test_plan_coarsening(rng):
    """A 3D stencil with 30× stronger z coupling: the same per-level schedule."""
    shape = (4, 4, 12)
    strength = (1.0, 1.0, 30.0)
    ups, los = [], []
    diag = 0.1 * np.ones(shape)
    for a, s in enumerate(strength):
        tf = s * np.exp(0.3 * rng.standard_normal(shape))
        idx = np.arange(shape[a]).reshape([-1 if i == a else 1 for i in range(3)])
        tf = tf * (idx < shape[a] - 1)
        prev = np.roll(tf, 1, axis=a) * (idx > 0)
        ups.append(-tf)
        los.append(-prev)
        diag = diag + tf + prev
    jst = JScalarStencil(diag=jnp.asarray(diag), upper=tuple(map(jnp.asarray, ups)),
                         lower=tuple(map(jnp.asarray, los)))
    cfg_kw = dict(max_coarse_cells=4)
    ref = jgmg.plan_coarsening(jst, jgmg.GMGConfig(**cfg_kw))
    got = tgmg.plan_coarsening(torch_scalar(jst), tgmg.GMGConfig(**cfg_kw))
    assert got == ref
    assert ref[0] == (1, 1, 2)
    # a baked schedule drives the hierarchy the same way
    tcfg = dataclasses.replace(tgmg.GMGConfig(**cfg_kw), level_factors=got)
    jcfg = dataclasses.replace(jgmg.GMGConfig(**cfg_kw), level_factors=ref)
    shapes_t = [s.grid_shape for s in tgmg.gmg_setup(torch_scalar(jst), tcfg).stencils]
    shapes_j = [tuple(s.grid_shape) for s in jgmg.gmg_setup(jst, jcfg).stencils]
    assert shapes_t == shapes_j
