"""Port parity of the FGMRES, Newton and multigrid options (f64, CPU)
against the JAX package.

- FGMRES alone on the dense systems of ``tests/test_fgmres.py`` (made with
  numpy from a seed): warm starts, restarts, the total budget, single-pass
  CGS (``cgs1``), selective reorthogonalization (``cgs2s``) and the
  algebraic-Gram low-synchronization CGS2 (``cgs2g2``), alone and combined —
  the same iteration counts and solutions within 1e-10; with a bf16 basis
  every option still solves to the basis' floor.
- One Newton step per option on the 6×6 two-phase case of
  ``tests/test_newton_cptr.py`` (``tests/_torch_parity.py:
  newton_option_parity``; options that do not interact share a step): each
  ``ksp_orth``, ``ksp_restart``, ``pc_lag="step"``, each GMG smoother,
  ``semicoarsen_z``, ``cycles=2`` and the W-cycle, unfused and fused —
  identical Newton and FGMRES counts,
  states within 1e-8, within the reference's oracle bound of the port's
  oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import assert_close, carry_model_data, newton_option_parity, t
from tests.test_newton_cptr import _tp_case
from thermalporous_torch.solve.fgmres import fgmres as t_fgmres
from thermalporous_torch.solve.oracle import oracle_run
from thermalporous_tpu.solve.fgmres import fgmres as j_fgmres

torch.set_num_threads(1)


def _system(seed, n, scale, shift):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * scale + shift * np.eye(n)
    return a, rng.standard_normal(n), rng.standard_normal(n)


FGMRES_CASES = {
    # name: (system, solver keyword arguments, Jacobi preconditioner, warm start)
    "x0": ((0, 60, 1 / np.sqrt(60), 2.0), dict(rtol=1e-10, maxiter=60), False, True),
    "x0_pc": ((1, 60, 1 / np.sqrt(60), 4.0), dict(rtol=1e-10, maxiter=60), True, True),
    "restart": ((2, 80, 0.3, 4.0), dict(rtol=1e-10, maxiter=80, restart=12), False, False),
    "restart_pc": ((2, 80, 0.3, 4.0), dict(rtol=1e-10, maxiter=80, restart=12), True, False),
    "restart_x0": ((3, 80, 0.3, 4.0), dict(rtol=1e-10, maxiter=80, restart=12), True, True),
    "budget": ((4, 120, 0.8, 1.5), dict(rtol=1e-14, maxiter=40, restart=16), False, False),
    "budget_even": ((4, 120, 0.8, 1.5), dict(rtol=1e-14, maxiter=32, restart=16), False, False),
    "cap_single": ((4, 120, 0.8, 1.5), dict(rtol=1e-14, maxiter=40, iter_cap=23), False,
                   False),
    "cgs1": ((5, 60, 1 / np.sqrt(60), 4.0), dict(rtol=1e-3, maxiter=60, orth_passes=1), True,
             False),
    "cgs1_tight": ((5, 60, 1 / np.sqrt(60), 4.0), dict(rtol=1e-10, maxiter=60,
                                                        orth_passes=1), True, False),
    "cgs2s": ((6, 60, 1 / np.sqrt(60), 4.0), dict(rtol=1e-10, maxiter=60,
                                                   orth_selective=True), True, False),
    "cgs2s_restart": ((6, 60, 1 / np.sqrt(60), 4.0), dict(rtol=1e-10, maxiter=60, restart=16,
                                                           orth_selective=True), False, False),
    "cgs2g2": ((7, 60, 1 / np.sqrt(60), 4.0), dict(rtol=1e-10, maxiter=60, orth_gram=2), True,
               False),
    "cgs2g2_x0_restart": ((7, 60, 1 / np.sqrt(60), 4.0), dict(rtol=1e-10, maxiter=60,
                                                               restart=16, orth_gram=2),
                          False, True),
    "cgs2g_restart": ((8, 60, 1 / np.sqrt(60), 4.0), dict(rtol=1e-10, maxiter=60, restart=16,
                                                           orth_gram=3), False, False),
}


@pytest.mark.parametrize("name", sorted(FGMRES_CASES))
def test_fgmres_option_matches(name):
    (seed, n, scale, shift), kw, use_pc, warm = FGMRES_CASES[name]
    a, b, x0 = _system(seed, n, scale, shift)
    ja, ta = jnp.asarray(a), t(a)
    jd, td = jnp.asarray(1.0 / np.diag(a)), t(1.0 / np.diag(a))
    jkw = dict(kw)
    if "iter_cap" in jkw:
        jkw["iter_cap"] = jnp.asarray(jkw["iter_cap"])
    ref = j_fgmres(lambda v: ja @ v, jnp.asarray(b),
                   precond=(lambda r: jd * r) if use_pc else None,
                   x0=jnp.asarray(x0) if warm else None, **jkw)
    got = t_fgmres(lambda v: ta @ v, t(b), precond=(lambda r: td * r) if use_pc else None,
                   x0=t(x0) if warm else None, **kw)
    assert got.iters == int(ref.iters)
    assert (got.converged, got.breakdown) == (bool(ref.converged), bool(ref.breakdown))
    assert got.iters <= kw["maxiter"] and got.iters <= kw.get("iter_cap", kw["maxiter"])
    assert_close(got.x, ref.x, 1e-10, 1e-12)
    assert abs(got.res_norm - float(ref.res_norm)) <= 1e-8 * np.linalg.norm(b)


def test_fgmres_zero_rhs_and_warm_start_at_the_solution():
    """Zero iterations when nothing is left to solve: a zero right-hand
    side, or a warm start at the exact solution."""
    a, b, _ = _system(9, 20, 0.2, 3.0)
    ta = t(a)
    out = t_fgmres(lambda v: ta @ v, t(np.zeros(20)), rtol=1e-8)
    assert out.converged and out.iters == 0 and not out.x.any()
    xs = np.linalg.solve(a, b)
    out = t_fgmres(lambda v: ta @ v, t(b), x0=t(xs), rtol=1e-8, maxiter=10, restart=4)
    assert out.converged and out.iters == 0
    assert_close(out.x, xs, 0.0)


@pytest.mark.parametrize("kw", [dict(), dict(orth_passes=1), dict(orth_selective=True),
                                dict(orth_gram=3), dict(restart=12),
                                dict(restart=12, orth_selective=True)],
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "cgs2")
def test_fgmres_bf16_basis_with_every_option(kw):
    """The bf16 basis keeps working with each option (f64 reductions, a
    compute-dtype solution): converged, true residual within the basis'
    floor, as the reference's own bf16 tests bound it."""
    a, b, x0 = _system(10, 60, 1 / np.sqrt(60), 4.0)
    ta, td = t(a), t(1.0 / np.diag(a))
    for warm in (None, t(x0)):
        out = t_fgmres(lambda v: ta @ v, t(b), precond=lambda r: td * r, x0=warm, rtol=1e-3,
                       maxiter=60, basis_dtype=torch.bfloat16, **kw)
        assert out.converged and out.x.dtype == torch.float64
        r = np.linalg.norm(a @ out.x.numpy() - b)
        assert r <= 2e-2 * np.linalg.norm(b)


# ------------------------------------------------------------ Newton steps

@pytest.fixture(scope="module")
def tp6():
    jm, jd = _tp_case(n=6)
    tm, td = carry_model_data(jm, jd)
    return jm, jd, tm, td, oracle_run(tm, td, [3600.0])[0]


# options that do not interact share a step (each reference step costs a
# JAX compile of the whole Newton loop); the W-cycle runs from 4 cells, so
# that the 9-cell level of the 6×6 hierarchy takes it
W = dict(cycle_type="w", kcycle_min_cells=4)
NEWTON_OPTIONS = [
    dict(newton=dict(ksp_orth="cgs1"), gmg=dict(smoother="jacobi")),
    dict(newton=dict(ksp_orth="cgs2s"), gmg=dict(smoother="rbgs")),
    dict(newton=dict(ksp_orth="cgs2g"), gmg=dict(smoother="line", line_axis=0)),
    dict(newton=dict(ksp_orth="cgs2g2"), gmg=dict(smoother="zebra")),
    dict(newton=dict(ksp_restart=4), gmg=dict(semicoarsen_z=True)),
    dict(newton=dict(pc_lag="step"), gmg=dict(cycles=2)),
    dict(newton=dict(pc_lag="step", krylov_op="jvp"), gmg=dict(W, fuse_below=10**6)),
    dict(gmg=W),
]


@pytest.mark.parametrize("opt", NEWTON_OPTIONS, ids=lambda o: str(o))
def test_newton_step_option(tp6, opt):
    jm, jd, tm, td, oracle = tp6
    newton_option_parity(jm, jd, tm, td, oracle, pc=dict(stage2="rbgs"), **opt)
