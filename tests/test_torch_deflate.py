"""Port parity of Krylov recycling, FGCRO-DR-style deflated FGMRES
(``thermalporous_torch/solve/deflate.py`` and ``NewtonConfig.ksp_recycle``),
against the JAX package, f64 on the CPU.

- The cases of ``tests/test_deflate.py`` on its slow-mode dense systems (a
  few tiny singular values, made with numpy from a seed): an all-invalid
  recycle space is plain FGMRES (the port's own, bit for bit, and the
  reference's counts), recycling cuts the second solve's iterations, the
  Givens estimate is the true residual, the recycle image is orthonormal
  with A·U' = C, dependent columns are invalidated.
- Against the reference's ``fgmres_dr`` on a sequence of solves: the same
  iteration counts and solutions, and the harvest held by what does not
  depend on the eigenvector basis of ``eigh`` (LAPACK orders and signs them
  as it likes): A·(U R⁻¹) = C, the deflated start x₀, the masks.
- One Newton step with ``ksp_recycle=4`` at the reference's Newton and
  FGMRES counts, and the refusal of ``ksp_restart`` in both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import assert_close, carry_model_data, newton_option_parity, t
from tests.test_deflate import _slow_mode_system
from tests.test_newton_cptr import TIGHT, _tp_case
from thermalporous_torch.solve import NewtonConfig, Simulator
from thermalporous_torch.solve.deflate import empty_recycle, fgmres_dr, prepare_recycle
from thermalporous_torch.solve.fgmres import fgmres
from thermalporous_torch.solve.oracle import oracle_run
from thermalporous_tpu.solve import Simulator as JSimulator
from thermalporous_tpu.solve import deflate as jdef

torch.set_num_threads(1)


def _system(rng):
    a, x, b = _slow_mode_system(rng)
    return np.asarray(a), np.asarray(x), np.asarray(b)


def _mv(a):
    ta = t(a)
    return lambda v: ta @ v


def test_deflated_cold_is_plain_fgmres(rng):
    """An all-invalid recycle space degrades exactly to plain FGMRES, and
    the harvest is populated from the solve."""
    a, _, b = _system(rng)
    ref = fgmres(_mv(a), t(b), rtol=1e-9, maxiter=60)
    U, mask = empty_recycle(b.shape, 5, torch.float64, "cpu")
    res, U1, m1 = fgmres_dr(_mv(a), t(b), U=U, u_mask=mask, rtol=1e-9, maxiter=60)
    assert res.iters == ref.iters
    assert torch.equal(res.x, ref.x)
    assert bool(m1.any()) and m1.dtype == torch.bool and m1.device.type == "cpu"
    jU, jm = jdef.empty_recycle(b.shape, 5, jnp.float64)
    jres, _, jm1 = jdef.fgmres_dr(lambda v: jnp.asarray(a) @ v, jnp.asarray(b), U=jU,
                                  u_mask=jm, rtol=1e-9, maxiter=60)
    assert res.iters == int(jres.iters)
    assert_close(res.x, jres.x, 1e-10, 1e-12)
    assert m1.tolist() == np.asarray(jm1).tolist()


def test_recycling_reduces_iterations_same_system(rng):
    a, x_true, b = _system(rng)
    U, mask = empty_recycle(b.shape, 6, torch.float64, "cpu")
    r1, U1, m1 = fgmres_dr(_mv(a), t(b), U=U, u_mask=mask, rtol=1e-8, maxiter=110)
    r2, _, _ = fgmres_dr(_mv(a), t(b), U=U1, u_mask=m1, rtol=1e-8, maxiter=110)
    assert r1.converged and r2.converged
    assert r2.iters < r1.iters
    np.testing.assert_allclose(r2.x.numpy(), x_true, rtol=1e-5, atol=1e-7)


def test_residual_estimate_is_true_residual(rng):
    """α = −B·y annihilates the C component of the residual, so the Givens
    estimate is the true residual norm."""
    a, _, b = _system(rng)
    U, mask = empty_recycle(b.shape, 6, torch.float64, "cpu")
    _, U1, m1 = fgmres_dr(_mv(a), t(b), U=U, u_mask=mask, rtol=1e-8, maxiter=80)
    res, _, _ = fgmres_dr(_mv(a), t(b), U=U1, u_mask=m1, rtol=1e-4, maxiter=80)
    true = float(np.linalg.norm(b - a @ res.x.numpy()))
    assert abs(true - res.res_norm) <= 1e-6 * float(np.linalg.norm(b)) + 1e-12


def test_prepare_recycle_image_orthonormal(rng):
    a, _, b = _system(rng)
    U = rng.standard_normal((4, b.shape[0]))
    Uo, C, m = prepare_recycle(_mv(a), t(U), torch.ones(4, dtype=torch.bool))
    assert bool(m.all())
    np.testing.assert_allclose((t(a) @ Uo.T).T.numpy(), C.numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(C.numpy() @ C.numpy().T, np.eye(4), atol=1e-10)
    jUo, jC, jm = jdef.prepare_recycle(lambda v: jnp.asarray(a) @ v, jnp.asarray(U),
                                       jnp.ones(4, dtype=bool))
    assert_close(C, jC, 1e-10, 1e-12)
    assert_close(Uo, jUo, 1e-10, 1e-12)


def test_prepare_recycle_masks_dependent_columns(rng):
    a, _, b = _system(rng)
    u0 = rng.standard_normal(b.shape[0])
    U = np.stack([u0, 2.0 * u0, rng.standard_normal(b.shape[0])])
    Uo, C, m = prepare_recycle(_mv(a), t(U), torch.ones(3, dtype=torch.bool))
    assert m.tolist() == [True, False, True]
    assert not C[1].any() and not Uo[1].any()
    # an invalid input column is skipped: no matvec, a zero image
    calls = []

    def counting(v):
        calls.append(1)
        return t(a) @ v

    _, C2, m2 = prepare_recycle(counting, t(U), torch.tensor([True, False, True]))
    assert len(calls) == 2 and m2.tolist() == [True, False, True]


def test_a_sequence_of_solves_matches_the_reference(rng):
    """Four solves on drifting operators (A + 0.01·k·E), the harvest carried
    from each to the next: the reference's iteration counts and solutions
    at every solve, and A_k·(U R⁻¹) = C on the port's own harvest."""
    a, _, b = _system(rng)
    e = 0.01 * rng.standard_normal(a.shape)
    U, m = empty_recycle(b.shape, 4, torch.float64, "cpu")
    jU, jm = jdef.empty_recycle(b.shape, 4, jnp.float64)
    for k in range(4):
        ak = a + k * e
        bk = b + 0.1 * k * rng.standard_normal(b.shape)
        res, U, m = fgmres_dr(_mv(ak), t(bk), precond=lambda r: r / 2.0, U=U, u_mask=m,
                              rtol=1e-10, maxiter=100)
        jres, jU, jm = jdef.fgmres_dr(lambda v: jnp.asarray(ak) @ v, jnp.asarray(bk),
                                      precond=lambda r: r / 2.0, U=jU, u_mask=jm,
                                      rtol=1e-10, maxiter=100)
        assert (res.iters, res.converged) == (int(jres.iters), bool(jres.converged))
        assert_close(res.x, jres.x, 1e-8, 1e-10)
        assert m.tolist() == np.asarray(jm).tolist()
        Uo, C, mc = prepare_recycle(_mv(ak), U, m)
        np.testing.assert_allclose((t(ak) @ Uo.T).T.numpy(), C.numpy(), atol=1e-9)
        # the deflated start x₀ = U' Cᵀ b is the reference's, whatever the
        # signs and order of the eigenvectors; the harvested subspace itself
        # is as accurate as eigh on the shifted GᵀG (squared singular values
        # beside 1e30 shifts), so x₀ agrees to 1e-6 of its size, not to ulps
        jUo, jC, jmc = jdef.prepare_recycle(lambda v: jnp.asarray(ak) @ v, jU, jm)
        x0 = (Uo.T @ (C @ t(bk))).numpy()
        jx0 = np.asarray(jUo).T @ (np.asarray(jC) @ bk)
        np.testing.assert_allclose(x0, jx0, rtol=0, atol=1e-6 * np.abs(jx0).max())


def test_bf16_basis_and_one_pass(rng):
    """The deflated solver with a bf16 Arnoldi basis and with one
    Gram–Schmidt pass converges to its floor, as fgmres does."""
    a, _, b = _system(rng)
    U, m = empty_recycle(b.shape, 4, torch.float64, "cpu")
    _, U, m = fgmres_dr(_mv(a), t(b), U=U, u_mask=m, rtol=1e-8, maxiter=100)
    for kw in (dict(basis_dtype=torch.bfloat16), dict(orth_passes=1)):
        res, _, _ = fgmres_dr(_mv(a), t(b), U=U, u_mask=m, rtol=1e-3, maxiter=100, **kw)
        assert res.converged and res.x.dtype == torch.float64
        assert np.linalg.norm(a @ res.x.numpy() - b) <= 2e-2 * np.linalg.norm(b)


@pytest.fixture(scope="module")
def tp6():
    jm, jd = _tp_case(n=6)
    tm, td = carry_model_data(jm, jd)
    return jm, jd, tm, td, oracle_run(tm, td, [3600.0])[0]


@pytest.mark.parametrize("opt", [
    dict(pc=dict(stage2="rbgs"), newton=dict(ksp_recycle=4)),
    dict(newton=dict(ksp_recycle=4, ksp_orth="cgs2g2", ksp_ew=True)),
], ids=["recycle4", "recycle4-cgs2g2-ew"])
def test_newton_step_with_recycling(tp6, opt):
    """One Newton step carrying a 4-column recycle space across its
    iterations: the reference's Newton and FGMRES counts, states within
    1e-8 and within the oracle's bound (with ``cgs2g2`` both packages run
    classic CGS2 in the deflated solver)."""
    jm, jd, tm, td, oracle = tp6
    newton_option_parity(jm, jd, tm, td, oracle, **opt)


def test_recycle_refuses_restart(tp6):
    jm, jd, tm, td, _ = tp6
    cfg = dict(ksp_recycle=4, ksp_restart=16)
    with pytest.raises(ValueError, match="ksp_recycle"):
        JSimulator(jm, jd, precond="cptr",
                   newton_cfg=dataclasses.replace(TIGHT, **cfg)).step(jm.initial_state(jd),
                                                                       3600.0)
    tnewton = NewtonConfig(**dict(dataclasses.asdict(TIGHT), **cfg))
    with pytest.raises(ValueError, match="ksp_recycle"):
        Simulator(tm, td, precond="cptr", newton_cfg=tnewton, device="cpu").step(
            tm.initial_state(td), 3600.0)
