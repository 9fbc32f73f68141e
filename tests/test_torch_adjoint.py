"""Port parity of the discrete adjoint (``thermalporous_torch/solve/adjoint.py``)
against the JAX package, f64 on the CPU.

- ``BlockStencil.transpose`` against the dense transpose, and the
  transposed product — ``torch.func.vjp`` of the plain residual — against
  the reference's ``jax.vjp`` in every slot (u_new, u_old and each
  ``ProblemData`` leaf), at states with saturations exactly at Se = 0 and 1,
  where both clips pass half the cotangent.
- ``adjoint_gradients`` on the reference's recorded trajectory, for both
  models, with terminal and running objectives: the value, every gradient
  leaf and ``grad_u0`` within 1e-8 of the reference's largest value, and
  identical FGMRES counts; also with ``recycle=4`` and the ``cgs2g`` and
  ``cgs2g2`` orthogonalizations.
- ``record_trajectory`` gives the reference's states; a central-difference
  probe of the port's own runs against its adjoint; the
  ``adjoint_study`` CLI on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import (
    assert_close,
    assert_grad_data_close,
    assert_states_close,
    carry_model_data,
    model_case,
    n,
    t,
)
from tests.test_adjoint import _case
from tests.test_torch_jvp import _tie_case
from thermalporous_torch.interop import problem_data_to_numpy
from thermalporous_torch.models.base import ProblemData
from thermalporous_torch.solve import NewtonConfig, Simulator
from thermalporous_torch.solve import adjoint_gradients as t_adjoint
from thermalporous_torch.solve import record_trajectory as t_record
from thermalporous_tpu.models import SinglePhaseModel as JSinglePhaseModel
from thermalporous_tpu.models import TwoPhaseModel as JTwoPhaseModel
from thermalporous_tpu.solve import NewtonConfig as JNewtonConfig
from thermalporous_tpu.solve import Simulator as JSimulator
from thermalporous_tpu.solve import adjoint_gradients as j_adjoint
from thermalporous_tpu.solve import record_trajectory as j_record

torch.set_num_threads(1)

RTOL = 1e-8
DTS = [1800.0, 2700.0, 4050.0]
NEWTON = dict(rtol=1e-12, ksp_rtol=1e-10, ksp_maxiter=120)
MODELS = {"single": JSinglePhaseModel, "two": JTwoPhaseModel}


def test_block_stencil_transpose_matches_dense():
    c = model_case((5, 4, 3), seed=3)
    st = c["tm"].assemble_stencil(c["tu"], c["tu0"], c["dt"], c["td"])
    a = st.to_dense().numpy()
    np.testing.assert_allclose(st.transpose().to_dense().numpy(), a.T, rtol=1e-12,
                               atol=1e-12 * np.abs(a).max())
    assert torch.equal(st.transpose().transpose().coef, st.coef)


@pytest.mark.parametrize("tie", [False, True], ids=["interior", "saturation-bounds"])
def test_residual_vjp_matches_the_reference_in_every_slot(tie):
    """The cotangents of the plain residual with respect to u_new, u_old and
    the packed problem data, against ``jax.vjp`` of the reference's
    residual with respect to its ``ProblemData`` pytree."""
    if tie:
        c, ju, tu = _tie_case()
        assert (np.asarray(ju[2]) == 0.0).any() and (np.asarray(ju[2]) == 1.0).any()
    else:
        c = model_case((6, 5, 3), seed=2)
        ju, tu = c["ju"], c["tu"]
    jm, jd, dt = c["jm"], c["jd"], c["dt"]
    rng = np.random.default_rng(9)
    w = rng.standard_normal(tuple(ju.shape))
    _, jpull = jax.vjp(lambda un, uo, d: jm.residual(un, uo, dt, d), ju, c["ju0"], jd)
    jun, juo, jdd = jpull(jnp.asarray(w))
    _, tpull = torch.func.vjp(
        lambda un, uo, f: c["tm"].residual(un, uo, dt, ProblemData(f)),
        tu, c["tu0"], c["td"].fields)
    tun, tuo, tdd = tpull(t(w))
    assert_close(tun, jun, 1e-12, 1e-14)
    assert_close(tuo, juo, 1e-12, 1e-14)
    assert_grad_data_close(ProblemData(tdd), jdd, 1e-12)


# ------------------------------------------------------------ gradients

def _objectives(nc):
    """(reference, port) terminal and running objectives: the mean
    temperature near the injector plus a porosity-weighted pressure term,
    and a Δt-weighted producer-corner saturation (pressure) rate."""
    comp = 2 if nc == 3 else 0

    def jterm(u, d):
        return jnp.mean(u[1, :4, :3]) + 1e-9 * jnp.sum(d.phi * u[0])

    def tterm(u, d):
        return torch.mean(u[1, :4, :3]) + 1e-9 * torch.sum(d.phi * u[0])

    def jrun(u, dt, d):
        return dt * jnp.mean(u[comp, -3:, -3:]) * (1e-7 if comp == 0 else 1.0)

    def trun(u, dt, d):
        return dt * torch.mean(u[comp, -3:, -3:]) * (1e-7 if comp == 0 else 1.0)

    return (jterm, jrun), (tterm, trun)


@pytest.fixture(scope="module", params=sorted(MODELS))
def trajectory(request):
    """A recorded three-step trajectory of the reference (8×6), the port's
    model and data carried across, the states as CPU tensors."""
    jm, jd = _case(MODELS[request.param], shape=(8, 6))
    tm, td = carry_model_data(jm, jd)
    sim = JSimulator(jm, jd, precond="cptr", newton_cfg=JNewtonConfig(**NEWTON))
    states = j_record(sim, jm.initial_state(jd), DTS)
    return request.param, jm, jd, tm, td, states, [t(s) for s in states]


CASES = {
    "terminal": dict(objectives="terminal"),
    "running": dict(objectives="running"),
    "both-recycle4": dict(objectives="both", recycle=4),
    "terminal-cgs2g": dict(objectives="terminal", orth="cgs2g"),
    "both-cgs2g2": dict(objectives="both", orth="cgs2g2"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_adjoint_gradients_match(trajectory, case):
    name, jm, jd, tm, td, jstates, tstates = trajectory
    kw = dict(CASES[case])
    which = kw.pop("objectives")
    (jterm, jrun), (tterm, trun) = _objectives(jm.nc)
    use_t, use_r = which in ("terminal", "both"), which in ("running", "both")
    ref = j_adjoint(jm, jd, jstates, DTS, terminal=jterm if use_t else None,
                    running=jrun if use_r else None, rtol=1e-11, maxiter=200, **kw)
    got = t_adjoint(tm, td, tstates, DTS, terminal=tterm if use_t else None,
                    running=trun if use_r else None, rtol=1e-11, maxiter=200, **kw)
    assert ref.converged and got.converged
    assert got.ksp_iters == int(ref.ksp_iters)
    assert len(got.step_iters) == len(DTS) and sum(got.step_iters) == got.ksp_iters
    assert abs(float(got.value) - float(ref.value)) <= RTOL * abs(float(ref.value))
    assert_grad_data_close(got.grad_data, ref.grad_data, RTOL)
    assert_close(got.grad_u0, ref.grad_u0, 0.0, RTOL)
    assert got.grad_data.fields.shape == td.fields.shape


def test_record_trajectory_gives_the_references_states(trajectory):
    name, jm, jd, tm, td, jstates, _ = trajectory
    sim = Simulator(tm, td, precond="cptr", newton_cfg=NewtonConfig(**NEWTON), device="cpu")
    states = t_record(sim, tm.initial_state(td), DTS)
    assert len(states) == len(jstates)
    for got, ref in zip(states[1:], jstates[1:]):
        assert_states_close(got, ref, 1e-8)


def test_adjoint_refuses_what_the_reference_refuses(trajectory):
    _, _, _, tm, td, _, tstates = trajectory
    with pytest.raises(ValueError, match="objective"):
        t_adjoint(tm, td, tstates, DTS)
    with pytest.raises(ValueError, match="dts"):
        t_adjoint(tm, td, tstates[:-1], DTS, terminal=lambda u, d: u.sum())


def test_adjoint_matches_a_central_difference():
    """dJ/dT_geo along a relative perturbation, against central differences
    of the port's own forward runs (two-phase, 8×6, two steps)."""
    jm, jd = _case(JTwoPhaseModel, shape=(8, 6))
    tm, td = carry_model_data(jm, jd)
    dts = DTS[:2]
    cfg = NewtonConfig(rtol=1e-12, ksp_rtol=1e-11, ksp_maxiter=150)

    def terminal(u, d):
        return torch.mean(u[1, :4, :3])

    def run(d):
        sim = Simulator(tm, d, precond="cptr", newton_cfg=cfg, device="cpu")
        return t_record(sim, tm.initial_state(d), dts)

    res = t_adjoint(tm, td, run(td), dts, terminal=terminal, rtol=1e-12, maxiter=300)
    xi = t(np.random.default_rng(1).standard_normal((8, 6)))
    delta = td.tgeo[0] * xi
    eps = 1e-4

    def bumped(sign):
        f = td.fields.clone()
        f[0] = f[0] + sign * eps * delta
        return ProblemData(f)

    fd = (float(terminal(run(bumped(1))[-1], td)) - float(terminal(run(bumped(-1))[-1], td))) \
        / (2 * eps)
    ad = float(torch.sum(res.grad_data.tgeo[0] * delta))
    assert abs(ad - fd) <= 1e-5 * abs(fd), (ad, fd)
    # the gradient comes back in the ProblemData layout, as plain arrays too
    arrays = problem_data_to_numpy(res.grad_data)
    assert len(arrays["tgeo"]) == 2 and arrays["phi"].shape == (8, 6)
    assert not arrays["has_tinj"].any()


def test_adjoint_study_cli(capsys):
    """The study on the CPU, no ascent: the reference's output lines, a
    converged sweep and an adjoint within 1e-4 of the central difference;
    on a machine without CUDA the default device is refused."""
    from thermalporous_torch import adjoint_study

    assert adjoint_study.main(["--device", "cpu", "--ascent", "0"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# SinglePhaseModel (24, 20), 5 steps")
    assert out[1].startswith("J           = ") and "converged=True" in out[2]
    rel = float(out[5].split("rel err ")[1].rstrip(")"))
    assert rel < 1e-4
    if not torch.cuda.is_available():
        assert adjoint_study.main([]) == 1
