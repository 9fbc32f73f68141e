"""Port parity of the ensemble adjoint (``ensemble_adjoint_gradients``,
``record_ensemble_trajectory`` in ``thermalporous_torch/solve/adjoint.py``)
against the JAX package, f64 on the CPU.

- The reference's case (``tests/test_adjoint.py``'s ensemble test): three
  two-phase members at 8×6 (seeds 1–3), Δt 1800 and 2700 s, the terminal
  mean temperature near the injector.  Against the reference's ensemble
  sweep at that test's tolerances, with its lockstep FGMRES count; against
  each member's reference solo sweep within 1e-8; the recorded states
  within 1e-8 of the reference's ensemble trajectory.
- A running objective: each member bitwise its port solo sweep, the
  lockstep count the sum of the per-step maxima.
- The non-convergence error's member list and the adaptive-coarsening
  refusal, each with the reference's text.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import OPTION_GMG, assert_states_close, carry_model_data
from tests.test_adjoint import _case
from thermalporous_torch.dist import make_ensemble_step_fn, stack_ensemble
from thermalporous_torch.interop import config_from_dict, ensemble_data_to_numpy
from thermalporous_torch.precond import CPRConfig
from thermalporous_torch.solve import NewtonConfig, adjoint_gradients
from thermalporous_torch.solve import ensemble_adjoint_gradients as t_ens_adjoint
from thermalporous_torch.solve import record_ensemble_trajectory as t_record_e
from thermalporous_tpu.dist import make_ensemble_step_fn as j_make_ensemble_step_fn
from thermalporous_tpu.dist import stack_ensemble as j_stack_ensemble
from thermalporous_tpu.models import TwoPhaseModel as JTwoPhaseModel
from thermalporous_tpu.precond import CPRConfig as JCPRConfig
from thermalporous_tpu.precond import GMGConfig as JGMGConfig
from thermalporous_tpu.solve import NewtonConfig as JNewtonConfig
from thermalporous_tpu.solve import Simulator as JSimulator
from thermalporous_tpu.solve import adjoint_gradients as j_adjoint
from thermalporous_tpu.solve import ensemble_adjoint_gradients as j_ens_adjoint
from thermalporous_tpu.solve import record_ensemble_trajectory as j_record_e
from thermalporous_tpu.solve import record_trajectory as j_record

torch.set_num_threads(1)

DTS = [1800.0, 2700.0]
NEWTON = dict(rtol=1e-12, ksp_rtol=1e-10, ksp_maxiter=120)
SWEEP = dict(rtol=1e-11, maxiter=300)


def jterminal(u, d):
    return jnp.mean(u[1, :4, :3])


def tterminal(u, d):
    return torch.mean(u[1, :4, :3])


def trunning(u, dt, d):
    return dt * torch.mean(u[2, -3:, -3:]) + 1e-9 * torch.sum(d.phi * u[0])


@pytest.fixture(scope="module")
def ensemble():
    """The three members in both packages, each package's recorded ensemble
    trajectory, and the reference's ensemble sweep."""
    members = [_case(JTwoPhaseModel, shape=(8, 6), seed=s) for s in (1, 2, 3)]
    jm, jdatas = members[0][0], [d for _, d in members]
    carried = [carry_model_data(jm, d) for d in jdatas]
    tm, tdatas = carried[0][0], [d for _, d in carried]

    jdata_e = j_stack_ensemble(jdatas)
    jstep_e = jax.jit(j_make_ensemble_step_fn(jm, "cptr", JNewtonConfig(**NEWTON)))
    jstates = j_record_e(jstep_e, jnp.stack([jm.initial_state(d) for d in jdatas]), DTS,
                         jdata_e)
    jres = j_ens_adjoint(jm, jdata_e, jstates, DTS, terminal=jterminal, **SWEEP)

    tdata_e = stack_ensemble(tdatas)
    tstep_e = make_ensemble_step_fn(tm, "cptr", NewtonConfig(**NEWTON), device="cpu")
    tstates = t_record_e(tstep_e, torch.stack([tm.initial_state(d) for d in tdatas]), DTS,
                         tdata_e)
    return dict(jm=jm, jdatas=jdatas, jdata_e=jdata_e, jstep_e=jstep_e, jstates=jstates,
                jres=jres, tm=tm, tdatas=tdatas, tdata_e=tdata_e, tstep_e=tstep_e,
                tstates=tstates)


def _leaves(grad) -> list:
    """A gradient's leaves as a flat list of numpy arrays, in the reference's
    leaf order (``interop.ensemble_data_to_numpy``'s names)."""
    w = grad.wells
    out = []
    for leaf in (grad.tgeo, grad.tcond, grad.phi, w.wi, w.pbh, w.tinj, w.has_tinj, w.qrate,
                 w.qheat):
        out += [np.asarray(x) for x in (leaf if isinstance(leaf, tuple) else (leaf,))]
    return out


def _port_leaves(arrays: dict) -> list:
    out = []
    for name in ("tgeo", "tcond", "phi", "wi", "pbh", "tinj", "has_tinj", "qrate", "qheat"):
        leaf = arrays[name]
        out += list(leaf) if isinstance(leaf, tuple) else [leaf]
    return out


def test_recorded_states_match_the_references(ensemble):
    c = ensemble
    assert len(c["tstates"]) == len(DTS) + 1
    for got, ref in zip(c["tstates"][1:], c["jstates"][1:]):
        assert got.shape == tuple(ref.shape)
        for e in range(3):
            assert_states_close(got[e], np.asarray(ref)[e], 1e-8)


def test_ensemble_adjoint_matches_the_references_ensemble_sweep(ensemble):
    """At the reference test's tolerances: value rtol 1e-9, grad_u0 and every
    gradient leaf rtol 1e-6 / atol 1e-14; the lockstep FGMRES count and the
    convergence flag equal."""
    c = ensemble
    res = t_ens_adjoint(c["tm"], c["tdata_e"], c["tstates"], DTS, terminal=tterminal, **SWEEP)
    ref = c["jres"]
    assert bool(ref.converged) and res.converged
    assert res.ksp_iters == int(ref.ksp_iters)
    assert len(res.step_iters) == len(DTS) and sum(res.step_iters) == res.ksp_iters
    assert res.value.shape == (3,) and res.grad_u0.shape == tuple(ref.grad_u0.shape)
    np.testing.assert_allclose(res.value.numpy(), np.asarray(ref.value), rtol=1e-9)
    np.testing.assert_allclose(res.grad_u0.numpy(), np.asarray(ref.grad_u0), rtol=1e-6,
                               atol=1e-14)
    got = _port_leaves(ensemble_data_to_numpy(res.grad_data))
    want = _leaves(ref.grad_data)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-14)
    c["tres"] = res


def test_each_member_matches_the_references_solo_sweep(ensemble):
    """Every gradient of each member within 1e-8 (of the leaf's largest
    value) of the reference's solo sweep on its own solo trajectory, and the
    lockstep count the sum of the per-step maxima of the solo counts."""
    c = ensemble
    res = c.get("tres") or t_ens_adjoint(c["tm"], c["tdata_e"], c["tstates"], DTS,
                                         terminal=tterminal, **SWEEP)
    grads = ensemble_data_to_numpy(res.grad_data)
    solo_iters = []
    for i, jd in enumerate(c["jdatas"]):
        sim = JSimulator(c["jm"], jd, precond="cptr", newton_cfg=JNewtonConfig(**NEWTON))
        states = j_record(sim, c["jm"].initial_state(jd), DTS)
        ref = j_adjoint(c["jm"], jd, states, DTS, terminal=jterminal, **SWEEP)
        assert abs(float(res.value[i]) - float(ref.value)) <= 1e-8 * abs(float(ref.value))
        gu0 = np.asarray(ref.grad_u0)
        assert np.abs(res.grad_u0[i].numpy() - gu0).max() <= 1e-8 * np.abs(gu0).max()
        member = {k: tuple(x[i] for x in v) if isinstance(v, tuple) else v[i]
                  for k, v in grads.items()}
        for a, b in zip(_port_leaves(member), _leaves(ref.grad_data)):
            assert np.abs(a - b).max() <= 1e-8 * np.abs(b).max()
        # the port's solo sweep of this member gives the ensemble's member
        # bits and its own per-step counts
        solo = adjoint_gradients(c["tm"], c["tdatas"][i], [s[i] for s in c["tstates"]], DTS,
                                 terminal=tterminal, **SWEEP)
        assert torch.equal(solo.grad_u0, res.grad_u0[i])
        assert torch.equal(solo.grad_data.fields, res.grad_data.fields[i])
        solo_iters.append(solo.step_iters)
    assert res.step_iters == [max(col) for col in zip(*solo_iters)]


def test_running_objective_member_by_member(ensemble):
    """Terminal and running objectives together: each member bitwise its
    port solo sweep; the lockstep count the sum of the per-step maxima, not
    the sum over members."""
    c = ensemble
    res = t_ens_adjoint(c["tm"], c["tdata_e"], c["tstates"], DTS, terminal=tterminal,
                        running=trunning, **SWEEP)
    assert res.converged
    solos = [adjoint_gradients(c["tm"], c["tdatas"][i], [s[i] for s in c["tstates"]], DTS,
                               terminal=tterminal, running=trunning, **SWEEP)
             for i in range(3)]
    for i, solo in enumerate(solos):
        assert torch.equal(res.value[i], solo.value)
        assert torch.equal(res.grad_u0[i], solo.grad_u0)
        assert torch.equal(res.grad_data.member(i).fields, solo.grad_data.fields)
    assert res.step_iters == [max(col) for col in zip(*(s.step_iters for s in solos))]
    assert res.ksp_iters == sum(res.step_iters) <= sum(s.ksp_iters for s in solos)


def test_nonconvergence_names_the_members(ensemble):
    """``record_ensemble_trajectory`` raises ``RuntimeError`` with the
    reference's message naming the members whose step did not converge."""
    c = ensemble

    def jstep(u, dt_e, d):
        return u, types.SimpleNamespace(converged=jnp.asarray([True, False, False]))

    def tstep(u, dt_e, d):
        return u, types.SimpleNamespace(converged=torch.tensor([True, False, False]))

    with pytest.raises(RuntimeError) as jerr:
        j_record_e(jstep, c["jstates"][0], DTS[:1], c["jdata_e"])
    with pytest.raises(RuntimeError) as terr:
        t_record_e(tstep, c["tstates"][0], DTS[:1], c["tdata_e"])
    assert str(terr.value) == str(jerr.value)
    assert "members [1, 2] did not converge" in str(terr.value)


def test_adaptive_coarsening_and_objectives_refused_as_the_reference_does(ensemble):
    c = ensemble
    jpc = JCPRConfig(gmg=JGMGConfig(coarsen="adaptive", **OPTION_GMG))
    tpc = config_from_dict(CPRConfig, dataclasses.asdict(jpc))
    with pytest.raises(ValueError) as jerr:
        j_ens_adjoint(c["jm"], c["jdata_e"], c["jstates"], DTS, terminal=jterminal, pc_cfg=jpc)
    with pytest.raises(ValueError) as terr:
        t_ens_adjoint(c["tm"], c["tdata_e"], c["tstates"], DTS, terminal=tterminal, pc_cfg=tpc)
    assert str(terr.value) == str(jerr.value)
    assert str(terr.value).startswith("ensemble adjoints need a shared multigrid schedule")
    with pytest.raises(ValueError, match="objective"):
        t_ens_adjoint(c["tm"], c["tdata_e"], c["tstates"], DTS)
    with pytest.raises(ValueError, match="dts"):
        t_ens_adjoint(c["tm"], c["tdata_e"], c["tstates"][:-1], DTS, terminal=tterminal)
