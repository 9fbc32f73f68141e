"""Port parity of control schedules (``Simulator.run_schedule``; f64, CPU)
on ``tests/test_schedule.py``'s 10×10 two-phase case: a rate injector and a
BHP producer, the injector shut in at 2 h (the reference's test: 4 h),
the run to 4 h.

Pins: a one-segment schedule gives a plain run's bits; the shut-in's
records equal the reference's ``run_schedule`` (Δt exactly; Newton, FGMRES
and retries equal; states within 1e-8), a step lands on the boundary and
the switch takes effect; the balance audit closes across the switch
through ``set_data``; the case's own data tensor is never written.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests._torch_parity import assert_states_close, carry_model_data
from thermalporous_torch.interop import config_from_dict
from thermalporous_torch.io import BalanceAuditor
from thermalporous_torch.physics import Well, build_well_fields, per_well_masks, well_rates
from thermalporous_torch.solve import NewtonConfig, Simulator, TimeConfig
from thermalporous_tpu import io as jio
from thermalporous_tpu.core import Grid as JGrid
from thermalporous_tpu.models import TwoPhaseModel as JTwoPhaseModel
from thermalporous_tpu.models import make_problem_data as j_make_problem_data
from thermalporous_tpu.physics import PhysicalParams as JPhysicalParams
from thermalporous_tpu.physics import Well as JWell
from thermalporous_tpu.physics import build_well_fields as j_build_well_fields
from thermalporous_tpu.solve import NewtonConfig as JNewtonConfig
from thermalporous_tpu.solve import Simulator as JSimulator
from thermalporous_tpu.solve import TimeConfig as JTimeConfig

torch.set_num_threads(1)

N = 10
T_SWITCH, T_END = 2 * 3600.0, 4 * 3600.0
NEWTON = dict(rtol=1e-10)


def _reference_case():
    pp = JPhysicalParams()
    g = JGrid(shape=(N, N), spacing=(10.0, 10.0), thickness=5.0)
    kx = 2e-13 * np.exp(0.5 * np.random.default_rng(7).standard_normal(g.shape))
    inj = JWell(cells=((0, 0),), control="rate", rate=1.0, T_inj=420.0, name="INJ")
    prod = JWell(cells=((N - 1, N - 1),), control="bhp", p_bh=1.0e7, name="PROD")
    data = j_make_problem_data(g, pp, kx=kx, phi=0.2, wells=[inj, prod])
    return JTwoPhaseModel(g, pp, s_init=0.3), data, kx, prod


def _record(r):
    return (r.step, r.t, r.dt, r.newton_iters, r.ksp_iters, r.retries, r.next_dt)


@pytest.fixture(scope="module")
def runs():
    """The shut-in schedule through both packages, each with its auditor."""
    jm, jd, kx, jprod = _reference_case()
    jwf2 = j_build_well_fields(jm.grid, [jprod], [], kx=kx, ky=kx)
    jsim = JSimulator(jm, jd, precond="cptr", newton_cfg=JNewtonConfig(**NEWTON),
                      time_cfg=JTimeConfig(dt_init=1800.0))
    ju0 = jm.initial_state(jd)
    jaud = jio.BalanceAuditor(jm, jd, ju0)
    jres = jsim.run_schedule([(0.0, jd.wells), (T_SWITCH, jwf2)], t_end=T_END, u0=ju0,
                             callback=jaud)

    tm, td = carry_model_data(jm, jd)
    fields0 = td.fields.clone()
    prod = Well(cells=jprod.cells, control="bhp", p_bh=jprod.p_bh, name="PROD")
    wf2 = build_well_fields(tm.grid, [prod], [], kx=kx, ky=kx, dtype=torch.float64,
                            device="cpu")
    newton = config_from_dict(NewtonConfig, dataclasses.asdict(JNewtonConfig(**NEWTON)))
    sim = Simulator(tm, td, precond="cptr", newton_cfg=newton,
                    time_cfg=TimeConfig(dt_init=1800.0), device="cpu")
    u0 = tm.initial_state(td)
    aud = BalanceAuditor(tm, td, u0)
    res = sim.run_schedule([(0.0, td.wells), (T_SWITCH, wf2)], t_end=T_END, u0=u0,
                           callback=aud)
    return dict(jres=jres, jaud=jaud, tm=tm, td=td, fields0=fields0, sim=sim, res=res,
                aud=aud, prod=prod)


def test_shut_in_records_equal_the_reference(runs):
    jres, res = runs["jres"], runs["res"]
    assert [_record(r) for r in res.records] == [_record(r) for r in jres.records]
    assert [r.dt_cap for r in res.records] == [r.dt_cap for r in jres.records]
    assert_states_close(res.u, np.asarray(jres.u), 1e-8)
    assert (res.t, res.steps, res.total_newton, res.total_ksp) == (
        jres.t, jres.steps, jres.total_newton, jres.total_ksp)


def test_shut_in_switches_exactly_at_the_boundary(runs):
    res, sim, tm = runs["res"], runs["sim"], runs["tm"]
    assert res.t == T_END
    assert any(r.t == T_SWITCH for r in res.records)
    assert [r.step for r in res.records] == list(range(1, len(res.records) + 1))
    rates = well_rates(tm, res.u, sim.data, per_well_masks(tm.grid, [runs["prod"]]))
    assert "INJ" not in rates
    assert rates["PROD"]["water_kg_s"] + rates["PROD"]["oil_kg_s"] < 0.0
    q = tm.source_totals(res.u, sim.data)
    assert float(q[0] + q[2]) < 0.0
    # the segment's data is a new tensor; the case's own is as it was
    assert sim.data is not runs["td"]
    assert torch.equal(runs["td"].fields, runs["fields0"])
    assert float(sim.data.wells.qrate.abs().sum()) == 0.0


def test_balance_closes_across_the_switch(runs):
    rep, jrep = runs["aud"].report(), runs["jaud"].report()
    assert rep["complete"] and rep["steps"] == runs["res"].steps
    for lab, row in rep["rows"].items():
        assert row["rel_error"] < 1e-9, (lab, row)
    # both regimes were seen: water went in, then stopped
    assert 0.0 < rep["rows"]["water_kg"]["cum_source"] < 1.0 * T_END
    np.testing.assert_allclose(runs["aud"].cum, runs["jaud"].cum, rtol=1e-8)
    assert jrep["steps"] == rep["steps"]


def test_one_segment_schedule_is_a_plain_run(runs):
    tm, td = runs["tm"], runs["td"]
    sim = Simulator(tm, td, precond="cptr", time_cfg=TimeConfig(dt_init=1800.0),
                    device="cpu")
    u0 = tm.initial_state(td)
    t_end = 3600.0
    plain = sim.run(t_end=t_end, u0=u0)
    sched = sim.run_schedule([(0.0, td.wells)], t_end=t_end, u0=u0)
    assert (sched.t, sched.steps) == (plain.t, plain.steps)
    assert torch.equal(sched.u, plain.u)
    assert [_record(r) for r in sched.records] == [_record(r) for r in plain.records]


def test_schedule_refuses_a_late_first_segment(runs):
    sim = Simulator(runs["tm"], runs["td"], device="cpu")
    with pytest.raises(ValueError, match="schedule must start"):
        sim.run_schedule([(10.0, runs["td"].wells)], t_end=100.0)
    with pytest.raises(ValueError, match="schedule must start"):
        sim.run_schedule([], t_end=100.0)
