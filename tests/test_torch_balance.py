"""Port parity of the material/energy balance audit (f64, CPU).

``in_place_totals`` and ``source_totals`` of both models against the
reference's at 1e-12 (2D and 3D, wells, a rate well, a heater, gravity);
``BalanceAuditor.report()`` against the reference's on
``tests/test_balance.py``'s short runs — the 8×8 two-phase BHP pair and the
6×6×4 single-phase case with a heater and a rate well — fed the same
records and states (the reference run's) at 1e-12 of each row's scale, and
the port's own run of each case closing below 1e-9 at the reference's
``TIGHT`` Newton settings with the reference run's Δt and counts.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests._torch_parity import F64, assert_states_close, carry_model_data, model_case, n, t
from thermalporous_torch.interop import config_from_dict
from thermalporous_torch.io import BalanceAuditor, format_balance
from thermalporous_torch.solve import NewtonConfig, Simulator, TimeConfig
from thermalporous_tpu import io as jio
from thermalporous_tpu.core import Grid as JGrid
from thermalporous_tpu.models import SinglePhaseModel as JSinglePhaseModel
from thermalporous_tpu.models import TwoPhaseModel as JTwoPhaseModel
from thermalporous_tpu.models import make_problem_data as j_make_problem_data
from thermalporous_tpu.physics import Heater as JHeater
from thermalporous_tpu.physics import PhysicalParams as JPhysicalParams
from thermalporous_tpu.physics import Well as JWell
from thermalporous_tpu.solve import NewtonConfig as JNewtonConfig
from thermalporous_tpu.solve import Simulator as JSimulator
from thermalporous_tpu.solve import TimeConfig as JTimeConfig

torch.set_num_threads(1)

#: tests/test_balance.py's Newton settings
TIGHT = dict(rtol=1e-11, max_iters=20)


@pytest.mark.parametrize("single_phase", [False, True], ids=["twophase", "singlephase"])
@pytest.mark.parametrize("shape", [(7, 6), (5, 4, 3)], ids=["2d", "3d"])
def test_totals_match_the_reference(shape, single_phase):
    c = model_case(shape, seed=3, single_phase=single_phase)
    for name in ("in_place_totals", "source_totals"):
        ref = np.asarray(getattr(c["jm"], name)(c["ju"], c["jd"]))
        got = getattr(c["tm"], name)(c["tu"], c["td"])
        assert got.shape == (c["tm"].nc,) and got.dtype == F64
        np.testing.assert_allclose(n(got), ref, rtol=1e-12, atol=0)


def test_totals_accumulate_in_f64_for_f32_states():
    c = model_case((6, 5), seed=4)
    u32, d32 = c["tu"].float(), type(c["td"])(c["td"].fields.float())
    for name in ("in_place_totals", "source_totals"):
        got = getattr(c["tm"], name)(u32, d32)
        assert got.dtype == F64
        ref = getattr(c["tm"], name)(u32.double(), type(d32)(d32.fields.double()))
        np.testing.assert_allclose(n(got), n(ref), rtol=1e-6)


def _two_phase_bhp():
    """tests/test_balance.py's blocked-mode pair: 8×8, BHP injector and
    producer."""
    pp = JPhysicalParams()
    nx = 8
    g = JGrid(shape=(nx, nx), spacing=(10.0, 10.0), thickness=5.0)
    wells = [JWell(cells=((0, 0),), control="bhp", p_bh=3.0e7, T_inj=420.0),
             JWell(cells=((nx - 1, nx - 1),), control="bhp", p_bh=1.0e7)]
    data = j_make_problem_data(g, pp, kx=2e-13, phi=0.2, wells=wells)
    return JTwoPhaseModel(g, pp, s_init=0.3), data, 1800.0, 4 * 3600.0


def _single_phase_heater():
    """tests/test_balance.py's 6×6×4 single-phase case: a rate injector, a
    BHP producer, a heater, gravity."""
    pp = JPhysicalParams()
    g = JGrid(shape=(6, 6, 4), spacing=(10.0, 10.0, 2.0))
    wells = [JWell(cells=((0, 0, 0),), control="rate", rate=0.5, T_inj=400.0, name="INJ"),
             JWell(cells=((5, 5, 3),), control="bhp", p_bh=1.2e7, name="PROD")]
    heaters = [JHeater(cells=((2, 2, 1),), power=5.0e4)]
    data = j_make_problem_data(g, pp, kx=1e-13, phi=0.25, wells=wells, heaters=heaters)
    return JSinglePhaseModel(g, pp), data, 900.0, 2 * 3600.0


def _close(got, ref, rtol: float) -> None:
    """Two auditors agree: counts equal, totals and integrals within
    ``rtol``, and each report row within ``rtol`` of its in-place total
    (a sum's rounding scales with the total, not with its change)."""
    assert (got.steps, got.skipped) == (ref.steps, ref.skipped)
    for key in ("m0", "m_last", "cum", "cum_abs"):
        np.testing.assert_allclose(getattr(got, key), getattr(ref, key), rtol=rtol, atol=0)
    g_rep, r_rep = got.report(), ref.report()
    assert g_rep["complete"] == r_rep["complete"]
    assert list(g_rep["rows"]) == list(r_rep["rows"])
    for i, (lab, r) in enumerate(r_rep["rows"].items()):
        g = g_rep["rows"][lab]
        scale = abs(ref.m0[i])
        denom = max(abs(r["delta_in_place"]), ref.cum_abs[i])
        for key in ("delta_in_place", "cum_source", "abs_error"):
            assert abs(g[key] - r[key]) <= rtol * scale, (lab, key, g[key], r[key])
        assert abs(g["rel_error"] - r["rel_error"]) <= rtol * scale / denom, (lab, g, r)


@pytest.mark.parametrize("make", [_two_phase_bhp, _single_phase_heater],
                         ids=["twophase_bhp", "singlephase_heater"])
def test_audit_matches_the_reference(make):
    jm, jd, dt_init, t_end = make()
    ju0 = jm.initial_state(jd)
    jsim = JSimulator(jm, jd, precond="cptr", newton_cfg=JNewtonConfig(**TIGHT),
                      time_cfg=JTimeConfig(dt_init=dt_init))
    jaud = jio.BalanceAuditor(jm, jd, ju0)
    seen = []

    def record(step, t_, u, rec):
        seen.append((step, t_, np.asarray(u), rec))
        jaud(step, t_, u, rec)

    jres = jsim.run(t_end=t_end, u0=ju0, callback=record)

    tm, td = carry_model_data(jm, jd)
    # the same records and states through the port's auditor
    aud = BalanceAuditor(tm, td, t(np.asarray(ju0)))
    for step, t_, u, rec in seen:
        aud(step, t_, t(u), rec)
    _close(aud, jaud, 1e-12)

    # the port's own run of the case: the same steps, and the audit closes
    newton = config_from_dict(NewtonConfig, dataclasses.asdict(JNewtonConfig(**TIGHT)))
    sim = Simulator(tm, td, precond="cptr", newton_cfg=newton,
                    time_cfg=TimeConfig(dt_init=dt_init), device="cpu")
    u0 = tm.initial_state(td)
    own = BalanceAuditor(tm, td, u0)
    res = sim.run(t_end=t_end, u0=u0, callback=own)
    assert ([(r.dt, r.newton_iters, r.ksp_iters) for r in res.records]
            == [(r.dt, r.newton_iters, r.ksp_iters) for r in jres.records])
    assert_states_close(res.u, np.asarray(jres.u), 1e-8)
    rep = own.report()
    assert rep["complete"] and rep["steps"] == res.steps
    for lab, row in rep["rows"].items():
        assert row["rel_error"] < 1e-9, (lab, row)
        assert row["cum_source"] != 0.0
    _close(own, jaud, 1e-8)
    txt = format_balance(rep)
    assert txt == jio.format_balance(rep)
    assert all(lab in txt for lab in jm.eq_labels) and "INCOMPLETE" not in txt


def test_blocked_records_and_incomplete_reports():
    """Records with ``src_dt`` add the block's integrals and refresh the
    totals only at state-consistent ones; host-loop records without a
    state are counted as skipped: as the reference's auditor does."""
    c = model_case((5, 4), seed=6, rate_well=False, heater=False)

    @dataclasses.dataclass
    class Rec:
        dt: float
        state_consistent: bool = True
        src_dt: tuple | None = None

    recs = [Rec(10.0, False, (1.0, -2.0, 3.0)), Rec(20.0, True, (0.5, 0.25, -1.0)),
            Rec(30.0, False), Rec(40.0)]
    auds = []
    for aud, u in ((BalanceAuditor(c["tm"], c["td"], c["tu0"]), c["tu"]),
                   (jio.BalanceAuditor(c["jm"], c["jd"], c["ju0"]), c["ju"])):
        for i, r in enumerate(recs):
            aud(i + 1, 0.0, u, r)
        auds.append(aud)
    rep = auds[0].report()
    assert not rep["complete"] and rep["skipped_records"] == 1 and rep["steps"] == 3
    _close(*auds, 1e-12)
    assert "INCOMPLETE" in format_balance(rep)
