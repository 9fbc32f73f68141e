"""Port parity of blocked stepping (``TimeConfig.block_steps > 1``,
``make_block_step_fn``; f64, CPU).

Two reference cases, each compiled once as a block (module fixtures):
``tests/test_balance.py``'s 8×8 two-phase BHP pair at ``block_steps=3``
(the ``Simulator`` run's records, and the block function from the initial
state with a ``t_end`` it reaches partway), and
``tests/test_io.py``'s 12×12 failure-memory case (``max_iters=4``, growth
4, ``fail_frac=0.6``) in blocks of 2 steps, whose third block fails an
attempt and retries.  Each ``BlockStats`` field equals the reference's:
counts, ``ok`` and ``dt_used`` exactly, the initial residual norm at 1e-8,
``src_dt`` at 1e-10, and each final norm below the Newton tolerance in both
(the final norms of two converged solves differ in their leading digits).
Then, on the port alone: a dead block raises after its callbacks, the
blocked and host loops give the same audit, and a resume from a block-mode
checkpoint rejoins the uninterrupted run bit for bit.
"""

import dataclasses
import glob

import numpy as np
import pytest
import torch

from tests._torch_parity import assert_states_close, carry_model_data, n, t
from thermalporous_torch.interop import config_from_dict
from thermalporous_torch.io import BalanceAuditor, CheckpointManager, load_checkpoint
from thermalporous_torch.solve import (
    NewtonConfig,
    Simulator,
    TimeConfig,
    make_block_step_fn,
)
from thermalporous_tpu.core import Grid as JGrid
from thermalporous_tpu.models import TwoPhaseModel as JTwoPhaseModel
from thermalporous_tpu.models import make_problem_data as j_make_problem_data
from thermalporous_tpu.physics import PhysicalParams as JPhysicalParams
from thermalporous_tpu.physics import Well as JWell
from thermalporous_tpu.solve import NewtonConfig as JNewtonConfig
from thermalporous_tpu.solve import Simulator as JSimulator
from thermalporous_tpu.solve import TimeConfig as JTimeConfig

torch.set_num_threads(1)

TIGHT = dict(rtol=1e-11, max_iters=20)
T_END = 4 * 3600.0


def _configs(newton: dict, time: dict):
    jn, jt = JNewtonConfig(**newton), JTimeConfig(**time)
    return (jn, jt, config_from_dict(NewtonConfig, dataclasses.asdict(jn)),
            config_from_dict(TimeConfig, dataclasses.asdict(jt)))


def _record(r):
    return (r.step, r.t, r.dt, r.newton_iters, r.ksp_iters, r.retries, r.next_dt, r.dt_cap,
            r.state_consistent)


def _stats_equal(got, ref, rtol_newton: float) -> None:
    for key in ("newton", "ksp", "retries", "ok", "dt_used"):
        assert n(getattr(got, key)).tolist() == np.asarray(getattr(ref, key)).tolist(), key
    np.testing.assert_allclose(n(got.norm0), np.asarray(ref.norm0), rtol=1e-8)
    np.testing.assert_allclose(n(got.src_dt), np.asarray(ref.src_dt), rtol=1e-10, atol=0)
    ok = np.asarray(ref.ok)
    for norms in (n(got.norm), np.asarray(ref.norm)):
        assert (norms[ok] <= rtol_newton * np.asarray(ref.norm0)[ok]).all()
        assert (norms[~ok] == 0.0).all() or not (~ok).any()


def _port_block(tm, tn, tt, n_steps):
    return make_block_step_fn(tm, "cptr", tn, None, tt, n_steps=n_steps, device="cpu")


@pytest.fixture(scope="module")
def bhp():
    """The 8×8 pair at block_steps=3 through both packages' Simulator; the
    port's run with an auditor and a checkpoint at every consistent
    record."""
    pp = JPhysicalParams()
    g = JGrid(shape=(8, 8), spacing=(10.0, 10.0), thickness=5.0)
    wells = [JWell(cells=((0, 0),), control="bhp", p_bh=3.0e7, T_inj=420.0),
             JWell(cells=((7, 7),), control="bhp", p_bh=1.0e7)]
    jd = j_make_problem_data(g, pp, kx=2e-13, phi=0.2, wells=wells)
    jm = JTwoPhaseModel(g, pp, s_init=0.3)
    jn, jt, tn, tt = _configs(TIGHT, dict(dt_init=1800.0, block_steps=3))
    jsim = JSimulator(jm, jd, precond="cptr", newton_cfg=jn, time_cfg=jt)
    jres = jsim.run(t_end=T_END)

    tm, td = carry_model_data(jm, jd)
    sim = Simulator(tm, td, precond="cptr", newton_cfg=tn, time_cfg=tt, device="cpu")
    u0 = tm.initial_state(td)
    aud = BalanceAuditor(tm, td, u0)
    return dict(jm=jm, jd=jd, jsim=jsim, jres=jres, tm=tm, td=td, tn=tn, tt=tt, sim=sim,
                u0=u0, aud=aud)


@pytest.fixture(scope="module")
def bhp_run(bhp, tmp_path_factory):
    ckdir = str(tmp_path_factory.mktemp("blocked_ck"))
    mgr = CheckpointManager(ckdir, every=1, keep=100)

    def callback(step, t_, u, rec):
        bhp["aud"](step, t_, u, rec)
        mgr(step, t_, u, rec)

    res = bhp["sim"].run(t_end=T_END, u0=bhp["u0"], callback=callback)
    return res, ckdir


def test_blocked_run_records_equal_the_reference(bhp, bhp_run):
    res, _ = bhp_run
    jres = bhp["jres"]
    assert [_record(r) for r in res.records] == [_record(r) for r in jres.records]
    assert [r.state_consistent for r in res.records] == [False, False, True, True]
    for r, jr in zip(res.records, jres.records):
        np.testing.assert_allclose(r.src_dt, jr.src_dt, rtol=1e-10, atol=0)
        assert r.wall_s > 0.0
    assert_states_close(res.u, np.asarray(jres.u), 1e-8)
    assert res.t == jres.t == T_END


def test_block_fn_equals_the_reference(bhp):
    """From the initial state with a t_end that 1800 + 2700 s reach: the
    third step does nothing."""
    t_end = 4500.0
    ju0 = bhp["jm"].initial_state(bhp["jd"])
    ju, jdt, jt_, jdead, jcap, jst = bhp["jsim"]._block(ju0, 1800.0, 0.0, t_end, bhp["jd"],
                                                        float("inf"))
    block = _port_block(bhp["tm"], bhp["tn"], bhp["tt"], 3)
    u, dt, t_, dead, cap, st = block(bhp["u0"], 1800.0, 0.0, t_end, bhp["td"])
    _stats_equal(st, jst, 1e-11)
    assert (dt, t_, dead, cap) == (float(jdt), float(jt_), bool(jdead), float(jcap))
    assert_states_close(u, np.asarray(ju), 1e-8)
    assert n(st.ok).tolist() == [True, True, False] and t_ == t_end
    assert not dead and n(st.src_dt)[2].tolist() == [0.0, 0.0, 0.0]


def test_block_fn_with_failures_equals_the_reference():
    """tests/test_io.py's failure-memory case in blocks of 2: the third
    block (steps 5-6, from the reference's state and clock after the first
    two) has a failed attempt, a retry and the cap it leaves."""
    import jax

    from thermalporous_tpu.solve.timeloop import make_block_step_fn as j_make_block_step_fn

    pp = JPhysicalParams()
    nx = 12
    g = JGrid(shape=(nx, nx), spacing=(10.0, 10.0), thickness=5.0)
    kx = 2e-13 * np.exp(1.0 * np.random.default_rng(3).standard_normal(g.shape))
    wells = [JWell(cells=((0, 0),), control="bhp", p_bh=3.8e7, T_inj=430.0),
             JWell(cells=((nx - 1, nx - 1),), control="bhp", p_bh=8.0e6)]
    jd = j_make_problem_data(g, pp, kx=kx, phi=0.2, wells=wells)
    jm = JTwoPhaseModel(g, pp, s_init=0.25)
    jn, jt, tn, tt = _configs(
        dict(max_iters=4, rtol=1e-8),
        dict(dt_init=600.0, growth=4.0, dt_max=1e7, grow_below=5, fail_frac=0.6,
             fail_relax=1.1))
    jblock = jax.jit(j_make_block_step_fn(jm, "cptr", jn, None, jt, n_steps=2))
    # Python floats in every call: one compile of the block
    carry = (jm.initial_state(jd), 600.0, 0.0, float("inf"))
    for _ in range(2):
        ju, jdt, jt_, jdead, jcap, _ = jblock(carry[0], carry[1], carry[2], 1.2e6, jd,
                                              carry[3])
        assert not bool(jdead)
        carry = (ju, float(jdt), float(jt_), float(jcap))
    assert carry[3] == float("inf")
    ju, jdt, jt_, jdead, jcap, jst = jblock(carry[0], carry[1], carry[2], 1.2e6, jd,
                                            carry[3])

    tm, td = carry_model_data(jm, jd)
    block = _port_block(tm, tn, tt, 2)
    u, dt, t_, dead, cap, st = block(t(np.asarray(carry[0])), *carry[1:3], 1.2e6, td,
                                     carry[3])
    _stats_equal(st, jst, 1e-8)
    assert n(st.retries).tolist() == [1, 0]
    assert (dt, t_, dead, cap) == (float(jdt), float(jt_), bool(jdead), float(jcap))
    assert cap < float("inf")
    assert_states_close(u, np.asarray(ju), 1e-8)


def test_dead_block_raises_after_its_callbacks(bhp):
    """A 100× growth after an easy first step fails at max_iters=3 with no
    retries: the block dies at its second step, its first step's record is
    delivered, then the run raises."""
    tn = dataclasses.replace(bhp["tn"], max_iters=3)
    tt = TimeConfig(dt_init=1800.0, growth=100.0, max_retries=0, block_steps=3)
    sim = Simulator(bhp["tm"], bhp["td"], precond="cptr", newton_cfg=tn, time_cfg=tt,
                    device="cpu")
    seen = []
    with pytest.raises(RuntimeError, match="retries were exhausted"):
        sim.run(t_end=T_END, callback=lambda s, t_, u, r: seen.append(_record(r)))
    assert seen == [(1, 1800.0, 1800.0, 3, seen[0][4], 0, 180000.0, None, True)]
    block = _port_block(bhp["tm"], tn, tt, 3)
    *_, dead, _, st = block(bhp["u0"], 1800.0, 0.0, T_END, bhp["td"])
    assert dead and n(st.ok).tolist() == [True, False, False]
    assert n(st.newton).tolist()[1:] == [0, 0] and n(st.dt_used).tolist()[1:] == [0.0, 0.0]


def test_blocked_and_host_audits_agree(bhp, bhp_run):
    res, _ = bhp_run
    aud_b = bhp["aud"]
    rep = aud_b.report()
    assert rep["complete"] and rep["skipped_records"] == 0 and rep["steps"] == res.steps
    for lab, row in rep["rows"].items():
        assert row["rel_error"] < 1e-9, (lab, row)
    host = Simulator(bhp["tm"], bhp["td"], precond="cptr", newton_cfg=bhp["tn"],
                     time_cfg=dataclasses.replace(bhp["tt"], block_steps=1), device="cpu")
    aud_h = BalanceAuditor(bhp["tm"], bhp["td"], bhp["u0"])
    hres = host.run(t_end=T_END, u0=bhp["u0"], callback=aud_h)
    assert [r.dt for r in hres.records] == [r.dt for r in res.records]
    assert torch.equal(hres.u, res.u)
    assert aud_b.steps == aud_h.steps
    np.testing.assert_allclose(aud_b.cum, aud_h.cum, rtol=1e-12)
    np.testing.assert_allclose(aud_b.cum_abs, aud_h.cum_abs, rtol=1e-12)
    np.testing.assert_array_equal(aud_b.m_last, aud_h.m_last)


def test_resume_from_a_block_checkpoint_rejoins_the_run(bhp, bhp_run):
    res, ckdir = bhp_run
    written = sorted(glob.glob(f"{ckdir}/ckpt_*.npz"))
    assert len(written) == sum(r.state_consistent for r in res.records) == 2
    u0, t0, dt0, step0, meta = load_checkpoint(written[-2], device="cpu")
    assert (step0, meta) == (3, {})
    cont = bhp["sim"].run(t_end=T_END, u0=u0, dt0=dt0, t0=t0, step0=step0)
    assert cont.t == res.t
    assert torch.equal(cont.u, res.u)
    assert [_record(r) for r in cont.records] == [_record(r) for r in res.records[3:]]
