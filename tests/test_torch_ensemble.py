"""Port parity of the ensemble axis (``thermalporous_torch/dist/ensemble.py``)
against the JAX package, f64 on the CPU.

- The reference's own case (``tests/test_sharding.py``'s ensemble test):
  8×8 two-phase, four members varying the injector's p_bh and T_inj and the
  permeability, four Δt: the port's ensemble step against the reference's
  jitted vmapped one, identical per-member counts and states within rtol
  1e-12 / atol 1e-9.
- Each port member bitwise its port solo step, in order and in reverse
  order (no state carried from one member to the next).
- A 6×6×4 gravity case with adaptive coarsening: both packages refuse it
  with the same text, then agree with ``level_factors`` planned from
  member 0.
- ``stack_ensemble`` against the reference's stacked leaves, and
  ``shard_ensemble`` over one and two CPU "devices".
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import (
    OPTION_GMG,
    PORT_DIR,
    carry_model_data,
    forbidden_imports,
    model_case,
)
from thermalporous_torch.dist import make_ensemble_step_fn, shard_ensemble, stack_ensemble
from thermalporous_torch.solve.ensemble_data import Blocks, EnsembleData, members
from thermalporous_torch.interop import config_from_dict, ensemble_data_to_numpy
from thermalporous_torch.precond import CPRConfig
from thermalporous_torch.precond.cpr import resolve_adaptive_coarsening
from thermalporous_torch.solve import NewtonConfig, make_step_fn
from thermalporous_tpu.core import Grid as JGrid
from thermalporous_tpu.dist import make_ensemble_step_fn as j_make_ensemble_step_fn
from thermalporous_tpu.dist import stack_ensemble as j_stack_ensemble
from thermalporous_tpu.models import TwoPhaseModel as JTwoPhaseModel
from thermalporous_tpu.models import make_problem_data as j_make_problem_data
from thermalporous_tpu.physics import PhysicalParams as JPhysicalParams
from thermalporous_tpu.physics import Well as JWell
from thermalporous_tpu.precond import CPRConfig as JCPRConfig
from thermalporous_tpu.precond import GMGConfig as JGMGConfig
from thermalporous_tpu.precond.cpr import resolve_adaptive_coarsening as j_resolve
from thermalporous_tpu.solve import NewtonConfig as JNewtonConfig

torch.set_num_threads(1)

DTS = [600.0, 900.0, 1200.0, 1500.0]
CFG = dict(rtol=1e-9, ksp_rtol=1e-7)


@pytest.fixture(scope="module")
def reference_case():
    """The reference test's four members (seed 3) in both packages, and the
    reference's vmapped step on them."""
    pp = JPhysicalParams()
    n = 8
    g = JGrid(shape=(n, n), spacing=(10.0, 10.0), thickness=5.0)
    jm = JTwoPhaseModel(g, pp, s_init=0.2)
    rng = np.random.default_rng(3)
    jdatas = []
    for e in range(4):
        wells = [JWell(cells=((0, 0),), control="bhp", p_bh=(3.0 + 0.3 * e) * 1e7,
                       T_inj=400.0 + 10.0 * e),
                 JWell(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7)]
        kx = 1e-13 * np.exp(0.4 * rng.standard_normal(g.shape))
        jdatas.append(j_make_problem_data(g, pp, kx=kx, phi=0.2, wells=wells))
    carried = [carry_model_data(jm, d) for d in jdatas]
    tm, tdatas = carried[0][0], [d for _, d in carried]

    jdata_e = j_stack_ensemble(jdatas)
    ju0_e = jnp.stack([jm.initial_state(d) for d in jdatas])
    step_e = jax.jit(j_make_ensemble_step_fn(jm, "cptr", JNewtonConfig(**CFG)))
    ju1_e, jst_e = step_e(ju0_e, jnp.asarray(DTS, ju0_e.dtype), jdata_e)
    return dict(jm=jm, jdatas=jdatas, jdata_e=jdata_e, ju1_e=np.asarray(ju1_e),
                jiters=np.asarray(jst_e.iters), jksp=np.asarray(jst_e.ksp_iters),
                tm=tm, tdatas=tdatas)


def _port_ensemble(c, order=None):
    order = list(range(len(c["tdatas"]))) if order is None else order
    datas = [c["tdatas"][i] for i in order]
    data_e = stack_ensemble(datas)
    u0_e = torch.stack([c["tm"].initial_state(d) for d in datas])
    dt_e = torch.tensor([DTS[i] for i in order], dtype=torch.float64)
    step_e = make_ensemble_step_fn(c["tm"], "cptr", NewtonConfig(**CFG), device="cpu")
    return step_e(u0_e, dt_e, data_e)


@pytest.fixture(scope="module")
def port_forward(reference_case):
    """The port's ensemble step on the members in order, and each member's
    solo step."""
    c = reference_case
    solo = make_step_fn(c["tm"], "cptr", NewtonConfig(**CFG), device="cpu")
    solos = [solo(c["tm"].initial_state(d), dt, d) for d, dt in zip(c["tdatas"], DTS)]
    return _port_ensemble(c), solos


def test_ensemble_step_matches_the_references_vmapped_step(reference_case, port_forward):
    c = reference_case
    u1_e, st_e = port_forward[0]
    assert u1_e.shape == c["ju1_e"].shape
    for name in ("iters", "ksp_iters", "norm0", "norm", "converged", "failed"):
        assert getattr(st_e, name).shape == (4,), name
    assert st_e.iters.dtype == torch.int32 and st_e.converged.dtype == torch.bool
    assert bool(st_e.converged.all()) and not bool(st_e.failed.any())
    assert st_e.iters.tolist() == c["jiters"].tolist()
    assert st_e.ksp_iters.tolist() == c["jksp"].tolist()
    for e in range(4):
        np.testing.assert_allclose(u1_e[e].numpy(), c["ju1_e"][e], rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("order", ["forward", "reverse"])
def test_each_member_is_bitwise_its_solo_step(reference_case, port_forward, order):
    """Each member of the port's ensemble gives its solo step's bits and
    counts, whichever member ran before it."""
    idx = [0, 1, 2, 3] if order == "forward" else [3, 2, 1, 0]
    u1_e, st_e = port_forward[0] if order == "forward" else _port_ensemble(reference_case, idx)
    for pos, i in enumerate(idx):
        u, st = port_forward[1][i]
        assert torch.equal(u1_e[pos], u), (order, i)
        assert (int(st_e.iters[pos]), int(st_e.ksp_iters[pos])) == (st.iters, st.ksp_iters)
        assert float(st_e.norm[pos]) == st.norm


def test_stack_ensemble_matches_the_references_leaves(reference_case):
    c = reference_case
    data_e = stack_ensemble(c["tdatas"])
    assert isinstance(data_e, EnsembleData) and len(data_e) == 4
    assert data_e.fields.shape == (4,) + tuple(c["tdatas"][0].fields.shape)
    got = ensemble_data_to_numpy(data_e)
    ref = c["jdata_e"]
    w = ref.wells
    want = dict(tgeo=ref.tgeo, tcond=ref.tcond, phi=ref.phi, wi=w.wi, pbh=w.pbh, tinj=w.tinj,
                has_tinj=w.has_tinj, qrate=w.qrate, qheat=w.qheat)
    assert set(got) == set(want)
    for name, r in want.items():
        pairs = zip(got[name], r) if isinstance(r, tuple) else [(got[name], r)]
        for a, b in pairs:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    # a member is a 2D ProblemData of its own tensor
    m1 = data_e.member(1)
    assert m1.dim == 2 and torch.equal(m1.fields, c["tdatas"][1].fields)
    assert m1.fields.data_ptr() != data_e.fields.data_ptr()


@pytest.mark.parametrize("devices", [["cpu"], ["cpu", "cpu"]], ids=["one", "two"])
def test_shard_ensemble_places_whole_members_in_blocks(reference_case, port_forward,
                                                      devices):
    c = reference_case
    data_e = stack_ensemble(c["tdatas"])
    u0_e = torch.stack([c["tm"].initial_state(d) for d in c["tdatas"]])
    tree = shard_ensemble({"u": u0_e, "data": data_e, "pair": (u0_e, u0_e[:, 0])}, devices)
    u_s, d_s = tree["u"], tree["data"]
    size = 4 // len(devices)
    for x, full in ((u_s, u0_e), (d_s.fields, data_e.fields), (tree["pair"][1], u0_e[:, 0])):
        assert isinstance(x, Blocks) and len(x) == len(devices)
        for d, block in enumerate(x):
            assert block.device == torch.device(devices[d])
            assert torch.equal(block, full[d * size:(d + 1) * size])
    assert len(d_s) == 4 and torch.equal(d_s.member(3).fields, c["tdatas"][3].fields)
    # the sharded ensemble steps as the stacked one does, in its own layout
    step_e = make_ensemble_step_fn(c["tm"], "cptr", NewtonConfig(**CFG), device="cpu")
    dt_e = torch.tensor(DTS, dtype=torch.float64)
    want, st = port_forward[0]
    got, st_s = step_e(u_s, dt_e, d_s)
    assert isinstance(got, Blocks) and [len(b) for b in got] == [size] * len(devices)
    assert torch.equal(torch.cat(list(got)), want)
    assert torch.equal(st_s.ksp_iters, st.ksp_iters)
    with pytest.raises(ValueError, match="split evenly"):
        shard_ensemble(u0_e[:3], ["cpu", "cpu"])


def test_adaptive_coarsening_refused_then_planned_from_member_zero():
    """The 6×6×4 gravity case with adaptive coarsening: both packages refuse
    a per-member schedule with the same text; with level_factors planned
    from member 0's first stencil both give the same counts and states."""
    cases = [model_case((6, 6, 4), seed=s, rate_well=False, heater=False) for s in (4, 5)]
    jm, tm = cases[0]["jm"], cases[0]["tm"]
    jpc = JCPRConfig(gmg=JGMGConfig(coarsen="adaptive", **OPTION_GMG))
    tpc = config_from_dict(CPRConfig, dataclasses.asdict(jpc))
    jcfg, tcfg = JNewtonConfig(**CFG), NewtonConfig(**CFG)
    with pytest.raises(ValueError) as jerr:
        j_make_ensemble_step_fn(jm, "cptr", jcfg, jpc)
    with pytest.raises(ValueError) as terr:
        make_ensemble_step_fn(tm, "cptr", tcfg, tpc, device="cpu")
    assert str(terr.value) == str(jerr.value)

    dt0 = 1800.0
    ju0 = jm.initial_state(cases[0]["jd"])
    jpc = j_resolve(jm.assemble_stencil(ju0, ju0, dt0, cases[0]["jd"]), jpc)
    tu0 = tm.initial_state(cases[0]["td"])
    tpc = resolve_adaptive_coarsening(tm.assemble_stencil(tu0, tu0, dt0, cases[0]["td"]), tpc)
    assert tuple(tpc.gmg.level_factors) == tuple(map(tuple, jpc.gmg.level_factors))
    assert len(tpc.gmg.level_factors) >= 2

    jdata_e = j_stack_ensemble([c["jd"] for c in cases])
    ju0_e = jnp.stack([jm.initial_state(c["jd"]) for c in cases])
    ju_e, jst = jax.jit(j_make_ensemble_step_fn(jm, "cptr", jcfg, jpc))(
        ju0_e, jnp.asarray([dt0, 2 * dt0]), jdata_e)
    tdata_e = stack_ensemble([c["td"] for c in cases])
    tu0_e = torch.stack([tm.initial_state(c["td"]) for c in cases])
    tu_e, tst = make_ensemble_step_fn(tm, "cptr", tcfg, tpc, device="cpu")(
        tu0_e, torch.tensor([dt0, 2 * dt0], dtype=torch.float64), tdata_e)
    assert bool(tst.converged.all())
    assert tst.iters.tolist() == np.asarray(jst.iters).tolist()
    assert tst.ksp_iters.tolist() == np.asarray(jst.ksp_iters).tolist()
    np.testing.assert_allclose(tu_e.numpy(), np.asarray(ju_e), rtol=1e-12, atol=1e-9)
    assert members(tu_e)[1].shape == tuple(ju_e.shape[1:])


def test_dist_imports_no_jax():
    assert forbidden_imports(PORT_DIR / "dist") == []
