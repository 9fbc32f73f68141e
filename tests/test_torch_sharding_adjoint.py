"""The adjoint, the weighted and variational transfers, ``krylov_op="jvp"``
and the ensemble over a grid decomposition, against the reference's checks
in ``tests/test_sharding.py``, on 4 gloo ranks on the CPU (a 2×2 mesh), in
one spawn while this process computes the references.

- ``Block.fold`` is the adjoint of ``Block.extend``: ⟨extend(x), y⟩ =
  ⟨x, fold(y)⟩ summed over the ranks, to 1e-14 of the sums' size, for
  rings 1–3 (and one ring per axis) and 0–2 leading axes, on a grid split
  at odd indices and on a split whose narrowest ranges are three cells;
  so is ``pad`` of ``owned``.  The data lie on a 2⁻¹⁰ lattice and the
  sums are exact, so the two sides agree to the last bit unless a slab
  is misrouted.  A side with no neighbour holds no ghosts,
  so the decomposed residual fills none and has no fill rule to route.
- ``HaloStencil.transpose()`` of the decomposed Jacobian is the whole
  Jacobian's ``BlockStencil.transpose()`` on every held row, to 1e-14.
- The decomposed CPTR apply under "weighted" and "variational" is the
  whole apply to 1e-12 of each component: on a 16×14×4 grid split at the
  odd index 7 along y (origin odd in one axis; that level does not coarsen
  y) and on a 32×32×4 grid whose second level, a wide or box stencil, is
  decomposed too.
- The counterpart of ``test_sharded_adjoint_matches_single_device``: the
  same 8×16 grid, seed 21, wells, Δt, objective and tolerances;
  ``grad_data.phi`` and ``tgeo[0]`` within 1e-8 of their size of the
  reference's, every solve converged; and the same sweep with a running
  objective only (its zero start in the owned layout), against the
  reference's with the same objective.
- The counterpart of ``test_sharded_variational_transfer_match`` (16×32,
  seed 11, ``transfer_floor=0.5``, ``max_coarse_cells=64``; the finest
  level decomposed), and the same with "weighted": the reference's Newton
  and FGMRES counts, p within 10 Pa and S within 1e-8; a
  ``krylov_op="jvp"`` step of the same case takes the reference's counts.
- The counterpart of ``test_ensemble_axis_matches_single_runs``: four
  members, one whole member per rank through ``shard_ensemble(tree,
  GridMesh)``, no collective, states within rtol 1e-12 / atol 1e-9 of the
  reference's solo steps and equal counts; two members each decomposed
  over the ranks, every step bitwise its solo decomposed step, and their
  ensemble adjoint with the reference's lockstep FGMRES count.
"""

import numpy as np
import pytest
import torch

import _torch_ranks as ranks
import jax
import jax.numpy as jnp
from _torch_parity import carry_model_data
from test_torch_sharding_options import _case_3d
from thermalporous_torch.dist.launch import run_ranks
from thermalporous_torch.models.base import ProblemData
from thermalporous_torch.precond.cpr import CPRConfig as TCPRConfig
from thermalporous_torch.precond.cpr import cpr_apply, cpr_setup
from thermalporous_torch.precond.gmg import GMGConfig as TGMGConfig
from thermalporous_torch.solve.newton import NewtonConfig as TNewtonConfig
from thermalporous_tpu.core import Grid
from thermalporous_tpu.dist import make_ensemble_step_fn as j_make_ensemble_step_fn
from thermalporous_tpu.dist import stack_ensemble as j_stack_ensemble
from thermalporous_tpu.models import TwoPhaseModel, make_problem_data
from thermalporous_tpu.physics import PhysicalParams, Well
from thermalporous_tpu.precond import CPRConfig, GMGConfig
from thermalporous_tpu.solve import NewtonConfig, Simulator, adjoint_gradients
from thermalporous_tpu.solve import ensemble_adjoint_gradients as j_ens_adjoint
from thermalporous_tpu.solve import make_step_fn as j_make_step_fn
from thermalporous_tpu.solve import record_ensemble_trajectory as j_record_e
from thermalporous_tpu.solve import record_trajectory

DT = 3600.0
#: the reference adjoint check's schedule, Newton and sweep settings
ADJ_DTS = [43200.0, 86400.0]
ADJ_NEWTON = dict(rtol=1e-11, ksp_rtol=1e-9, ksp_maxiter=120)
ADJ_SWEEP = dict(rtol=1e-10, maxiter=240)
#: the reference variational check's Newton settings
VAR_NEWTON = dict(rtol=1e-8, ksp_rtol=1e-6, ksp_maxiter=80)
#: the reference ensemble check's Δt and Newton settings
ENS_DTS = [600.0, 900.0, 1200.0, 1500.0]
ENS_NEWTON = dict(rtol=1e-9, ksp_rtol=1e-7)
#: the two-member ensemble adjoint's sweep
ENS_SWEEP = dict(rtol=1e-10, maxiter=200)
#: the transfer steps over 2x2 (label, transfer); levels above 100 cells stay
#: decomposed, so the 16x32 grid's finest level is
TRANSFER_STEPS = ("variational", "weighted")
#: the decomposed applies: (label, shape, port GMGConfig keywords beside
#: the transfer); 16x14x4 splits y at 7 and its finest level keeps y, the
#: 32x32x4 hierarchy keeps its second level decomposed
APPLY_CASES = (
    ("odd y origin", (16, 14, 4), dict(level_factors=((2, 1, 2),), replicate_below=50)),
    ("two decomposed levels", (32, 32, 4), dict(replicate_below=200)),
)
APPLIES = [(label, tr) for label, _, _ in APPLY_CASES for tr in ("weighted", "variational")]
#: the decomposed levels' stencil classes each apply must show
APPLY_LEVELS = {("odd y origin", "weighted"): ["ScalarStencil"],
                ("odd y origin", "variational"): ["ScalarStencil"],
                ("two decomposed levels", "weighted"): ["ScalarStencil", "WideStencil"],
                ("two decomposed levels", "variational"): ["ScalarStencil", "BoxStencil"]}
FOLD_SEED = 3


def _adjoint_case():
    """The reference adjoint check's 8×16 two-phase case (seed 21)."""
    pp = PhysicalParams()
    g = Grid(shape=(8, 16), spacing=(10.0, 10.0), thickness=5.0)
    rng = np.random.default_rng(21)
    k = 1e-13 * np.exp(0.8 * rng.standard_normal(g.shape))
    data = make_problem_data(g, pp, kx=k, phi=0.2, wells=[
        Well(cells=((0, 0),), control="bhp", p_bh=3.0e7, T_inj=420.0),
        Well(cells=((7, 15),), control="bhp", p_bh=1.0e7),
    ])
    return TwoPhaseModel(g, pp), data


def _variational_case():
    """The reference variational check's 16×32 two-phase case (seed 11)."""
    pp = PhysicalParams()
    g = Grid(shape=(16, 32), spacing=(10.0, 10.0), thickness=5.0)
    rng = np.random.default_rng(11)
    k = 1e-13 * np.exp(1.5 * rng.standard_normal(g.shape))
    wells = [
        Well(cells=((0, 0),), control="bhp", p_bh=3.0e7, T_inj=420.0),
        Well(cells=((15, 31),), control="bhp", p_bh=1.0e7),
    ]
    return TwoPhaseModel(g, pp), make_problem_data(g, pp, kx=k, phi=0.2, wells=wells)


def _ensemble_members():
    """The reference ensemble check's four 8×8 members (seed 3)."""
    pp = PhysicalParams()
    n = 8
    g = Grid(shape=(n, n), spacing=(10.0, 10.0), thickness=5.0)
    model = TwoPhaseModel(g, pp, s_init=0.2)
    rng = np.random.default_rng(3)
    members = []
    for e in range(4):
        wells = [
            Well(cells=((0, 0),), control="bhp", p_bh=(3.0 + 0.3 * e) * 1e7,
                 T_inj=400.0 + 10.0 * e),
            Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7),
        ]
        kx = 1e-13 * np.exp(0.4 * rng.standard_normal(g.shape))
        members.append(make_problem_data(g, pp, kx=kx, phi=0.2, wells=wells))
    return model, members


def _jterminal(u, d):
    return jnp.mean(u[1, :5, :6])


def _jrunning(u, dt, d):
    return dt * jnp.mean(u[0, 2:7, 5:12]) * 1e-12


#: the reference's counterparts of ``_torch_ranks.OBJECTIVES``
J_OBJECTIVES = {"terminal": (_jterminal, None), "running": (None, _jrunning)}


def _apply_job(shape, transfer, gkw):
    """A decomposed apply's inputs: the 3D gravity case off equilibrium (as
    ``test_torch_sharding_options``'s applies) and a seeded residual."""
    model, data = carry_model_data(*_case_3d(13, 1.0, shape=shape))
    rng = np.random.default_rng(7)
    u = model.initial_state(data).numpy()
    u[2] = 0.5
    u = u + np.array([1e6, 1.0, 0.1]).reshape(3, 1, 1, 1) * rng.standard_normal((3,) + shape)
    u[2] = np.clip(u[2], 0.05, 0.95)
    pc = TCPRConfig(stage2="rbgs", gmg=TGMGConfig(transfer=transfer, transfer_floor=0.5,
                                                   max_coarse_cells=16, **gkw))
    return dict(model=model, data=data, u=u, dt=DT, r=rng.standard_normal((3,) + shape),
                pc_cfg=pc, levels=True)


@pytest.fixture(scope="module")
def spawned():
    """One spawn of 4 gloo ranks for every job, the references computed in
    this process meanwhile: (rank outputs, references)."""
    jv_m, jv_d = _variational_case()
    v_m, v_d = carry_model_data(jv_m, jv_d)
    steps = [dict(model=v_m, data=v_d, newton_cfg=TNewtonConfig(**VAR_NEWTON), dt=DT,
                  pc_cfg=TCPRConfig(stage2="rbgs", gmg=TGMGConfig(
                      transfer=tr, transfer_floor=0.5, max_coarse_cells=64,
                      replicate_below=100)))
             for tr in TRANSFER_STEPS]
    steps.append(dict(model=v_m, data=v_d, pc_cfg=None, dt=DT,
                      newton_cfg=TNewtonConfig(**VAR_NEWTON, krylov_op="jvp")))
    applies = [_apply_job(shape, tr, gkw) for _, shape, gkw in APPLY_CASES
               for tr in ("weighted", "variational")]
    tp_m, tp_d = carry_model_data(*_case_3d(13, 1.0, shape=(14, 14, 4)))
    rng = np.random.default_rng(9)
    u_t = tp_m.initial_state(tp_d) + torch.as_tensor(
        np.array([1e6, 1.0, 0.05]).reshape(3, 1, 1, 1) * rng.standard_normal((3, 14, 14, 4)))
    transposes = [dict(model=tp_m, data=tp_d, u=u_t, dt=DT)]
    ja_m, ja_d = _adjoint_case()
    a_m, a_d = carry_model_data(ja_m, ja_d)
    adjoints = [dict(model=a_m, data=a_d, dts=ADJ_DTS, newton_cfg=TNewtonConfig(**ADJ_NEWTON),
                     sweep=ADJ_SWEEP)]
    je_m, je_ds = _ensemble_members()
    carried = [carry_model_data(je_m, d) for d in je_ds]
    ensembles = [dict(model=carried[0][0], datas=[d for _, d in carried], dts=ENS_DTS,
                      newton_cfg=TNewtonConfig(**ENS_NEWTON), sweep=ENS_SWEEP)]

    def references():
        refs = {}
        for tr in TRANSFER_STEPS:
            sim = Simulator(jv_m, jv_d, precond="cptr", newton_cfg=NewtonConfig(**VAR_NEWTON),
                            pc_cfg=CPRConfig(stage2="rbgs", gmg=GMGConfig(
                                transfer=tr, transfer_floor=0.5, max_coarse_cells=64)))
            u, st = sim.step(jv_m.initial_state(jv_d), DT)
            refs[tr] = (int(st.iters), int(st.ksp_iters), bool(st.converged), np.asarray(u))
        sim = Simulator(jv_m, jv_d, precond="cptr",
                        newton_cfg=NewtonConfig(**VAR_NEWTON, krylov_op="jvp"))
        u, st = sim.step(jv_m.initial_state(jv_d), DT)
        refs["jvp"] = (int(st.iters), int(st.ksp_iters), bool(st.converged), np.asarray(u))
        sim = Simulator(ja_m, ja_d, precond="cptr", newton_cfg=NewtonConfig(**ADJ_NEWTON))
        states = record_trajectory(sim, ja_m.initial_state(ja_d), ADJ_DTS)
        for name, (terminal, running) in J_OBJECTIVES.items():
            refs["adjoint", name] = adjoint_gradients(ja_m, ja_d, states, ADJ_DTS,
                                                      terminal=terminal, running=running,
                                                      **ADJ_SWEEP)
        step = jax.jit(j_make_step_fn(je_m, "cptr", NewtonConfig(**ENS_NEWTON)))
        solo = []
        for d, dt in zip(je_ds, ENS_DTS):
            u0 = je_m.initial_state(d)
            u1, st = step(u0, jnp.asarray(dt, u0.dtype), d)
            solo.append((np.asarray(u1), int(st.iters), int(st.ksp_iters)))
        refs["ensemble"] = solo
        jdata_e = j_stack_ensemble(je_ds[:2])
        jstep_e = jax.jit(j_make_ensemble_step_fn(je_m, "cptr", NewtonConfig(**ENS_NEWTON)))
        jstates = j_record_e(jstep_e, jnp.stack([je_m.initial_state(d) for d in je_ds[:2]]),
                             ENS_DTS[:2], jdata_e)
        refs["ensemble adjoint"] = j_ens_adjoint(je_m, jdata_e, jstates, ENS_DTS[:2],
                                                 terminal=_jterminal, **ENS_SWEEP)
        for (label, tr), a in zip(APPLIES, applies):
            model, data, u = a["model"], a["data"], torch.as_tensor(a["u"])
            state = cpr_setup(model.assemble_stencil(u, u, DT, data), a["pc_cfg"])
            refs[label, tr] = cpr_apply(state, torch.as_tensor(a["r"]), a["pc_cfg"]).numpy()
        return refs

    return run_ranks(ranks.family_rank, 4, steps, applies, transposes, adjoints, ensembles,
                     [dict(seed=FOLD_SEED)], meanwhile=references)


def _fold_labels() -> list:
    return [f"{split}{label}" for split in ranks.FOLD_SPLITS
            for label in [f"extend width={w} lead={n}" for w in (1, 2, 3, (2, 1))
                          for n in range(3)] + ["pad"]]


@pytest.mark.parametrize("label", _fold_labels())
def test_fold_is_the_adjoint_of_the_exchange(spawned, label):
    """⟨E x, y⟩ = ⟨x, Eᵀ y⟩ summed over the 2x2 ranks (every rank holds
    the same sums), to 1e-14 of the larger side's size."""
    outs, _ = spawned
    left, right = outs[0]["folds"][0][label]
    assert all(o["folds"][0][label] == (left, right) for o in outs[1:])
    assert abs(left - right) <= 1e-14 * max(abs(left), abs(right), 1.0)


def test_halo_transpose_is_the_whole_transpose(spawned):
    outs, _ = spawned
    assert all(o["transposes"][0] <= 1e-14 for o in outs)


@pytest.mark.parametrize("label,transfer", APPLIES)
def test_decomposed_transfer_apply_is_the_whole_apply(spawned, label, transfer):
    outs, refs = spawned
    i = APPLIES.index((label, transfer))
    got, levels = outs[0]["applies"][i]
    assert levels == APPLY_LEVELS[label, transfer]
    assert all(np.array_equal(o["applies"][i][0], got) for o in outs[1:])
    ref = refs[label, transfer]
    for c in range(ref.shape[0]):
        np.testing.assert_allclose(got[c], ref[c], rtol=0,
                                   atol=1e-12 * float(np.abs(ref[c]).max()))


def _check_adjoint(spawned, objective):
    """The decomposed sweep with ``objective``: converged, every rank the
    same value, counts and gathered gradients; φ's and tgeo[0]'s gradients
    and every component of the initial state's within 1e-8 of their size
    of the reference's."""
    outs, refs = spawned
    got, ref = outs[0]["adjoints"][0][objective], refs["adjoint", objective]
    assert got["converged"]
    assert all(o["adjoints"][0][objective]["value"] == got["value"]
               and o["adjoints"][0][objective]["step_iters"] == got["step_iters"]
               and np.array_equal(o["adjoints"][0][objective]["grad_fields"],
                                  got["grad_fields"])
               for o in outs[1:])
    grad = ProblemData(torch.as_tensor(got["grad_fields"]))
    pairs = [(grad.phi.numpy(), ref.grad_data.phi), (grad.tgeo[0].numpy(), ref.grad_data.tgeo[0])]
    pairs += [(got["grad_u0"][c], ref.grad_u0[c]) for c in range(got["grad_u0"].shape[0])]
    for leaf, want in pairs:
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(leaf, want, atol=1e-8 * scale, rtol=1e-8)
    np.testing.assert_allclose(got["value"], float(ref.value), rtol=1e-12)
    assert got["exchanges"] > 0


def test_adjoint_over_2x2_ranks_matches_the_reference(spawned):
    _check_adjoint(spawned, "terminal")


def test_adjoint_running_only_over_2x2_ranks(spawned):
    """No terminal objective: the sweep starts from zero in the owned
    layout, on every rank (the ranks whose owned range starts inside the
    grid among them)."""
    _check_adjoint(spawned, "running")


@pytest.mark.parametrize("option", TRANSFER_STEPS + ("jvp",))
def test_step_over_2x2_ranks_takes_the_reference_counts(spawned, option):
    outs, refs = spawned
    i = (TRANSFER_STEPS + ("jvp",)).index(option)
    iters, ksp, conv, u = outs[0]["steps"][i][:4]
    r_iters, r_ksp, r_conv, r_u = refs[option]
    assert conv and r_conv
    assert (iters, ksp) == (r_iters, r_ksp)
    np.testing.assert_allclose(u[0], r_u[0], atol=10.0)
    np.testing.assert_allclose(u[2], r_u[2], atol=1e-8)
    for o in outs[1:]:
        assert o["steps"][i][:3] == (iters, ksp, conv) and np.array_equal(o["steps"][i][3], u)
    assert all(o["steps"][i][-1][0] > 0 for o in outs)


def test_ensemble_whole_members_per_rank(spawned):
    """shard_ensemble over the 2x2 mesh: one whole member per rank, no
    collective in its step; gathered, the reference's solo steps."""
    outs, refs = spawned
    for o in outs:
        a = o["ensembles"][0]["a"]
        assert a["members"] == 1
        assert a["collectives"]["exchanges"] == a["collectives"]["allreduces"] == 0
    a = outs[0]["ensembles"][0]["a"]
    for e, (ju, iters, ksp) in enumerate(refs["ensemble"]):
        assert (a["iters"][e], a["ksp"][e]) == (iters, ksp)
        np.testing.assert_allclose(a["u"][e], ju, rtol=1e-12, atol=1e-9)


def test_ensemble_of_decomposed_members(spawned):
    """Two members decomposed over the ranks: every step bitwise its solo
    decomposed step; the ensemble adjoint's lockstep FGMRES count the
    reference's, its values and φ gradients the reference's."""
    outs, refs = spawned
    ref = refs["ensemble adjoint"]
    for o in outs:
        got = o["ensembles"][0]
        assert all(got["bitwise"]) and got["converged"]
        assert got["ksp"] == int(ref.ksp_iters)
    got = outs[0]["ensembles"][0]
    np.testing.assert_allclose(got["value"], np.asarray(ref.value), rtol=1e-9)
    for i in range(2):
        phi = ProblemData(torch.as_tensor(got["grad_fields"][i])).phi.numpy()
        want = np.asarray(ref.grad_data.phi[i])
        np.testing.assert_allclose(phi, want, rtol=1e-6, atol=1e-14)
