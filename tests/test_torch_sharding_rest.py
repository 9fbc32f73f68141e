"""The remaining options over a grid decomposition — line solves along x
and y, ``stage2_axes``/``stage2_fused``, bf16 storage, ``batch_pt``, every
multigrid smoother and cycle count, every preconditioner and the balance
audit — on 4 gloo ranks on the CPU (a 2×2 mesh), in one spawn, with the
JAX references computed in this process meanwhile.

- The pipelined scalar and block Thomas solves along x and along y (the
  elimination's and the back substitution's carries handed from rank to
  rank) equal the whole-grid solve bit for bit, at a split at the odd index
  7 (14 cells over 2 ranks) and at an even one.
- The decomposed CPTR apply of each option, gathered, equals the whole
  apply to rounding (1e-12 of each component's largest entry) on a
  14×14×4 grid split at 7, where the zebra colours of a block whose x
  origin is odd differ from its red-black colours: the multigrid's line,
  zebra, Jacobi and red-black smoothers and ``cycles=2`` on hierarchies
  that coarsen z only (so that their leading levels stay decomposed at the
  odd split), the zebra stage 2 and the saturation leg's line smoothers
  along x and y, the sparsified and premasked stage 2, bf16 storage and
  ``batch_pt`` (whose K-cycle scalars are per member on a decomposed
  level).  A wrong colour offset or a shared scalar shows here.
- One 2×2 Newton step per group of options on the reference's 16×16
  ``_case`` (options that act on different parts of the apply share a
  step), and the "jacobi", "rbgs" and "lu" preconditioners: the JAX
  single-device step's Newton and FGMRES counts on every rank, p within
  10 Pa and S within 1e-8, and with bf16 storage every component within
  1e-8 of its largest value (``tests/test_torch_pc_dtype.py``'s band).
  The multigrid's finest level is decomposed (``replicate_below``), so
  that its smoothers run through the ranks.
- The balance audit over a two-step decomposed run: every rank's report the
  same, its totals and rows within 1e-10 (relative to each row's in-place
  total) of the JAX package's undecomposed ``BalanceAuditor``.
"""

import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from _torch_parity import assert_states_close, carry_model_data
from thermalporous_torch.dist.launch import run_ranks
from thermalporous_torch.dist.sharding import split_ranges
from thermalporous_torch.precond.chebyshev import (
    block_tridiag_factor,
    block_tridiag_solve_factored,
    tridiag_solve_along,
)
from thermalporous_torch.precond.cpr import CPRConfig as TCPRConfig
from thermalporous_torch.precond.cpr import cpr_apply, cpr_setup
from thermalporous_torch.precond.gmg import GMGConfig as TGMGConfig
from thermalporous_torch.solve.newton import NewtonConfig as TNewtonConfig
from thermalporous_tpu import io as jio
from thermalporous_tpu.core import Grid
from thermalporous_tpu.models import TwoPhaseModel, make_problem_data
from thermalporous_tpu.physics import PhysicalParams, Well
from thermalporous_tpu.precond import CPRConfig, GMGConfig
from thermalporous_tpu.solve import NewtonConfig, Simulator, TimeConfig

DT = 3600.0
NEWTON = dict(rtol=1e-9, ksp_rtol=1e-7)

#: the Thomas checks' grids: split at the odd index 7 and at 8
THOMAS = [("odd", (14, 14, 3), 0), ("odd", (14, 14, 3), 1),
          ("even", (16, 16, 3), 0), ("even", (16, 16, 3), 1)]

#: the applies' hierarchies: z coarsened only, so that the finest two levels
#: (784 and 392 cells of 14×14×4) stay decomposed at the odd split; the
#: second is K-cycled
APPLY_GMG = dict(level_factors=((1, 1, 2), (1, 1, 2)), max_coarse_cells=200,
                 replicate_below=300)
APPLY_SHAPE = (14, 14, 4)
#: the Δt of the saturation leg's applies: long enough that the S-S
#: operator couples cells as strongly as its diagonal holds them (at 1 h
#: its couplings are 1e-5 of it, and a line colour swapped moves the apply
#: by less than the tolerance)
S_APPLY_DT = 3.6e7
#: (label, CPRConfig keywords, GMGConfig keywords); a label with "s_stage"
#: is applied at S_APPLY_DT
APPLY_OPTIONS = (
    ("gmg line x", {}, dict(smoother="line", line_axis=0)),
    ("gmg line y", {}, dict(smoother="line", line_axis=1)),
    ("gmg zebra x", {}, dict(smoother="zebra", line_axis=0)),
    ("gmg zebra y", {}, dict(smoother="zebra", line_axis=1)),
    ("gmg jacobi cycles=2", {}, dict(smoother="jacobi", cycles=2)),
    ("gmg rbgs", {}, dict(smoother="rbgs")),
    ("stage2 zebra x s_stage zebra y", dict(stage2="zebra", stage2_axis=0, stage2_sweeps=2,
                                           s_stage="zebra", s_axis=1), {}),
    ("stage2 zebra y s_stage line x", dict(stage2="zebra", stage2_axis=1, s_stage="line",
                                          s_axis=0), {}),
    ("s_stage zebra x", dict(s_stage="zebra", s_axis=0), {}),
    ("s_stage line y", dict(s_stage="line", s_axis=1), {}),
    ("stage2_axes", dict(stage2="rbgs", stage2_axes=(0, 2), stage2_sweeps=2), {}),
    ("stage2_fused axes sweeps=2", dict(stage2="rbgs", stage2_fused=True, stage2_axes=(1,),
                                        stage2_sweeps=2), {}),
    ("bf16", dict(pc_dtype="bf16", stage2="rbgs", stage2_sweeps=2, s_stage="rbgs"), {}),
    ("bf16_gmg", dict(pc_dtype="bf16_gmg"), dict(smoother="jacobi")),
    ("bf16_s2 fused axes", dict(pc_dtype="bf16_s2", stage2="rbgs", stage2_fused=True,
                                stage2_axes=(0,), stage2_sweeps=2), {}),
    ("batch_pt", dict(batch_pt=True, triangular=False), {}),
    ("batch_pt bf16 rbgs", dict(batch_pt=True, triangular=False, pc_dtype="bf16"),
     dict(smoother="rbgs")),
)

#: the port's multigrid on the steps' 16×16 grid: the finest level (blocks
#: 8×8) decomposed, the coarsest (8×8) replicated
STEP_REPLICATE = 64
#: (label, precond, CPRConfig keywords of both packages, GMGConfig keywords,
#: bf16 band)
STEP_OPTIONS = (
    ("zebra x, s_stage zebra y, gmg line x", "cptr",
     dict(stage2="zebra", stage2_axis=0, s_stage="zebra", s_axis=1),
     dict(smoother="line", line_axis=0), False),
    ("zebra y, s_stage line x, gmg zebra y", "cptr",
     dict(stage2="zebra", stage2_axis=1, s_stage="line", s_axis=0),
     dict(smoother="zebra", line_axis=1), False),
    ("stage2_axes, s_stage zebra x, gmg jacobi cycles=2, bf16_gmg", "cptr",
     dict(stage2="rbgs", stage2_axes=(0,), s_stage="zebra", s_axis=0, pc_dtype="bf16_gmg"),
     dict(smoother="jacobi", cycles=2), True),
    ("stage2_fused axes sweeps=2, s_stage line y, gmg rbgs, bf16_s2", "cptr",
     dict(stage2="rbgs", stage2_fused=True, stage2_axes=(1,), stage2_sweeps=2,
          s_stage="line", s_axis=1, pc_dtype="bf16_s2"),
     dict(smoother="rbgs"), True),
    ("stage2_fused, batch_pt, bf16", "cptr",
     dict(stage2="rbgs", stage2_fused=True, batch_pt=True, triangular=False, pc_dtype="bf16"),
     {}, True),
    ("precond jacobi", "jacobi", {}, {}, False),
    ("precond rbgs", "rbgs", {}, {}, False),
    ("precond lu", "lu", {}, {}, False),
)
AUDIT_STEPS = 2
#: the audit's closure rows against the reference's, relative to each row's
#: in-place total
AUDIT_RTOL = 1e-10


def _case(n=16, seed=0):
    """The reference sharding test's ``_case`` (two-phase)."""
    pp = PhysicalParams()
    g = Grid(shape=(n, n), spacing=(10.0, 10.0), thickness=5.0)
    rng = np.random.default_rng(seed)
    k = 1e-13 * np.exp(0.5 * rng.standard_normal(g.shape))
    wells = [
        Well(cells=((0, 0),), control="bhp", p_bh=3.0e7, T_inj=420.0),
        Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7),
    ]
    return TwoPhaseModel(g, pp), make_problem_data(g, pp, kx=k, phi=0.2, wells=wells)


def _case_3d(shape, seed=13):
    """The reference's 3D sharding checks' grid (gravity, kz = 0.3 kx, BHP
    wells on the corner columns) at ``shape``."""
    pp = PhysicalParams()
    nx, ny, nz = shape
    g = Grid(shape=shape, spacing=(10.0, 10.0, 4.0), gravity=9.81)
    rng = np.random.default_rng(seed)
    k = 1e-13 * np.exp(rng.standard_normal(g.shape))
    wells = [
        Well(cells=tuple((0, 0, iz) for iz in range(nz)), control="bhp", p_bh=4.0e7,
             T_inj=420.0),
        Well(cells=tuple((nx - 1, ny - 1, iz) for iz in range(nz)), control="bhp",
             p_bh=1.5e7),
    ]
    return TwoPhaseModel(g, pp), make_problem_data(g, pp, kx=k, kz=0.3 * k, phi=0.2,
                                                   wells=wells)


def _thomas_systems(shape, axis: int, seed: int):
    """Diagonally dominant scalar and 3×3-block tridiagonal systems along
    ``axis`` (couplings zero past the line's ends) and right-hand sides."""
    rng = np.random.default_rng(seed)
    scalar = [_zero_first(-rng.random(shape), axis), 4.0 + rng.random(shape),
              _zero_last(-rng.random(shape), axis), rng.standard_normal(shape)]
    nc = 3
    eye = np.eye(nc).reshape((nc, nc) + (1,) * len(shape))
    blo = 0.5 * rng.random((nc, nc) + shape)
    bup = 0.5 * rng.random((nc, nc) + shape)
    block = [_zero_first(blo, 2 + axis), 6.0 * eye + 0.3 * rng.random((nc, nc) + shape),
             _zero_last(bup, 2 + axis), rng.standard_normal((nc,) + shape)]
    return scalar, block


def _zero_first(t, axis):
    t = t.copy()
    t[(slice(None),) * axis + (0,)] = 0.0
    return t


def _zero_last(t, axis):
    t = t.copy()
    t[(slice(None),) * axis + (-1,)] = 0.0
    return t


def _step_configs(pc_kw, gmg_kw):
    """Both packages' CPRConfig of a step option (None: the defaults)."""
    jpc = CPRConfig(**pc_kw, gmg=GMGConfig(**gmg_kw))
    tpc = TCPRConfig(**pc_kw, gmg=TGMGConfig(**gmg_kw, replicate_below=STEP_REPLICATE))
    return jpc, tpc


@pytest.fixture(scope="module")
def spawned():
    """One spawn of 4 gloo ranks for every job, the references computed in
    this process meanwhile."""
    thomas = []
    for i, (_, shape, axis) in enumerate(THOMAS):
        scalar, block = _thomas_systems(shape, axis, seed=i)
        thomas.append(dict(shape=shape, axis=axis, scalar=scalar, block=block))
    jm, jd = _case()
    model, data = carry_model_data(jm, jd)
    newton = TNewtonConfig(**NEWTON)
    steps = []
    for label, precond, pc_kw, gmg_kw, _ in STEP_OPTIONS:
        _, tpc = _step_configs(pc_kw, gmg_kw)
        steps.append(dict(model=model, data=data, newton_cfg=newton, pc_cfg=tpc, dt=DT,
                          precond=precond))
    applies = []
    a_model, a_data = carry_model_data(*_case_3d(APPLY_SHAPE))
    rng = np.random.default_rng(7)
    # a state far off equilibrium with both phases mobile, so that the
    # saturation couples across cells (tests/test_torch_sharding_options.py)
    u = a_model.initial_state(a_data).numpy()
    u[2] = 0.5
    u = u + np.array([1e6, 1.0, 0.1]).reshape(3, 1, 1, 1) * rng.standard_normal(
        (3,) + APPLY_SHAPE)
    u[2] = np.clip(u[2], 0.05, 0.95)
    r = rng.standard_normal((3,) + APPLY_SHAPE)
    for label, pc_kw, gmg_kw in APPLY_OPTIONS:
        pc = TCPRConfig(**pc_kw, gmg=TGMGConfig(**dict(APPLY_GMG, **gmg_kw)))
        applies.append(dict(model=a_model, data=a_data, u=u, r=r, pc_cfg=pc, levels=True,
                            dt=S_APPLY_DT if "s_stage" in label else DT))
    audit = dict(model=model, data=data, newton_cfg=newton, dt=DT, steps=AUDIT_STEPS)

    def references():
        refs = {}
        for (label, shape, axis), job in zip(THOMAS, thomas):
            t = [torch.as_tensor(x) for x in job["scalar"]]
            b = [torch.as_tensor(x) for x in job["block"]]
            refs["thomas", label, axis] = (
                tridiag_solve_along(axis, *t).numpy(),
                block_tridiag_solve_factored(axis, block_tridiag_factor(axis, *b[:3]),
                                             b[3]).numpy())
        for (label, _, _), a in zip(APPLY_OPTIONS, applies):
            ut = torch.as_tensor(a["u"])
            state = cpr_setup(a_model.assemble_stencil(ut, ut, a["dt"], a_data), a["pc_cfg"])
            refs["apply", label] = cpr_apply(state, torch.as_tensor(r), a["pc_cfg"]).numpy()
        jnewton = NewtonConfig(**NEWTON)
        for label, precond, pc_kw, gmg_kw, _ in STEP_OPTIONS:
            jpc, _ = _step_configs(pc_kw, gmg_kw)
            u1, st = Simulator(jm, jd, precond=precond, newton_cfg=jnewton,
                               pc_cfg=jpc).step(jm.initial_state(jd), DT)
            refs["step", label] = (int(st.iters), int(st.ksp_iters), np.asarray(u1))
        ju0 = jm.initial_state(jd)
        jsim = Simulator(jm, jd, precond="cptr", newton_cfg=jnewton,
                         time_cfg=TimeConfig(dt_init=DT, dt_max=DT))
        jaud = jio.BalanceAuditor(jm, jd, ju0)
        jres = jsim.run(t_end=AUDIT_STEPS * DT, u0=ju0, callback=jaud)
        refs["audit"] = (jaud, [(float(x.dt), int(x.newton_iters), int(x.ksp_iters))
                                for x in jres.records], np.asarray(jres.u))
        return refs

    outs, refs = run_ranks(ranks.rest_rank, 4, thomas, steps, applies, audit,
                           meanwhile=references)
    return outs, refs


@pytest.mark.parametrize("label,shape,axis", THOMAS,
                         ids=[f"{lab}-{'xy'[a]}" for lab, _, a in THOMAS])
def test_pipelined_line_solves_are_the_whole_solve(spawned, label, shape, axis):
    outs, refs = spawned
    i = THOMAS.index((label, shape, axis))
    want_s, want_b = refs["thomas", label, axis]
    for o in outs:
        got = o["thomas"][i]
        assert np.array_equal(got["scalar"], want_s)
        assert np.array_equal(got["block"], want_b)
    # each rank handed its carries on: three sweeps (the scalar solve's two,
    # the factor's and the block solve's two: five), one carry in or out per
    # neighbour along the axis
    assert all(o["thomas"][i]["carries"] == 5 for o in outs)
    split = split_ranges(shape[axis], 2)[1]
    assert split % 2 == (1 if label == "odd" else 0)


@pytest.mark.parametrize("label", [a[0] for a in APPLY_OPTIONS])
def test_decomposed_apply_is_the_whole_apply(spawned, label):
    outs, refs = spawned
    i = [a[0] for a in APPLY_OPTIONS].index(label)
    got = [o["applies"][i][0] for o in outs]
    ref = refs["apply", label]
    assert all(np.array_equal(g, got[0]) for g in got[1:])
    for c in range(ref.shape[0]):       # per component: p, T and S differ in scale
        np.testing.assert_allclose(got[0][c], ref[c], rtol=0,
                                   atol=1e-12 * float(np.abs(ref[c]).max()))
    # the pressure hierarchy's two finest levels are decomposed
    assert all(len(o["applies"][i][1]) == 2 for o in outs)


@pytest.mark.parametrize("label", [s[0] for s in STEP_OPTIONS])
def test_option_over_2x2_ranks_takes_the_reference_counts(spawned, label):
    outs, refs = spawned
    i = [s[0] for s in STEP_OPTIONS].index(label)
    bf16 = STEP_OPTIONS[i][4]
    iters, ksp, conv, u, rates = outs[0]["steps"][i][:5]
    r_iters, r_ksp, r_u = refs["step", label]
    assert conv
    assert (iters, ksp) == (r_iters, r_ksp)
    np.testing.assert_allclose(u[0], r_u[0], atol=10.0)
    np.testing.assert_allclose(u[2], r_u[2], atol=1e-8)
    if bf16:
        assert_states_close(u, r_u, 1e-8)
    for o in outs[1:]:
        assert o["steps"][i][:3] == (iters, ksp, conv)
        assert np.array_equal(o["steps"][i][3], u) and o["steps"][i][4] == rates
    # the step exchanged ghosts and reduced through the mesh on every rank
    assert all(o["steps"][i][-1][0] > 0 and o["steps"][i][-1][1] > 0 for o in outs)


def test_audit_over_2x2_ranks_is_the_reference_audit(spawned):
    outs, refs = spawned
    jaud, j_records, j_u = refs["audit"]
    got = outs[0]["audit"]
    assert got["records"] == j_records
    np.testing.assert_allclose(got["u"][0], j_u[0], atol=10.0)
    np.testing.assert_allclose(got["u"][2], j_u[2], atol=1e-8)
    for o in outs[1:]:                  # every rank's report is the same
        assert o["audit"]["report"] == got["report"]
    assert (got["steps"], got["skipped"]) == (jaud.steps, jaud.skipped) == (AUDIT_STEPS, 0)
    scale = np.abs(np.asarray(jaud.m0))
    for key in ("m0", "m_last", "cum", "cum_abs"):
        np.testing.assert_allclose(got[key], np.asarray(getattr(jaud, key)), rtol=0,
                                   atol=AUDIT_RTOL * float(scale.max()))
    rep, j_rep = got["report"], jaud.report()
    assert list(rep["rows"]) == list(j_rep["rows"]) and rep["complete"] == j_rep["complete"]
    for i, (lab, r) in enumerate(j_rep["rows"].items()):
        g = rep["rows"][lab]
        denom = max(abs(r["delta_in_place"]), float(np.asarray(jaud.cum_abs)[i]))
        for key in ("delta_in_place", "cum_source", "abs_error"):
            assert abs(g[key] - r[key]) <= AUDIT_RTOL * scale[i], (lab, key, g[key], r[key])
        assert abs(g["rel_error"] - r["rel_error"]) <= AUDIT_RTOL * scale[i] / denom, (lab, g, r)

