"""Port parity of the coupled block multigrid, the ``stage2="bgmg"`` stage 2
(``thermalporous_torch/precond/block_gmg.py``), against the JAX package,
f64 on the CPU, where the red-black wrappers run their plain versions.

- Galerkin block coarsening against the reference's and against the dense
  R·A·P; the dense coarsest operator; set-up (every level, every diagonal
  inverse, the coarsest inverse) and apply with more sweeps and cycles, at
  1e-12.
- The ``bgmg`` CPTR apply from the same stencil and from the reference's
  own state carried across, in f32 storage and with bf16 stage-2
  coefficients (``bf16_s2``, ``bf16``); one ``Simulator.step`` with
  ``bgmg``, with ``bgmg_cycles=2`` and ``stage2_sweeps=2``, and with
  ``pc_dtype="bf16_s2"``, at the reference's Newton and FGMRES counts.
- The kernels each level runs: the pre-smooth from zero through
  ``fused_block_rbgs`` (the stage-2 kernel at k = 0), the post-smooth as
  two ``block_rbgs_half_sweep`` calls a sweep, one ``block_matvec`` for the
  residual; and the stage-2 kernel's tile and the half-sweep's cell index
  walked in Python on the flagship's coarse ``bgmg`` levels (4×14×6,
  8×28×11 and the two above them), which no kernel test reached before.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import (
    OPTION_GMG,
    assert_close,
    carry_cpr_state,
    carry_model_data,
    model_case,
    newton_option_parity,
    t,
    torch_block,
)
from tests.test_block_gmg import _dense_restriction, random_block_stencil
from tests.test_newton_cptr import _tp_case
from tests.test_torch_stage2 import _walk_stage2
from thermalporous_torch.interop import config_from_dict
from thermalporous_torch.kernels import stencil as kst
from thermalporous_torch.precond import block_gmg as tbg
from thermalporous_torch.precond import cpr as tcpr
from thermalporous_torch.precond.gmg import GMGConfig
from thermalporous_torch.solve.oracle import oracle_run
from thermalporous_tpu.precond import block_gmg as jbg
from thermalporous_tpu.precond import cpr as jcpr
from thermalporous_tpu.precond import gmg as jgmg

torch.set_num_threads(1)

RTOL = 1e-12

#: the flagship's bgmg levels below the finest (60×220×85 halved on every
#: axis down to 2×7×3 = 42 cells, the dense level)
FLAGSHIP_BGMG = [(30, 110, 43), (15, 55, 22), (8, 28, 11), (4, 14, 6)]


@pytest.mark.parametrize("shape,nc", [((8, 8), 2), ((5, 3), 3), ((6, 7), 3), ((4, 5, 3), 3),
                                      ((4, 14, 6), 3)])
def test_block_galerkin_coarsening_matches_and_is_rap(shape, nc, rng):
    js = random_block_stencil(shape, nc, rng)
    ts = torch_block(js)
    got = tbg.block_galerkin_coarsen(ts)
    assert_close(got.coef, torch_block(jbg.block_galerkin_coarsen(js)).coef, 0.0)
    r = np.kron(np.eye(nc), _dense_restriction(shape))
    np.testing.assert_allclose(got.to_dense().numpy(), r @ ts.to_dense().numpy() @ r.T,
                               atol=1e-11)
    # the dense form (by scatter) is the reference's (by matvecs of unit vectors)
    assert_close(ts.to_dense(), js.to_dense(), 0.0)


@pytest.mark.parametrize("shape,nc,coarse,sweeps,cycles", [
    ((8, 7), 2, 8, 1, 1), ((6, 5, 4), 3, 8, 1, 1), ((6, 5, 4), 3, 8, 2, 2),
    ((9, 6, 5), 3, 16, 3, 1), ((7, 9), 3, 256, 1, 1)])
def test_setup_and_apply_match(shape, nc, coarse, sweeps, cycles, rng):
    js = random_block_stencil(shape, nc, rng)
    ts = torch_block(js)
    jstate = jax.jit(lambda s: jbg.block_gmg_setup(s, jgmg.GMGConfig(),
                                                   max_coarse_cells=coarse))(js)
    tstate = tbg.block_gmg_setup(ts, GMGConfig(), max_coarse_cells=coarse)
    assert len(tstate.stencils) == len(jstate.stencils)
    for a, b in zip(tstate.stencils, jstate.stencils):
        assert_close(a.coef, torch_block(b).coef, RTOL, 1e-15)
    for a, b in zip(tstate.dinvs, jstate.dinvs):
        assert_close(a, b, RTOL, 1e-15)
    assert_close(tstate.coarse_inv, jstate.coarse_inv, 1e-11, 1e-14)
    b = rng.standard_normal((nc,) + shape)
    ref = jax.jit(lambda s, r: jbg.block_gmg_apply(s, r, jgmg.GMGConfig(), sweeps=sweeps,
                                                   cycles=cycles))(jstate, jnp.asarray(b))
    assert_close(tbg.block_gmg_apply(tstate, t(b), GMGConfig(), sweeps=sweeps, cycles=cycles),
                 ref, RTOL, 1e-13)


def test_each_level_runs_the_red_black_kernels(rng, monkeypatch):
    """Per cycle and level: one zero-start sweep through the stage-2 kernel
    at k = 0, the post-smooth's 2·sweeps half-sweeps (plus 2·(sweeps − 1)
    for the pre-smooth) and one block matvec; each at its level's grid."""
    js = random_block_stencil((9, 6, 5), 3, rng)
    state = tbg.block_gmg_setup(torch_block(js), GMGConfig(), max_coarse_cells=16)
    calls = []
    for name in ("fused_stage2_rbgs", "block_rbgs_half_sweep", "block_matvec"):
        real = getattr(kst, name)

        def fwd(coef, *a, _real=real, _name=name, **k):
            calls.append((_name, tuple(coef.shape[3:])))
            return _real(coef, *a, **k)

        monkeypatch.setattr(kst, name, fwd)
    sweeps = 2
    tbg.block_gmg_apply(state, t(rng.standard_normal((3, 9, 6, 5))), GMGConfig(),
                        sweeps=sweeps)
    for s in state.stencils[:-1]:
        g = s.grid_shape
        assert calls.count(("fused_stage2_rbgs", g)) == 1
        assert calls.count(("block_rbgs_half_sweep", g)) == 2 * sweeps + 2 * (sweeps - 1)
        assert calls.count(("block_matvec", g)) == 1
    assert not any(g == state.stencils[-1].grid_shape for _, g in calls)


# ------------------------------------------------------------ the CPTR apply

@pytest.fixture(scope="module")
def system():
    c = model_case((6, 5, 4), seed=7)
    js = jax.jit(c["jm"].assemble_stencil)(c["ju"], c["ju0"], c["dt"], c["jd"])
    rhs = -np.asarray(c["jm"].residual(c["ju"], c["ju0"], c["dt"], c["jd"]))
    return js, torch_block(js), rhs


@pytest.mark.parametrize("pc_dtype,kw", [
    ("f32", dict()), ("f32", dict(bgmg_cycles=2, stage2_sweeps=2)),
    ("bf16_s2", dict()), ("bf16", dict(stage2_sweeps=2))])
def test_bgmg_cptr_apply_matches(system, pc_dtype, kw):
    js, ts, rhs = system
    g = dict(OPTION_GMG)
    jcfg = jcpr.CPRConfig(stage2="bgmg", bgmg_coarse_cells=8, pc_dtype=pc_dtype,
                          gmg=jgmg.GMGConfig(**g), **kw)
    tcfg = config_from_dict(tcpr.CPRConfig, dataclasses.asdict(jcfg))
    jstate = jax.jit(lambda s: jcpr.cpr_setup(s, jcfg))(js)
    ref = jax.jit(lambda s, r: jcpr.cpr_apply(s, r, jcfg))(jstate, jnp.asarray(rhs))
    tstate = tcpr.cpr_setup(ts, tcfg)
    assert len(tstate.bgmg.stencils) == len(jstate.bgmg.stencils) >= 2
    want = torch.float64 if pc_dtype == "f32" else torch.bfloat16
    assert all(s.coef.dtype == want for s in tstate.bgmg.stencils)
    assert all(d.dtype == want for d in tstate.bgmg.dinvs)
    assert tstate.bgmg.coarse_inv.dtype == torch.float64
    assert_close(tcpr.cpr_apply(tstate, t(rhs), tcfg), ref, RTOL, 1e-13)
    assert_close(tcpr.cpr_apply(carry_cpr_state(jstate), t(rhs), tcfg), ref, RTOL, 1e-13)


@pytest.fixture(scope="module")
def tp6():
    jm, jd = _tp_case(n=6)
    tm, td = carry_model_data(jm, jd)
    return jm, jd, tm, td, oracle_run(tm, td, [3600.0])[0]


@pytest.mark.parametrize("pc", [
    dict(stage2="bgmg", bgmg_coarse_cells=4),
    dict(stage2="bgmg", bgmg_coarse_cells=4, bgmg_cycles=2, stage2_sweeps=2),
    dict(stage2="bgmg", bgmg_coarse_cells=4, pc_dtype="bf16_s2"),
], ids=["bgmg", "cycles2-sweeps2", "bf16_s2"])
def test_simulator_step_with_bgmg(tp6, pc):
    jm, jd, tm, td, oracle = tp6
    newton_option_parity(jm, jd, tm, td, oracle, pc=pc)


# ------------------------------------------------ the kernels' index maps

@pytest.mark.parametrize("shape", FLAGSHIP_BGMG + [(2, 7, 3)])
def test_stage2_plan_on_the_flagship_bgmg_levels(shape):
    """The stage-2 kernel's plan covers every cell of each coarse level once
    in one wave, within the shared memory a launch takes."""
    plan = kst.stage2_plan(shape, 132)
    e0, e1, e2 = shape
    seen = np.zeros(shape, dtype=np.int32)
    for bx, by, bz in itertools.product(range(plan.chunks), range(plan.tiles_y),
                                        range(plan.tiles_z)):
        seen[bx * plan.lx:(bx + 1) * plan.lx, by * plan.ty:(by + 1) * plan.ty,
             bz * plan.tz:(bz + 1) * plan.tz] += 1
    assert (seen == 1).all()
    assert plan.blocks <= kst.STAGE2_BLOCKS_PER_SM * 132 or plan.chunks == 1
    assert plan.threads <= kst.STAGE2_MAX_THREADS
    assert plan.smem(3, 3, 8) <= 48 * 1024


@pytest.mark.parametrize("shape", [(4, 14, 6), (8, 28, 11), (2, 7, 3)])
def test_stage2_tile_walked_on_the_coarse_levels(shape):
    """The stage-2 kernel's schedule walked cell by cell under the
    wrapper's plan (a 4-plane axis, odd extents): every cell written once,
    every black cell finds exactly its 2·dim neighbours."""
    plan = kst.stage2_plan(shape, 132)
    writes, found = _walk_stage2(plan, shape)
    assert set(writes) == set(itertools.product(*map(range, shape)))
    assert set(writes.values()) == {1}
    for (x, y, z), nb in found.items():
        want = {}
        for key, cell, ok in (("x+", (x + 1, y, z), x + 1 < shape[0]),
                              ("x-", (x - 1, y, z), x > 0),
                              ("y+", (x, y + 1, z), y + 1 < shape[1]),
                              ("y-", (x, y - 1, z), y > 0),
                              ("z+", (x, y, z + 1), z + 1 < shape[2]),
                              ("z-", (x, y, z - 1), z > 0)):
            if ok:
                want[key] = cell
        assert nb == want


def _half_sweep_walk(shape):
    """csrc/rbgs.cuh:rbgs_half_kernel's index arithmetic for each thread c:
    the coordinates from ``Dims::coords`` (32-bit divisions below 2^31
    cells) and the neighbours c ± stride it reads, from ``make_dims``."""
    dim = len(shape)
    ext = (shape[0], shape[1], shape[2] if dim == 3 else 1)
    stride = (ext[1] * ext[2], ext[2], 1)
    n = ext[0] * stride[0]
    out = {}
    for c in range(n):
        r = c // ext[2]
        idx = (r // ext[1], r - (r // ext[1]) * ext[1], c - r * ext[2])
        nbs = []
        for a in range(dim):
            if idx[a] + 1 < ext[a]:
                nbs.append(c + stride[a])
            if idx[a] > 0:
                nbs.append(c - stride[a])
        out[c] = (idx[:dim], sum(idx) % 2, sorted(nbs))
    return out


@pytest.mark.parametrize("shape", [(4, 14, 6), (8, 28, 11), (2, 7, 3), (7, 9)])
def test_half_sweep_index_walked_on_the_coarse_levels(shape):
    """Each thread's cell is the C-order cell of its index, its colour the
    checkerboard's, and the cells it reads its grid neighbours exactly."""
    walk = _half_sweep_walk(shape)
    lin = np.arange(int(np.prod(shape))).reshape(shape)
    red = kst.checkerboard(shape, torch.float64, "cpu").numpy()
    for c, (idx, parity, nbs) in walk.items():
        assert lin[idx] == c and parity == (0 if red[idx] == 1.0 else 1)
        want = []
        for a in range(len(shape)):
            for d in (1, -1):
                j = list(idx)
                j[a] += d
                if 0 <= j[a] < shape[a]:
                    want.append(int(lin[tuple(j)]))
        assert nbs == sorted(want)
