"""Port parity of the flagship's preconditioner pieces (f64, CPU): the
red-black block Gauss–Seidel stage 2 and its kernel's plain version, the
fused coarse subtree (``fuse_below``) and its kernel's plain version, the
adaptive coarsening schedule, and CPTR with the rbgs stage 2, against the
JAX package's jnp functions and its Pallas kernels in interpret mode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import assert_close, block_pair, model_case, n, t, torch_block
from tests._torch_parity import torch_scalar
from tests.test_gmg import poisson_stencil
from thermalporous_torch.kernels import deep_cycle as kdeep
from thermalporous_torch.kernels import stencil as kst
from thermalporous_torch.core import BlockStencil
from thermalporous_torch.precond.chebyshev import block_red_black_gauss_seidel
from thermalporous_torch.precond import cpr as tcpr
from thermalporous_torch.precond import gmg as tgmg
from thermalporous_tpu.kernels import fused_block_rbgs as j_fused_block_rbgs
from thermalporous_tpu.kernels.deep_cycle import deep_correction as j_deep_correction
from thermalporous_tpu.precond.chebyshev import _checkerboard as j_checkerboard
from thermalporous_tpu.precond.chebyshev import (
    block_red_black_gauss_seidel as j_block_rbgs,
)
from thermalporous_tpu.precond import cpr as jcpr
from thermalporous_tpu.precond import gmg as jgmg

torch.set_num_threads(1)

RTOL = 1e-12


# ------------------------------------------------- red-black Gauss–Seidel

@pytest.mark.parametrize("shape", [(12, 10, 6), (8, 14, 5), (9, 7)])
def test_fused_block_rbgs_matches(shape, rng):
    """One zero-start sweep: the wrapper's plain version against the jnp
    looped form and against the Pallas kernel (interpret mode, 3D)."""
    js, ts = block_pair(rng, shape, 3)
    jdinv = js.diag_inverse()
    tdinv = ts.diag_inverse()
    b = rng.standard_normal((3,) + shape)
    ref = j_block_rbgs(js, jdinv, jnp.asarray(b), None, sweeps=1)
    got = block_red_black_gauss_seidel(ts, tdinv, t(b))
    assert_close(got, ref, RTOL, 1e-13)
    assert torch.equal(got, kst.fused_block_rbgs(ts.coef, tdinv, t(b)))
    assert torch.equal(got, kst.fused_block_rbgs_plain(ts.coef, tdinv, t(b)))
    if len(shape) == 3:
        pal = j_fused_block_rbgs(js, jdinv, jnp.asarray(b), interpret=True)
        assert_close(got, pal, RTOL, 1e-13)


@pytest.mark.parametrize("sweeps,start", [(2, "zero"), (1, "x0"), (3, "x0"), (2, "x0"),
                                          (3, "zero")])
def test_block_rbgs_looped_form(sweeps, start, rng):
    """More sweeps, or a sweep from x₀: the stage-2 kernel's zero-start
    sweep and half-sweeps, which on the CPU are the reference's looped form."""
    shape = (6, 5, 4)
    js, ts = block_pair(rng, shape, 3)
    b = rng.standard_normal((3,) + shape)
    x0 = rng.standard_normal((3,) + shape) if start == "x0" else None
    ref = j_block_rbgs(
        js, js.diag_inverse(), jnp.asarray(b), None if x0 is None else jnp.asarray(x0),
        sweeps=sweeps)
    got = block_red_black_gauss_seidel(
        ts, ts.diag_inverse(), t(b), None if x0 is None else t(x0), sweeps=sweeps)
    assert_close(got, ref, RTOL, 1e-13)


def test_block_rbgs_has_no_fallback_off_the_cpu():
    """Off the CPU every sweep goes to a kernel wrapper, which refuses a
    device that is neither the CPU nor CUDA: no path computes on the CPU
    for tensors that are not there."""
    coef = torch.empty((7, 3, 3, 4, 4, 4), device="meta")
    st = BlockStencil(coef)
    dinv = torch.empty((3, 3, 4, 4, 4), device="meta")
    b = torch.empty((3, 4, 4, 4), device="meta")
    for kw in (dict(sweeps=2), dict(x=b, sweeps=1), dict(x=b, sweeps=3), {}):
        with pytest.raises(ValueError):      # the kernel wrapper refuses meta
            block_red_black_gauss_seidel(st, dinv, b, **kw)
    with pytest.raises(ValueError):
        kst.block_rbgs_half_sweep(coef, dinv, b, b, 0)
    with pytest.raises(ValueError):          # dinv of the wrong shape
        kst.fused_block_rbgs(torch.zeros((7, 3, 3, 4, 4, 4)), torch.zeros((3, 3, 4, 4)),
                             torch.zeros((3, 4, 4, 4)))
    red = kst.checkerboard((3, 4), torch.float64, "cpu")
    assert_close(red, j_checkerboard((3, 4), jnp.float64), 0)


# ----------------------------------------------------- fused coarse subtree

def _hierarchies(shape, cycle_type, rng, **overrides):
    """The JAX and port hierarchies of one heterogeneous SPD stencil (the
    configuration of tests/test_kernels.py's deep-cycle test) and a
    right-hand side on level 1."""
    k = jnp.asarray(np.exp(rng.standard_normal(shape)))
    js = poisson_stencil(shape, k=k, shift=0.3)
    kw = dict(cycle_type=cycle_type, degree=3, max_coarse_cells=64, kcycle_min_cells=128)
    kw.update(overrides)
    jcfg, tcfg = jgmg.GMGConfig(**kw), tgmg.GMGConfig(**kw)
    jst = jgmg.gmg_setup(js, jcfg)
    tst = tgmg.gmg_setup(torch_scalar(js), tcfg)
    b = rng.standard_normal(jst.stencils[1].grid_shape)
    return jst, tst, jcfg, tcfg, b


@pytest.mark.parametrize("shape,cycle_type", [
    ((24, 44, 10), "k"), ((24, 44, 10), "v"), ((33, 17), "k"),
    ((24, 44, 10), "w"), ((33, 17), "w"),
])
def test_coarse_correction_fused_and_unfused(shape, cycle_type, rng):
    """The port's _coarse_correction without and with fuse_below (the
    kernel wrapper's plain version) against the JAX recursion and the
    Pallas deep-cycle kernel in interpret mode."""
    jst, tst, jcfg, tcfg, b = _hierarchies(shape, cycle_type, rng)
    assert len(tst.stencils) == len(jst.stencils) >= 3
    ref = jgmg._coarse_correction(jst, 1, jnp.asarray(b), jcfg)
    subtree = jst.stencils[1:]
    factors = tuple(
        tuple(2 if c < f else 1 for f, c in zip(a.grid_shape, bb.grid_shape))
        for a, bb in zip(subtree[:-1], subtree[1:]))
    pal = j_deep_correction(subtree, jst.lam_max[1:], jst.coarse_inv, jnp.asarray(b),
                            factors, degree=jcfg.degree, lam_min_frac=jcfg.lam_min_frac,
                            cycle_type=cycle_type, kcycle_min_cells=jcfg.kcycle_min_cells,
                            interpret=True)
    unfused = tgmg._coarse_correction(tst, 1, t(b), tcfg)
    fcfg = dataclasses.replace(tcfg, fuse_below=10**9)
    assert tgmg._fusable(tst, 1, fcfg, torch.float64)
    fused = tgmg._coarse_correction(tst, 1, t(b), fcfg)
    for got in (unfused, fused):
        assert_close(got, ref, RTOL, 1e-13)
        assert_close(got, pal, RTOL, 1e-13)
    # the unfused recursion and the plain subtree are the same arithmetic
    assert torch.equal(fused, unfused)


def _check_subtree(jst, tst, jcfg, tcfg, b):
    """The port's correction at level 1, unfused and fused, against the JAX
    recursion and the Pallas deep-cycle kernel in interpret mode; returns
    the sizes of the subtree's levels."""
    ref = jgmg._coarse_correction(jst, 1, jnp.asarray(b), jcfg)
    subtree = jst.stencils[1:]
    factors = tuple(
        tuple(2 if c < f else 1 for f, c in zip(a.grid_shape, bb.grid_shape))
        for a, bb in zip(subtree[:-1], subtree[1:]))
    pal = j_deep_correction(subtree, jst.lam_max[1:], jst.coarse_inv, jnp.asarray(b),
                            factors, degree=jcfg.degree, lam_min_frac=jcfg.lam_min_frac,
                            cycle_type=jcfg.cycle_type,
                            kcycle_min_cells=jcfg.kcycle_min_cells, interpret=True)
    unfused = tgmg._coarse_correction(tst, 1, t(b), tcfg)
    fcfg = dataclasses.replace(tcfg, fuse_below=10**9)
    assert tgmg._fusable(tst, 1, fcfg, torch.float64)
    fused = tgmg._coarse_correction(tst, 1, t(b), fcfg)
    for got in (unfused, fused):
        assert_close(got, ref, RTOL, 1e-13)
        assert_close(got, pal, RTOL, 1e-13)
    assert torch.equal(fused, unfused)
    return [int(np.prod(s.grid_shape)) for s in tst.stencils[1:]], factors


@pytest.mark.parametrize("degree", [2, 4])
def test_coarse_correction_k_level_over_single_cycle_over_dense(degree, rng):
    """The flagship's pattern: kcycle_min_cells lies between two level sizes,
    so the entry level runs the K-cycle, the level below it a single cycle,
    and the coarsest is solved densely."""
    jst, tst, jcfg, tcfg, b = _hierarchies((24, 44, 10), "k", rng, degree=degree,
                                           kcycle_min_cells=500)
    sizes, _ = _check_subtree(jst, tst, jcfg, tcfg, b)
    assert sizes == [1320, 198, 36]
    assert kdeep.cycle_kinds(sizes, "k", 500) == [kdeep.KCYCLE, kdeep.SINGLE, kdeep.SINGLE]


@pytest.mark.parametrize("schedule", [
    ((2, 2, 2), (1, 2, 2), (2, 2, 2)),
    ((1, 2, 2), (1, 2, 2), (2, 1, 2), (2, 2, 1)),
])
def test_coarse_correction_semicoarsened_levels(schedule, rng):
    """A baked level_factors schedule with axes left uncoarsened inside the
    fused subtree (the adaptive flagship hierarchies have such levels)."""
    jst, tst, jcfg, tcfg, b = _hierarchies((12, 20, 18), "k", rng, degree=2,
                                           level_factors=schedule)
    _, factors = _check_subtree(jst, tst, jcfg, tcfg, b)
    assert list(factors[:len(schedule) - 1]) == list(schedule[1:])


@pytest.mark.parametrize("n_entry", [36_300, 145_200, 39_600, 5_040, 216, 1])
def test_deep_launch_shape(n_entry):
    blocks, threads = kdeep.launch_shape(n_entry, 132)
    assert 1 <= blocks <= 132 and threads % 32 == 0 and 32 <= threads <= kdeep.MAX_THREADS
    # about one cell a thread on the entry level, unless the card is full
    if blocks * threads < n_entry:
        assert (blocks, threads) == (132, kdeep.MAX_THREADS)
    else:
        assert blocks * (threads - 32) < n_entry or threads == 32
    assert blocks == 1 or (blocks - 1) * kdeep.MIN_CELLS_PER_BLOCK < n_entry


def test_deep_barrier_count():
    """Barriers of one subtree visit: the cooperative kernel's grid barriers
    and the earlier one-block kernel's block barriers."""
    S, K, W = kdeep.SINGLE, kdeep.KCYCLE, kdeep.WCYCLE
    # the flagship's pressure subtree from 36.3k cells: K over V over dense
    assert kdeep.barrier_count([K, S, S], 4) == 49
    assert kdeep.barrier_count([K, S, S], 4, single_block=True) == 88
    # from the 145k-cell level: K over K over V over dense
    assert kdeep.barrier_count([K, K, S, S], 4) == 2 * (11 + 49) + 3
    # a V-cycle of degree 2 over three smoothed levels
    assert kdeep.barrier_count([S] * 4, 2) == 3 * 7 + 1
    assert kdeep.barrier_count([S], 4) == 1              # the dense solve alone
    # W over V over dense: two cycles of 11 + 12, nothing more
    assert kdeep.barrier_count([W, S, S], 4) == 2 * (11 + 11 + 1)
    with pytest.raises(ValueError):                      # the one-block kernel had no W
        kdeep.barrier_count([W, S, S], 4, single_block=True)
    assert kdeep.cycle_kinds([9000, 5000, 600], "k", 8192) == [K, S, S]
    assert kdeep.cycle_kinds([9000, 5000, 600], "v", 8192) == [S] * 3
    assert kdeep.cycle_kinds([9000, 9000], "k", 8192) == [K, S]
    assert kdeep.cycle_kinds([9000, 9000, 9000], "w", 8192) == [W, W, S]


def test_gmg_apply_fuse_below_matches_the_reference(rng):
    """gmg_apply with fuse_below from level 2 down (so levels 0–1 recurse
    and the fused subtree is entered from inside the K-cycle)."""
    jst, tst, jcfg, tcfg, _ = _hierarchies((24, 44, 10), "k", rng)
    b = rng.standard_normal((24, 44, 10))
    fb = int(np.prod(tst.stencils[2].grid_shape))
    ref = jgmg.gmg_apply(jst, jnp.asarray(b), dataclasses.replace(jcfg, fuse_below=fb))
    tf = dataclasses.replace(tcfg, fuse_below=fb)
    assert not tgmg._fusable(tst, 1, tf, torch.float64)
    assert tgmg._fusable(tst, 2, tf, torch.float64)
    assert_close(tgmg.gmg_apply(tst, t(b), tf), ref, RTOL, 1e-13)


def test_fusable_sizes_the_subtree_at_the_apply_dtype(rng, monkeypatch):
    """The L2 budget is checked at the dtype the correction computes in: a
    budget between the f32 and the f64 size of the same subtree admits the
    f32 apply and refuses the f64 one."""
    _, tst, _, tcfg, _ = _hierarchies((24, 44, 10), "k", rng)
    cfg = dataclasses.replace(tcfg, fuse_below=10**9)
    shapes = [s.grid_shape for s in tst.stencils[1:]]
    inv = tst.coarse_inv.numel()
    b32 = kdeep.subtree_bytes(shapes, inv, torch.float32)
    b64 = kdeep.subtree_bytes(shapes, inv, torch.float64)
    assert b64 == 2 * b32
    expect = 4 * (inv + sum((2 * len(s) + 1 + kdeep.VECS_PER_LEVEL) * np.prod(s)
                            for s in shapes))
    assert b32 == expect
    monkeypatch.setattr(tgmg, "FUSE_L2_BUDGET_BYTES", (b32 + b64) // 2)
    assert tgmg._fusable(tst, 1, cfg, torch.float32)
    assert not tgmg._fusable(tst, 1, cfg, torch.float64)
    assert not tgmg._fusable(tst, 1, dataclasses.replace(cfg, fuse_below=0), torch.float32)
    small = int(np.prod(shapes[0])) - 1
    assert not tgmg._fusable(tst, 1, dataclasses.replace(cfg, fuse_below=small),
                             torch.float32)


def test_deep_correction_checks_its_arguments(rng):
    _, tst, _, tcfg, b = _hierarchies((33, 17), "k", rng)
    packed = [s.packed for s in tst.stencils[1:]]
    kw = dict(degree=3, lam_min_frac=0.3, kcycle_min_cells=128)
    with pytest.raises(ValueError):          # an unknown cycle kind
        kdeep.deep_correction(packed, tst.lam_max[1:], tst.coarse_inv, t(b),
                              cycle_type="f", **kw)
    with pytest.raises(ValueError):          # rc off the entry level's shape
        kdeep.deep_correction(packed, tst.lam_max[1:], tst.coarse_inv, t(b)[:-1],
                              cycle_type="k", **kw)
    one = kdeep.deep_correction(packed[-1:], [], tst.coarse_inv,
                                t(rng.standard_normal(tst.stencils[-1].grid_shape)),
                                cycle_type="k", **kw)
    assert tuple(one.shape) == tst.stencils[-1].grid_shape


# ------------------------------------------------ adaptive schedule, CPTR

@pytest.fixture(scope="module")
def system3d():
    """The assembled Jacobian of a 3D two-phase case with gravity."""
    c = model_case((6, 8, 10), seed=3)
    js = jax.jit(c["jm"].assemble_stencil)(c["ju"], c["ju0"], c["dt"], c["jd"])
    rhs = -np.asarray(c["jm"].residual(c["ju"], c["ju0"], c["dt"], c["jd"]))
    return js, torch_block(js), rhs


def _flagship_like(mod, max_coarse_cells=8, **extra):
    gmg = mod.GMGConfig(cycle_type="k", max_coarse_cells=max_coarse_cells,
                        coarsen="adaptive", degree=4, kcycle_min_cells=64, **extra)
    gmg_t = mod.GMGConfig(cycle_type="v", max_coarse_cells=max_coarse_cells,
                          coarsen="adaptive", degree=2, **extra)
    return gmg, gmg_t


def test_resolve_adaptive_coarsening(system3d):
    js, ts, _ = system3d
    jg, jgt = _flagship_like(jgmg)
    tg, tgt = _flagship_like(tgmg)
    jc = jcpr.resolve_adaptive_coarsening(js, jcpr.CPRConfig(gmg=jg, gmg_t=jgt))
    tc = tcpr.resolve_adaptive_coarsening(ts, tcpr.CPRConfig(gmg=tg, gmg_t=tgt))
    assert tc.gmg.level_factors == jc.gmg.level_factors
    assert tc.gmg_t.level_factors == jc.gmg_t.level_factors
    assert len(tc.gmg.level_factors) >= 2
    # a baked schedule, or a geometric hierarchy, is left as it is
    assert tcpr.resolve_adaptive_coarsening(ts, tc) is tc
    plain = tcpr.CPRConfig()
    assert tcpr.resolve_adaptive_coarsening(ts, plain) is plain


@pytest.mark.parametrize("fuse", [0, 100])
def test_cpr_apply_rbgs_stage2(system3d, fuse):
    """CPTR with the flagship's stage 2 (one rbgs sweep), the adaptive
    schedule and, with ``fuse``, the fused coarse subtree."""
    js, ts, rhs = system3d
    jg, jgt = _flagship_like(jgmg, fuse_below=fuse)
    tg, tgt = _flagship_like(tgmg, fuse_below=fuse)
    jcfg = jcpr.resolve_adaptive_coarsening(
        js, jcpr.CPRConfig(stage2="rbgs", gmg=jg, gmg_t=jgt))
    tcfg = tcpr.resolve_adaptive_coarsening(
        ts, tcpr.CPRConfig(stage2="rbgs", gmg=tg, gmg_t=tgt))
    jset, japply = jcpr.make_preconditioner("cptr", jcfg)
    tset, tapply = tcpr.make_preconditioner("cptr", tcfg)
    jstate, tstate = jset(js), tset(ts)
    ref = japply(jstate, jnp.asarray(rhs))
    assert_close(tapply(tstate, t(rhs)), ref, 1e-10, 1e-13)
    # two sweeps: the zero-start sweep of the stage-2 kernel, then two half-sweeps
    tcfg2 = dataclasses.replace(tcfg, stage2_sweeps=2)
    jcfg2 = dataclasses.replace(jcfg, stage2_sweeps=2)
    assert_close(tcpr.cpr_apply(tstate, t(rhs), tcfg2),
                 jcpr.cpr_apply(jstate, jnp.asarray(rhs), jcfg2), 1e-10, 1e-13)
    assert n(ref).shape == rhs.shape
