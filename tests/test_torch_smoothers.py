"""Port parity of the smoothers, the off-diagonal and transposed block
stencils and the multigrid options (f64, CPU) against the JAX package:
``precond/chebyshev.py``'s scalar and block smoothers and line solves,
``BlockStencil.matvec_offdiag`` and ``transpose``, and ``gmg_apply`` with
each smoother, semicoarsening, repeated cycles and the W-cycle (unfused,
and fused through ``deep_correction``'s plain version), with the W-cycle's
barrier count.

Pointwise functions agree to 1e-12 of the reference's largest value; the
inputs are made with numpy from a seed and handed to both packages.
"""

import dataclasses
import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import assert_close, block_pair, n, poisson_pair, t
from thermalporous_torch.core import apply_blocks
from thermalporous_torch.kernels import deep_cycle as kdeep
from thermalporous_torch.kernels import stencil as kst
from thermalporous_torch.precond import gmg as tgmg
from thermalporous_tpu.precond import gmg as jgmg

# the packages' precond/__init__ export a function named chebyshev
tch = importlib.import_module("thermalporous_torch.precond.chebyshev")
jch = importlib.import_module("thermalporous_tpu.precond.chebyshev")

torch.set_num_threads(1)

RTOL = 1e-12
SHAPES = [(7, 5), (4, 5, 3)]


def _close(got, ref):
    assert_close(got, ref, RTOL, 1e-13)


def _start(rng, shape, start, nc=None):
    if start == "zero":
        return None, None
    x = rng.standard_normal(shape if nc is None else (nc,) + shape)
    return t(x), jnp.asarray(x)


# ---------------------------------------------------------- scalar smoothers

def _scalar_cases():
    for shape in SHAPES:
        for name, sweeps, start in itertools.product(("jacobi", "rbgs"), (1, 2, 3),
                                                     ("zero", "x0")):
            yield name, shape, None, sweeps, start
        for name, axis, sweeps, start in itertools.product(
                ("line", "zebra"), range(len(shape)), (1, 3), ("zero", "x0")):
            yield name, shape, axis, sweeps, start


@pytest.mark.parametrize("name,shape,axis,sweeps,start", list(_scalar_cases()))
def test_scalar_smoother_matches(name, shape, axis, sweeps, start, rng):
    js, ts = poisson_pair(rng, shape, shift=0.5)
    b = rng.standard_normal(shape)
    tx, jx = _start(rng, shape, start)
    if name == "jacobi":
        got = tch.weighted_jacobi(ts, t(b), tx, sweeps=sweeps, omega=0.7)
        ref = jch.weighted_jacobi(js, jnp.asarray(b), jx, sweeps=sweeps, omega=0.7)
    elif name == "rbgs":
        got = tch.red_black_gauss_seidel(ts, t(b), tx, sweeps=sweeps)
        ref = jch.red_black_gauss_seidel(js, jnp.asarray(b), jx, sweeps=sweeps)
    elif name == "line":
        got = tch.line_jacobi(ts, t(b), tx, axis=axis, sweeps=sweeps, omega=0.9)
        ref = jch.line_jacobi(js, jnp.asarray(b), jx, axis=axis, sweeps=sweeps, omega=0.9)
    else:
        got = tch.zebra_line_gs(ts, t(b), tx, axis=axis, sweeps=sweeps)
        ref = jch.zebra_line_gs(js, jnp.asarray(b), jx, axis=axis, sweeps=sweeps)
    _close(got, ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_masks_and_tridiagonal_solve(shape, rng):
    js, ts = poisson_pair(rng, shape, shift=0.5)
    assert torch.equal(kst.checkerboard(shape, torch.float64, "cpu"),
                       t(jch._checkerboard(shape, jnp.float64)))
    b = rng.standard_normal(shape)
    for axis in range(len(shape)):
        for color in (0, 1):
            assert torch.equal(tch._line_mask(shape, axis, color, torch.float64, "cpu"),
                               t(jch._line_mask(shape, axis, color, jnp.float64)))
        got = tch.tridiag_solve_along(axis, ts.lower[axis], ts.diag, ts.upper[axis], t(b))
        ref = jch.tridiag_solve_along(axis, js.lower[axis], js.diag, js.upper[axis],
                                      jnp.asarray(b))
        _close(got, ref)


# ------------------------------------------------ block stencil: off-diagonal

def _subsets(dim):
    return [None] + [c for r in range(1, dim + 1)
                     for c in itertools.combinations(range(dim), r)]


@pytest.mark.parametrize("shape,nc", [((6, 5), 3), ((4, 5, 3), 3), ((4, 5, 3), 2)])
def test_matvec_offdiag_every_axes_subset(shape, nc, rng):
    js, ts = block_pair(rng, shape, nc)
    v = rng.standard_normal((nc,) + shape)
    for axes in _subsets(len(shape)) + [(-1,), (len(shape) - 1, 0)]:
        _close(ts.matvec_offdiag(t(v), axes=axes),
                js.matvec_offdiag(jnp.asarray(v), axes=axes))
    # the full coupling plus the diagonal blocks is the matvec
    full = ts.matvec_offdiag(t(v)) + apply_blocks(ts.diag, t(v))
    _close(full, js.matvec(jnp.asarray(v)))


def test_matvec_offdiag_refuses_empty_axes(rng):
    """The reference returns None for axes=(); the port raises."""
    js, ts = block_pair(rng, (4, 5, 3), 3)
    v = rng.standard_normal((3, 4, 5, 3))
    assert js.matvec_offdiag(jnp.asarray(v), axes=()) is None
    with pytest.raises(ValueError, match="empty"):
        ts.matvec_offdiag(t(v), axes=())


@pytest.mark.parametrize("shape,nc", [((5, 4), 2), ((5, 4), 3), ((4, 3, 3), 3)])
def test_transpose(shape, nc, rng):
    js, ts = block_pair(rng, shape, nc)
    tt, jt = ts.transpose(), js.transpose()
    assert tt.coef.is_contiguous()
    _close(tt.diag, jt.diag)
    for a in range(len(shape)):
        _close(tt.upper[a], jt.upper[a])
        _close(tt.lower[a], jt.lower[a])
    assert torch.equal(tt.to_dense(), ts.to_dense().T)


# -------------------------------------------------------- block smoothers

@pytest.mark.parametrize("shape,axes,sweeps,start", [
    ((6, 5), (0,), 1, "zero"), ((6, 5), (1,), 2, "x0"), ((6, 5), (0, 1), 2, "zero"),
    ((4, 5, 3), (2,), 1, "zero"), ((4, 5, 3), (2,), 2, "x0"), ((4, 5, 3), (0, 2), 3, "zero"),
    ((4, 5, 3), (1,), 1, "x0"), ((4, 5, 3), (0, 1, 2), 2, "zero"),
])
def test_block_rbgs_with_axes(shape, axes, sweeps, start, rng):
    js, ts = block_pair(rng, shape, 3)
    b = rng.standard_normal((3,) + shape)
    tx, jx = _start(rng, shape, start, nc=3)
    got = tch.block_red_black_gauss_seidel(ts, ts.diag_inverse(), t(b), tx, sweeps=sweeps,
                                           axes=axes)
    ref = jch.block_red_black_gauss_seidel(js, js.diag_inverse(), jnp.asarray(b), jx,
                                           sweeps=sweeps, axes=axes)
    _close(got, ref)


@pytest.mark.parametrize("shape", [(6, 5), (4, 5, 3)])
@pytest.mark.parametrize("axes", [None, (0,), (-1,), "all"])
def test_block_rbgs_fused_zero(shape, axes, rng):
    js, ts = block_pair(rng, shape, 3)
    axes = tuple(range(len(shape))) if axes == "all" else axes
    b = rng.standard_normal((3,) + shape)
    red_t = kst.checkerboard(shape, torch.float64, "cpu")
    red_j = jch._checkerboard(shape, jnp.float64)
    tdinv, jdinv = ts.diag_inverse(), js.diag_inverse()
    got = tch.block_rbgs_fused_zero(ts, red_t * tdinv, (1 - red_t) * tdinv, t(b), axes=axes)
    ref = jch.block_rbgs_fused_zero(js, red_j * jdinv, (1 - red_j) * jdinv, jnp.asarray(b),
                                    axes=axes)
    _close(got, ref)
    if axes is None or len(axes) == len(shape):
        # with the full coupling it is the zero-start sweep of the kernel route
        _close(got, kst.fused_block_rbgs(ts.coef, tdinv, t(b)))


@pytest.mark.parametrize("shape,nc,axis", [((6, 5), 3, 0), ((6, 5), 2, 1),
                                           ((4, 5, 3), 3, 0), ((4, 5, 3), 3, 1),
                                           ((4, 5, 3), 3, 2)])
def test_block_tridiagonal_solves(shape, nc, axis, rng):
    js, ts = block_pair(rng, shape, nc)
    b = rng.standard_normal((nc,) + shape)
    tf = tch.block_tridiag_factor(axis, ts.lower[axis], ts.diag, ts.upper[axis])
    jf = jch.block_tridiag_factor(axis, js.lower[axis], js.diag, js.upper[axis])
    for g, r in zip(tf, jf):
        _close(g, r)
    _close(tch.block_tridiag_solve_factored(axis, tf, t(b)),
           jch.block_tridiag_solve_factored(axis, jf, jnp.asarray(b)))
    _close(tch.block_tridiag_solve_along(axis, ts.lower[axis], ts.diag, ts.upper[axis], t(b)),
           jch.block_tridiag_solve_along(axis, js.lower[axis], js.diag, js.upper[axis],
                                         jnp.asarray(b)))


@pytest.mark.parametrize("shape,axis,sweeps,omega,start", [
    ((6, 5), 0, 1, 1.0, "zero"), ((6, 5), 1, 2, 0.8, "x0"), ((6, 5), -1, 3, 1.0, "zero"),
    ((4, 5, 3), 0, 1, 1.0, "x0"), ((4, 5, 3), 1, 2, 1.0, "zero"),
    ((4, 5, 3), 2, 2, 0.7, "zero"), ((4, 5, 3), 1, 1, 0.9, "x0"),
])
def test_block_zebra_line_gs(shape, axis, sweeps, omega, start, rng):
    js, ts = block_pair(rng, shape, 3)
    b = rng.standard_normal((3,) + shape)
    tx, jx = _start(rng, shape, start, nc=3)
    ref = jch.block_zebra_line_gs(js, jnp.asarray(b), jx, axis=axis, sweeps=sweeps,
                                  omega=omega)
    got = tch.block_zebra_line_gs(ts, t(b), tx, axis=axis, sweeps=sweeps, omega=omega)
    _close(got, ref)
    a = axis % len(shape)
    fac = tch.block_tridiag_factor(a, ts.lower[a], ts.diag, ts.upper[a])
    assert torch.equal(tch.block_zebra_line_gs(ts, t(b), tx, axis=axis, sweeps=sweeps,
                                               omega=omega, factor=fac), got)


# ----------------------------------------------------- multigrid options

GMG_KW = dict(max_coarse_cells=4, degree=2, kcycle_min_cells=16)


def _gmg_pair(rng, shape, **kw):
    js, ts = poisson_pair(rng, shape, shift=0.05)
    jcfg = jgmg.GMGConfig(**dict(GMG_KW, **kw))
    tcfg = tgmg.GMGConfig(**dict(GMG_KW, **kw))
    jst = jgmg.gmg_setup(js, jcfg)
    tst = tgmg.gmg_setup(ts, tcfg)
    assert [s.grid_shape for s in tst.stencils] == [s.grid_shape for s in jst.stencils]
    return jst, tst, jcfg, tcfg


def _gmg_options():
    for shape in [(12, 10), (6, 5, 8)]:
        for smoother in ("jacobi", "rbgs", "line", "zebra"):
            yield shape, dict(smoother=smoother, line_axis=0, cycle_type="v")
            yield shape, dict(smoother=smoother, cycle_type="k")
        yield shape, dict(cycles=2)
        yield shape, dict(cycles=3, cycle_type="v", smoother="zebra")
        for fuse in (0, 10**9):
            yield shape, dict(cycle_type="w", fuse_below=fuse)
            yield shape, dict(cycle_type="w", fuse_below=fuse, degree=1, cycles=2)
    yield (4, 6, 8), dict(semicoarsen_z=True)
    yield (4, 6, 8), dict(semicoarsen_z=True, cycle_type="w", smoother="line")


@pytest.mark.parametrize("shape,kw", list(_gmg_options()))
def test_gmg_apply_options(shape, kw, rng):
    """gmg_apply under each GMG option (each smoother with V and K cycles,
    repeated cycles, the W-cycle unfused and fused, semicoarsening) equals
    the reference's gmg_apply at 1e-12."""
    jst, tst, jcfg, tcfg = _gmg_pair(rng, shape, **kw)
    assert len(tst.stencils) >= 3
    if kw.get("semicoarsen_z"):
        assert tst.stencils[1].grid_shape == (2, 3, 8)
    if kw.get("fuse_below"):
        assert tgmg._fusable(tst, 0, tcfg, torch.float64)
    b = rng.standard_normal(shape)
    ref = jax.jit(lambda s, x: jgmg.gmg_apply(s, x, jcfg))(jst, jnp.asarray(b))
    assert_close(tgmg.gmg_apply(tst, t(b), tcfg), ref, 1e-12, 1e-13)


@pytest.mark.parametrize("shape", [(24, 44, 10), (33, 17)])
def test_w_cycle_fused_is_the_unfused_recursion(shape, rng):
    """The W-cycle through deep_correction's plain version gives the
    unfused recursion's bits (its residual is the post-smooth's second
    output there, a matvec after the smooth here)."""
    jst, tst, jcfg, tcfg = _gmg_pair(rng, shape, cycle_type="w", degree=3,
                                     max_coarse_cells=64, kcycle_min_cells=128)
    rc = t(rng.standard_normal(tst.stencils[1].grid_shape))
    unfused = tgmg._coarse_correction(tst, 1, rc, tcfg)
    fcfg = dataclasses.replace(tcfg, fuse_below=10**9)
    fused = tgmg._coarse_correction(tst, 1, rc, fcfg)
    assert torch.equal(fused, unfused)
    sizes = [int(np.prod(s.grid_shape)) for s in tst.stencils[1:]]
    kinds = kdeep.cycle_kinds(sizes, "w", 128)
    assert kinds[0] == kdeep.WCYCLE and kinds[-1] == kdeep.SINGLE
    ref = jgmg._coarse_correction(jst, 1, jnp.asarray(n(rc)), jcfg)
    assert_close(unfused, ref, 1e-12, 1e-13)


def test_w_cycle_barrier_count_walked_by_hand():
    """The kernel's passes on a 3-level subtree, W over W over the dense
    solve, degree 2.  A cycle on a smoothed level: the pre-smooth's 2 steps
    (2 barriers), the residual (1), the restriction (1), the level below,
    the prolongation (1) and the post-smooth's 2 steps (2): 7 + below.  The
    W-cycle runs two cycles; b − A·e1 shares a pass with the second cycle's
    first smoothing step and e1 + e2 is written by its last one, so no
    barrier is added.  The dense solve: 1."""
    S, W = kdeep.SINGLE, kdeep.WCYCLE
    dense = 1
    level1 = 2 * (7 + dense)          # W on level 1
    level0 = 2 * (7 + level1)         # W on level 0: the level-1 visit twice per cycle
    assert (level1, level0) == (16, 46)
    assert kdeep.barrier_count([W, W, S], 2) == level0
    assert kdeep.barrier_count([W, S, S], 2) == 2 * (7 + 7 + dense)
    # K-cycle levels add three barriers (two reductions, the combination)
    assert kdeep.barrier_count([kdeep.KCYCLE, S, S], 2) == 2 * (7 + 7 + dense) + 3


@pytest.mark.parametrize("n", [5, 32, 33, 100])
def test_warp_order_coarsest_solve(n, rng):
    """The coarsest solve in the subtree kernel's summation order (per row,
    32 strided lane sums, then the shuffle tree) is the product inv·b, and
    the plain subtree with it stays within rounding of the default."""
    inv, b = rng.standard_normal((n, n)), rng.standard_normal(n)
    got = kdeep.warp_order_mv(t(inv), t(b))
    assert_close(got, inv @ b, 1e-13, 1e-14)
    lanes = [sum(inv[:, j] * b[j] for j in range(lane, n, 32)) if lane < n else 0.0
             for lane in range(32)]
    for off in (16, 8, 4, 2, 1):
        lanes = [lanes[i] + lanes[i + off] for i in range(off)]
    assert_close(got, lanes[0], 1e-15, 1e-15)


def test_w_subtree_with_the_kernels_coarsest_order(rng):
    jst, tst, jcfg, tcfg = _gmg_pair(rng, (24, 44, 10), cycle_type="w", degree=3,
                                     max_coarse_cells=64, kcycle_min_cells=128)
    rc = t(rng.standard_normal(tst.stencils[1].grid_shape))
    kw = dict(degree=3, lam_min_frac=tcfg.lam_min_frac, cycle_type="w", kcycle_min_cells=128)
    args = ([s.packed for s in tst.stencils[1:]], tst.lam_max[1:], tst.coarse_inv, rc)
    warp = kdeep.deep_correction_plain(*args, coarse_solve=kdeep.warp_order_mv, **kw)
    assert_close(warp, kdeep.deep_correction_plain(*args, **kw), 1e-12, 1e-13)
