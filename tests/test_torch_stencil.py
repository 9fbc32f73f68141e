"""Port parity: grid shifts, block/scalar stencils and the stencil kernels'
plain versions against the JAX package (f64, CPU).

On the CPU each kernel wrapper of ``thermalporous_torch.kernels.stencil``
runs its plain PyTorch version; those are held here against the jnp
functions the Pallas kernels stand in for, and against the Pallas kernels
themselves in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thermalporous_torch.core as tc
from tests._torch_parity import (
    assert_close,
    block_pair,
    forbidden_imports,
    poisson_pair,
    t,
)
from thermalporous_torch.kernels import stencil as kst
from thermalporous_torch.precond.chebyshev import chebyshev as t_chebyshev
from thermalporous_torch.precond.chebyshev import gershgorin_lambda_max as t_gershgorin
from thermalporous_tpu import core as jc
from thermalporous_tpu.kernels import stencil_pallas as pallas
from thermalporous_tpu.precond import chebyshev as j_chebyshev
from thermalporous_tpu.precond import gershgorin_lambda_max as j_gershgorin

torch.set_num_threads(1)

RTOL = 1e-12
# The Pallas smooth multiplies a zero start through the first matvec where
# the jnp form (and the port) skips it: results differ by a few ulp of the
# largest entry.
ZERO_START_ATOL = 1e-13

SHAPES = [(9, 7), (5, 4, 6)]


def test_port_imports_neither_jax_nor_reference():
    assert forbidden_imports() == []


@pytest.mark.parametrize("shape", SHAPES)
def test_grid_shifts_and_divergence(shape, rng):
    dim = len(shape)
    u = rng.standard_normal((3,) + shape)
    for a in range(dim):
        assert_close(tc.shift_minus(t(u), a), jc.shift_minus(jnp.asarray(u), a), 0)
        assert_close(tc.shift_plus(t(u), a), jc.shift_plus(jnp.asarray(u), a), 0)
        assert_close(tc.neighbor_plus(t(u), a), jc.neighbor_plus(jnp.asarray(u), a), 0)
        f = u * (np.arange(shape[a]).reshape(
            [1] + [-1 if i == a else 1 for i in range(dim)]) < shape[a] - 1)
        assert_close(tc.divergence_add(t(u), t(f), a),
                     jc.divergence_add(jnp.asarray(u), jnp.asarray(f), a), RTOL)
    k = np.exp(rng.standard_normal(shape))
    k.flat[0] = 0.0   # an impermeable cell beside a permeable one
    jg = jc.Grid(shape=shape, spacing=(2.0,) * dim, thickness=3.0)
    tg = tc.Grid(shape=shape, spacing=(2.0,) * dim, thickness=3.0)
    for got, ref in zip(tc.harmonic_face_transmissibility(tg, [t(k)] * dim),
                        jc.harmonic_face_transmissibility(jg, [jnp.asarray(k)] * dim)):
        assert_close(got, ref, RTOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("nc", [1, 2, 3])
def test_block_matvec_and_cols(shape, nc, rng):
    js, ts = block_pair(rng, shape, nc)
    v = rng.standard_normal((nc,) + shape)
    ref = js.matvec(jnp.asarray(v))
    assert_close(ts.matvec(t(v)), ref, RTOL, 1e-14)
    assert_close(kst.block_matvec_plain(ts.coef, t(v)), ref, RTOL, 1e-14)
    if nc > 1 or len(shape) == 2:
        # the Pallas kernel (interpret mode) computes the same product
        assert_close(ts.matvec(t(v)), pallas.block_matvec(js, jnp.asarray(v),
                                                          interpret=True),
                     RTOL, 1e-14)
    for k in range(1, nc + 1):
        vk = v[:k]
        got = ts.matvec_cols(t(vk), k)
        assert_close(got, js.matvec_cols(jnp.asarray(vk), k), RTOL, 1e-14)
        # A·[v; 0]: the column-restricted product is the full one of the
        # zero-padded vector
        pad = np.concatenate([vk, np.zeros((nc - k,) + shape)])
        assert_close(got, js.matvec(jnp.asarray(pad)), RTOL, 1e-14)


@pytest.mark.parametrize("shape", SHAPES)
def test_scalar_matvec_and_dense(shape, rng):
    js, ts = poisson_pair(rng, shape)
    v = rng.standard_normal(shape)
    ref = js.matvec(jnp.asarray(v))
    assert_close(ts.matvec(t(v)), ref, RTOL, 1e-14)
    assert_close(ts.matvec(t(v)), pallas.matvec(js, jnp.asarray(v), interpret=True),
                 RTOL, 1e-14)
    assert_close(ts.row_abs_sum(), js.row_abs_sum(), RTOL)
    assert_close(ts.to_dense(), js.to_dense(), RTOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("degree", [2, 4])
@pytest.mark.parametrize("start", ["x0", "zero"])
def test_chebyshev_smooth(shape, degree, start, rng):
    js, ts = poisson_pair(rng, shape, shift=0.1)
    b = rng.standard_normal(shape)
    x0 = rng.standard_normal(shape) if start == "x0" else None
    lam_j = j_gershgorin(js)
    lam_t = t_gershgorin(ts)
    assert_close(lam_t, lam_j, RTOL)
    jx = None if x0 is None else jnp.asarray(x0)
    tx = None if x0 is None else t(x0)
    ref = j_chebyshev(js, jnp.asarray(b), jx, degree=degree, lam_max=lam_j,
                      lam_min_frac=0.3)
    got = kst.chebyshev_smooth(ts.packed, t(b), tx, lam_t, degree, 0.3)
    assert_close(got, ref, RTOL, 1e-14)
    assert_close(t_chebyshev(ts, t(b), tx, degree=degree, lam_min_frac=0.3),
                 ref, RTOL, 1e-14)
    pal = pallas.chebyshev_smooth(js, jnp.asarray(b), jx, lam_j, degree=degree,
                                  lam_min_frac=0.3, interpret=True)
    if x0 is None:
        assert_close(got, pal, RTOL, ZERO_START_ATOL)
    else:
        assert_close(got, pal, RTOL, 1e-14)


# shapes whose last extent and whose cell count are no multiples of 4: the
# smooth kernel's threads take 4 consecutive cells, which straddle rows here
RAGGED_SHAPES = [(7, 5, 3), (9, 13), (6, 10, 85)]


@pytest.mark.parametrize("shape", RAGGED_SHAPES)
@pytest.mark.parametrize("degree", [1, 2, 4])
@pytest.mark.parametrize("start", ["x0", "zero"])
def test_chebyshev_smooth_ragged_shapes(shape, degree, start, rng):
    js, ts = poisson_pair(rng, shape, shift=0.1)
    b = rng.standard_normal(shape)
    x0 = rng.standard_normal(shape) if start == "x0" else None
    lam_j, lam_t = j_gershgorin(js), t_gershgorin(ts)
    jx = None if x0 is None else jnp.asarray(x0)
    tx = None if x0 is None else t(x0)
    ref = j_chebyshev(js, jnp.asarray(b), jx, degree=degree, lam_max=lam_j,
                      lam_min_frac=0.3)
    got = kst.chebyshev_smooth(ts.packed, t(b), tx, lam_t, degree, 0.3)
    assert_close(got, ref, RTOL, 1e-14)
    assert torch.equal(got, kst.chebyshev_smooth_plain(ts.packed, t(b), tx, lam_t,
                                                       degree, 0.3))
    pal = pallas.chebyshev_smooth(js, jnp.asarray(b), jx, lam_j, degree=degree,
                                  lam_min_frac=0.3, interpret=True)
    assert_close(got, pal, RTOL, ZERO_START_ATOL if x0 is None else 1e-14)


H100 = (132, 232448)     # SMs, bytes of shared memory a block may opt in to


@pytest.mark.parametrize("n,dim,item", [
    (60 * 220 * 85, 3, 4), (60 * 220 * 85, 3, 8), (60 * 220 * 43, 3, 4),
    (60 * 110 * 22, 3, 4), (1024 * 1024, 2, 4), (1023 * 1021, 2, 8),
    (61 * 219 * 83, 3, 4), (64 * 64 * 32, 3, 4), (105, 3, 8), (117, 2, 8), (5, 2, 4),
])
def test_smooth_plan_covers_the_grid_and_fits_the_card(n, dim, item):
    sms, smem = H100
    plan = kst.smooth_plan(n, dim, item, sms, smem)
    quads = -(-n // kst.QUAD)
    assert 1 <= plan.blocks <= sms                       # co-resident: one block per SM
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= kst.SMOOTH_MAX_THREADS
    assert plan.blocks * plan.per_block >= quads         # every quad has an owner
    assert (plan.blocks - 1) * plan.per_block < quads    # and no block is idle
    assert plan.iters * plan.threads >= plan.per_block
    assert (plan.iters - 1) * plan.threads < plan.per_block
    # equally filled iterations: shrinking the block by a warp would not do
    assert plan.iters * (plan.threads - 32) < plan.per_block
    per_quad = (2 * dim + 3) * kst.QUAD * item
    assert 0 <= plan.cached_quads <= plan.per_block
    assert plan.smem == plan.cached_quads * per_quad <= smem - 1024
    # a partly cached block caches whole warps, and not one warp more would fit
    if plan.cached_quads < plan.per_block:
        assert plan.cached_quads % 32 == 0
        assert plan.smem + 32 * per_quad > smem - 1024


def test_smooth_plan_on_the_flagship_levels():
    """The finest flagship level keeps 74% of its quads on chip in f32 and
    37% in f64; every coarser level keeps everything."""
    fine32 = kst.smooth_plan(60 * 220 * 85, 3, 4, *H100)
    assert (fine32.blocks, fine32.threads, fine32.per_block, fine32.iters,
            fine32.cached_quads) == (132, 448, 2125, 5, 1600)
    assert kst.smooth_plan(60 * 220 * 85, 3, 8, *H100).cached_quads == 800
    for n in (60 * 220 * 43, 60 * 110 * 22, 60 * 55 * 11):
        plan = kst.smooth_plan(n, 3, 4, *H100)
        assert plan.cached_quads == plan.per_block
    small = kst.smooth_plan(16 * 16, 2, 8, *H100)
    assert (small.blocks, small.threads, small.iters) == (1, 64, 1)
    with pytest.raises(ValueError):
        kst.smooth_plan(2**31, 3, 4, *H100)
    with pytest.raises(ValueError):
        kst.smooth_plan(0, 3, 4, *H100)


def test_vector_access_needs_whole_quads_and_aligned_tensors():
    a = torch.zeros(64, dtype=torch.float32)
    assert kst.vector_access(64, a, a[4:], a[8:])
    assert not kst.vector_access(63, a)              # a short last quad
    assert not kst.vector_access(64, a, a[1:])       # 4 bytes off a 16-byte boundary
    d = torch.zeros(64, dtype=torch.float64)
    assert kst.vector_access(64, d, d[2:]) and not kst.vector_access(64, d[1:])


@pytest.mark.parametrize("nc", [1, 2, 3, 4])
def test_block_algebra(nc, rng):
    shape = (4, 5)
    d = rng.standard_normal((nc, nc) + shape) + 3.0 * np.eye(nc).reshape(
        (nc, nc, 1, 1))
    w = rng.standard_normal((nc, nc) + shape)
    v = rng.standard_normal((nc,) + shape)
    assert_close(tc.invert_blocks(t(d)), jc.invert_blocks(jnp.asarray(d)), 1e-10, 1e-13)
    assert_close(tc.apply_blocks(t(w), t(v)),
                 jc.apply_blocks(jnp.asarray(w), jnp.asarray(v)), RTOL, 1e-15)
    from thermalporous_tpu.core.stencil import multiply_blocks as j_mul

    assert_close(tc.multiply_blocks(t(w), t(d)),
                 j_mul(jnp.asarray(w), jnp.asarray(d)), RTOL, 1e-15)


def test_block_views_scale_and_sub(rng):
    shape = (6, 5)
    js, ts = block_pair(rng, shape, 3)
    w = rng.standard_normal((3, 3) + shape)
    jsc, tsc = js.scale_rows(jnp.asarray(w)), ts.scale_rows(t(w))
    assert_close(tsc.diag, jsc.diag, RTOL, 1e-15)
    for a in range(2):
        assert_close(tsc.upper[a], jsc.upper[a], RTOL, 1e-15)
        assert_close(tsc.lower[a], jsc.lower[a], RTOL, 1e-15)
    assert_close(ts.diag_inverse(), js.diag_inverse(), 1e-10, 1e-13)
    s = ts.scalar(1, 0)
    assert s.packed.is_contiguous()
    assert_close(s.packed, pallas.pack_stencil(js.scalar(1, 0)), 0)
    b = ts.block(slice(0, 2), slice(0, 2))
    v = rng.standard_normal((2,) + shape)
    assert_close(b.matvec(t(v)), js.block(slice(0, 2), slice(0, 2)).matvec(
        jnp.asarray(v)), RTOL, 1e-14)


def test_wrappers_check_their_arguments():
    coef = torch.zeros((5, 3, 3, 4, 4), dtype=torch.float64)
    v = torch.zeros((3, 4, 4), dtype=torch.float64)
    with pytest.raises(ValueError):           # k does not match v
        kst.block_matvec(coef, v, 2)
    with pytest.raises(ValueError):           # mixed dtypes
        kst.block_matvec(coef, v.float(), 3)
    with pytest.raises(ValueError):           # non-contiguous
        kst.matvec(torch.zeros((5, 4, 4), dtype=torch.float64), v[0].T)
    with pytest.raises(ValueError):           # lam_max must be 0-dim
        kst.chebyshev_smooth(torch.ones((5, 4, 4)), torch.ones((4, 4)), None,
                             torch.ones(1), 2, 0.3)
