"""The red-black stage 2 of the CPTR apply in one launch (f64, CPU): the
stage-2 kernel's plain version against the composition it replaced and
against the JAX package's stage 2, the half-sweep for more sweeps and for a
nonzero start, ``cpr_apply``'s bits, and the kernel's launch plan with its
tile, ring and marching index arithmetic walked in Python (no CPU run
reaches ``csrc/rbgs.cu``)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import assert_close, block_pair, model_case, t, torch_block
from thermalporous_torch.core.stencil import apply_blocks
from thermalporous_torch.kernels import launch_counts, reset_launch_counts, wrappers
from thermalporous_torch.kernels import stencil as kst
from thermalporous_torch.precond import cpr as tcpr
from thermalporous_torch.precond import gmg as tgmg
from thermalporous_torch.precond.chebyshev import block_red_black_gauss_seidel
from thermalporous_tpu.kernels import fused_block_rbgs as j_fused_block_rbgs
from thermalporous_tpu.precond.chebyshev import (
    block_red_black_gauss_seidel as j_block_rbgs,
)

torch.set_num_threads(1)

RTOL = 1e-12
SHAPES = [(6, 5, 4), (5, 3, 7), (7, 9), (4, 11)]


def _looped(st, dinv, b, x, sweeps):
    """The reference's looped red-black block Gauss–Seidel, statement by
    statement, on the port's plain operations."""
    red = kst.checkerboard(st.grid_shape, b.dtype, b.device)
    black = 1.0 - red
    if x is None:
        x = torch.zeros_like(b)
    for _ in range(sweeps):
        x = x + red * apply_blocks(dinv, b - kst.block_matvec_plain(st.coef, x))
        x = x + black * apply_blocks(dinv, b - kst.block_matvec_plain(st.coef, x))
    return x


def _stage2_inputs(rng, shape, nc, k):
    js, ts = block_pair(rng, shape, nc)
    r = rng.standard_normal((nc,) + shape)
    x1 = rng.standard_normal((k,) + shape)
    return js, ts, r, x1


def _reference_r2(js, r, x1):
    """r − A·x₁ as the JAX package's cpr_apply forms it: the column-0:k
    product, the full matvec at k = nc, r itself at k = 0."""
    nc, k = js.nc, x1.shape[0]
    if k == 0:
        return jnp.asarray(r)
    if k < nc:
        return jnp.asarray(r) - js.matvec_cols(jnp.asarray(x1), k)
    return jnp.asarray(r) - js.matvec(jnp.asarray(x1))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("nc,k", [(nc, k) for nc in (1, 2, 3) for k in range(nc + 1)])
def test_stage2_plain_is_the_composition_and_the_reference(shape, nc, k, rng):
    """One sweep: bitwise the apply's former three steps (r − A·x₁, the
    zero-start sweep, + x₁), through the wrapper too, and the JAX package's
    r − A·x₁ → rbgs → x₁ + x₂ at 1e-12."""
    js, ts, r, x1 = _stage2_inputs(rng, shape, nc, k)
    dinv = ts.diag_inverse()
    got = kst.fused_stage2_rbgs_plain(ts.coef, dinv, t(r), t(x1))
    r2 = t(r) - kst.block_matvec_plain(ts.coef, t(x1)) if k else t(r)
    three = kst.fused_block_rbgs_plain(ts.coef, dinv, r2)
    three[0:k] += t(x1)
    assert torch.equal(got, three)
    assert torch.equal(got, kst.fused_stage2_rbgs(ts.coef, dinv, t(r), t(x1)))
    x1_full = np.concatenate([x1, np.zeros((nc - k,) + shape)])
    ref = jnp.asarray(x1_full) + j_block_rbgs(js, js.diag_inverse(), _reference_r2(js, r, x1),
                                              None, sweeps=1)
    assert_close(got, ref, RTOL, 1e-13)


@pytest.mark.parametrize("shape", [(6, 5, 4), (5, 3, 7)])
@pytest.mark.parametrize("k", [0, 2, 3])
def test_stage2_matches_the_pallas_kernel(shape, k, rng):
    """3D: the JAX package's Pallas fused_block_rbgs in interpret mode on
    the reference's r2, plus x₁."""
    js, ts, r, x1 = _stage2_inputs(rng, shape, 3, k)
    got = kst.fused_stage2_rbgs_plain(ts.coef, ts.diag_inverse(), t(r), t(x1))
    x1_full = np.concatenate([x1, np.zeros((3 - k,) + shape)])
    pal = j_fused_block_rbgs(js, js.diag_inverse(), _reference_r2(js, r, x1), interpret=True)
    assert_close(got, jnp.asarray(x1_full) + pal, RTOL, 1e-13)


@pytest.mark.parametrize("shape", [(6, 5, 4), (7, 9)])
@pytest.mark.parametrize("nc", [1, 2, 3])
@pytest.mark.parametrize("sweeps,start", [(1, "x0"), (2, "zero"), (2, "x0"), (3, "zero"),
                                          (3, "x0")])
def test_sweeps_and_starts_match_the_reference(shape, nc, sweeps, start, rng):
    """More sweeps and a nonzero start: the first zero-start sweep is the
    stage-2 kernel's k = 0 call, every other sweep two half-sweeps; bitwise
    the looped form, and the JAX package's looped form at 1e-12; as a stage
    2 after x₁, the reference's x₁ + rbgs(r − A·x₁)."""
    js, ts, r, x1 = _stage2_inputs(rng, shape, nc, min(nc, 2))
    dinv = ts.diag_inverse()
    x0 = rng.standard_normal((nc,) + shape) if start == "x0" else None
    tx0 = None if x0 is None else t(x0)
    got = block_red_black_gauss_seidel(ts, dinv, t(r), tx0, sweeps=sweeps)
    assert torch.equal(got, _looped(ts, dinv, t(r), tx0, sweeps))
    ref = j_block_rbgs(js, js.diag_inverse(), jnp.asarray(r),
                       None if x0 is None else jnp.asarray(x0), sweeps=sweeps)
    assert_close(got, ref, RTOL, 1e-13)
    if start == "zero":
        k = x1.shape[0]
        r2 = t(r) - kst.block_matvec_plain(ts.coef, t(x1))
        stage2 = block_red_black_gauss_seidel(ts, dinv, r2, sweeps=sweeps)
        stage2[0:k] += t(x1)
        x1_full = np.concatenate([x1, np.zeros((nc - k,) + shape)])
        ref2 = jnp.asarray(x1_full) + j_block_rbgs(
            js, js.diag_inverse(), _reference_r2(js, r, x1), None, sweeps=sweeps)
        assert_close(stage2, ref2, RTOL, 1e-13)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("colour", [0, 1])
def test_half_sweep_is_the_looped_statement(shape, colour, rng):
    js, ts = block_pair(rng, shape, 3)
    dinv = ts.diag_inverse()
    b, x = (t(rng.standard_normal((3,) + shape)) for _ in range(2))
    mask = kst.checkerboard(shape, torch.float64, "cpu")
    mask = 1.0 - mask if colour else mask
    want = x + mask * apply_blocks(dinv, b - ts.matvec(x))
    assert torch.equal(kst.block_rbgs_half_sweep(ts.coef, dinv, b, x, colour), want)
    # the other colour's cells keep their values
    other = (mask == 0).expand_as(x)
    assert torch.equal(want[other], x[other])


@pytest.fixture(scope="module")
def system3d():
    c = model_case((6, 8, 10), seed=3)
    js = jax.jit(c["jm"].assemble_stencil)(c["ju"], c["ju0"], c["dt"], c["jd"])
    rhs = -np.asarray(c["jm"].residual(c["ju"], c["ju0"], c["dt"], c["jd"]))
    return torch_block(js), t(rhs)


@pytest.mark.parametrize("sweeps", [1, 2])
@pytest.mark.parametrize("cols", [True, False])
def test_cpr_apply_keeps_the_parents_bits(system3d, sweeps, cols):
    """cpr_apply with the rbgs stage 2 gives the bits of the apply before
    the stage-2 kernel: r2 = r − A·x₁, the looped sweeps, x₂[0:2] += x₁;
    and the CPU run launches no kernel."""
    ts, rhs = system3d
    kw = dict(max_coarse_cells=8, degree=4, kcycle_min_cells=64)
    cfg = tcpr.CPRConfig(stage2="rbgs", stage2_sweeps=sweeps, stage2_cols=cols,
                         gmg=tgmg.GMGConfig(**kw),
                         gmg_t=tgmg.GMGConfig(**dict(kw, cycle_type="v", degree=2)))
    state = tcpr.cpr_setup(ts, cfg)
    reset_launch_counts()
    got = tcpr.cpr_apply(state, rhs, cfg)
    assert launch_counts() == {name: 0 for name in wrappers()}
    e_pt = tcpr._stage1_pt(state, apply_blocks(state.w, rhs)[0:2], cfg)
    if cols:
        r2 = rhs - kst.block_matvec_plain(ts.coef, e_pt)
    else:
        x1 = torch.zeros_like(rhs)
        x1[0:2] = e_pt
        r2 = rhs - kst.block_matvec_plain(ts.coef, x1)
    parent = _looped(ts, state.dinv, r2, None, sweeps)
    parent[0:2] += e_pt
    assert torch.equal(got, parent)


def test_wrappers_refuse_what_the_kernels_do_not_take(rng):
    _, ts = block_pair(rng, (4, 5, 6), 3)
    dinv = ts.diag_inverse()
    r = t(rng.standard_normal((3, 4, 5, 6)))
    with pytest.raises(ValueError):          # k > nc
        kst.fused_stage2_rbgs(ts.coef, dinv, r, torch.zeros((4, 4, 5, 6), dtype=r.dtype))
    with pytest.raises(ValueError):          # x₁ off the grid
        kst.fused_stage2_rbgs(ts.coef, dinv, r, torch.zeros((2, 4, 5, 5), dtype=r.dtype))
    with pytest.raises(ValueError):          # r of the wrong shape
        kst.fused_stage2_rbgs(ts.coef, dinv, r[:2].contiguous(), r[:2].contiguous())
    with pytest.raises(ValueError):
        kst.block_rbgs_half_sweep(ts.coef, dinv, r, r, 2)
    with pytest.raises(ValueError):          # another device than cpu or cuda
        meta = lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta")
        kst.fused_stage2_rbgs(meta(ts.coef), meta(dinv), meta(r), meta(r[:2]))
    with pytest.raises(ValueError):
        kst.stage2_plan((2**16, 2**15), 132)
    with pytest.raises(ValueError):
        kst.stage2_plan((0, 5), 132)


# --------------------------------------------------------------- the plan

H100 = (132, 232_448)
PLAN_GRIDS = [(60, 220, 85), (1024, 1024), (64, 64, 32), (61, 219, 83), (1023, 1021),
              (12, 22, 9), (9, 21), (8, 14, 6), (37, 5, 19), (3, 300, 1000), (2, 2),
              (1, 1, 1), (5, 700), (6, 37, 50), (4, 300, 2), (7, 1, 3)]


@pytest.mark.parametrize("shape", PLAN_GRIDS)
def test_stage2_plan_covers_every_cell_once_and_fits_the_card(shape):
    sms, smem_max = H100
    plan = kst.stage2_plan(shape, sms)
    dim = len(shape)
    e0, e1, e2 = shape[0], (shape[1] if dim == 3 else 1), shape[-1]
    assert plan.tz % 2 == 0 and plan.tz >= 4
    assert plan.ty * plan.tz // 2 <= plan.own < plan.threads <= kst.STAGE2_MAX_THREADS
    assert plan.own % 32 == 0 and plan.threads % 32 == 0
    assert plan.ring == kst.stage2_ring(dim, plan.ty, plan.tz)
    assert plan.threads - plan.own >= plan.ring
    assert dim == 3 or plan.ty == 1
    assert (plan.tiles_y, plan.tiles_z, plan.chunks) == (
        -(-e1 // plan.ty), -(-e2 // plan.tz), -(-e0 // plan.lx))
    # rows of at least 64 consecutive cells where the grid has them
    assert plan.tz >= min(e2 + e2 % 2, 64)
    seen = np.zeros((e0, e1, e2), dtype=np.int32)
    for bx, by, bz in itertools.product(range(plan.chunks), range(plan.tiles_y),
                                        range(plan.tiles_z)):
        seen[bx * plan.lx:(bx + 1) * plan.lx, by * plan.ty:(by + 1) * plan.ty,
             bz * plan.tz:(bz + 1) * plan.tz] += 1
    assert (seen == 1).all()
    assert (plan.chunks - 1) * plan.lx < e0
    assert plan.lx >= min(e0, kst.STAGE2_MIN_PLANES)
    # one wave where the grid is cut into chunks
    assert plan.chunks == 1 or plan.blocks <= kst.STAGE2_BLOCKS_PER_SM * sms
    for nc, item in itertools.product((1, 2, 3), (4, 8)):
        # under the 48 KB a launch may take without opting in
        assert plan.smem(dim, nc, item) <= min(48 * 1024, smem_max)


def test_stage2_plan_on_the_main_paths():
    """The flagship's tile: 5 rows of 86 cells (215 pair threads) and 92
    ring cells, 20 planes a block, 132 blocks of 320 threads; 1024²: half a
    row a block, 16 planes."""
    flag = kst.stage2_plan((60, 220, 85), 132)
    assert (flag.ty, flag.tz, flag.lx, flag.blocks, flag.own, flag.threads) == (
        5, 86, 20, 132, 224, 320)
    bench = kst.stage2_plan((1024, 1024), 132)
    assert (bench.ty, bench.tz, bench.lx, bench.blocks, bench.threads) == (1, 512, 16, 128, 288)
    assert flag.smem(3, 3, 8) == 2 * 3 * 7 * 88 * 8


def _walk_stage2(plan, shape):
    """The stage-2 kernel's schedule as csrc/rbgs.cu:stage2_kernel runs it,
    with cells in place of values: the red cell each thread computes at
    each step (a pair thread's above its black cell, a ring thread's on the
    ring), which cell each shared-memory slot holds in each plane buffer,
    and for every black cell which cells' red values it takes for its 2·dim
    neighbours.  Returns (how often each cell was written, for every black
    cell the neighbours it found)."""
    dim = len(shape)
    e0, e1, e2 = shape[0], (shape[1] if dim == 3 else 1), shape[-1]
    py = 1 if dim == 3 else 0
    ty, tz, pz = plan.ty, plan.tz, plan.tz // 2
    hz = tz + 2
    hy, hr = (ty + 1) // 2, (pz if py else 0)
    writes, found = {}, {}

    def red(x, y, z):
        assert 0 <= x < e0 and 0 <= y < e1 and 0 <= z < e2 and (x + y + z) % 2 == 0
        return (x, y, z)

    for bx, by, bz in itertools.product(range(plan.chunks), range(plan.tiles_y),
                                        range(plan.tiles_z)):
        y0, z0 = by * ty, bz * tz
        x_begin = bx * plan.lx
        x_end = min(x_begin + plan.lx, e0)
        slot = lambda yy, z: (yy - y0 + py) * hz + (z - z0 + 1)
        buf = [{}, {}]

        def publish(b, yy, z, v):
            s = slot(yy, z)
            assert 0 <= s < (ty + 2 * py) * hz
            buf[b][s] = v

        threads = []
        for tid in range(plan.threads):
            own = tid < plan.own
            ly = tid // pz
            th = dict(own=own, y=y0 + ly, za=z0 + 2 * (tid - ly * pz),
                      mine=own and ly < ty and y0 + ly < e1, lo=None, hold=None, up=None)
            k = tid - plan.own
            s = 0 if k < hy else 1 if k < 2 * hy else 2 if k < 2 * hy + hr else 3
            th.update(j=k - (0, hy, 2 * hy, 2 * hy + hr)[s], ring=not own and k < 2 * hy + 2 * hr,
                      ys=(y0, y0, y0 - 1, y0 + ty)[s], zs=(z0 - 1, z0 + tz, z0, z0)[s],
                      seg=s, len=(ty, ty, tz, tz)[s])
            threads.append(th)

        def red_cell(th, x):
            """This thread's red cell of plane x, or None."""
            if th["own"]:
                yy, zz = th["y"], th["za"] + ((x + th["y"]) & 1)
                ok = th["mine"] and zz < e2
            else:
                i = ((x + th["ys"] + th["zs"]) & 1) + 2 * th["j"]
                yy = th["ys"] + i if th["seg"] < 2 else th["ys"]
                zz = th["zs"] if th["seg"] < 2 else th["zs"] + i
                ok = th["ring"] and i < th["len"] and 0 <= yy < e1 and 0 <= zz < e2
            return (yy, zz) if ok and x < e0 else None

        for th in threads:
            cell = red_cell(th, x_begin)
            if cell is not None:
                th["hold"] = red(x_begin, *cell)
                publish(0, *cell, th["hold"])
                if th["own"]:
                    writes[th["hold"]] = writes.get(th["hold"], 0) + 1
            zb = th["za"] + ((x_begin + th["y"] + 1) & 1)
            if th["own"] and x_begin > 0 and th["mine"] and zb < e2:
                th["lo"] = red(x_begin - 1, th["y"], zb)
        for x in range(x_begin, x_end):
            cur = (x - x_begin) & 1
            for th in threads:                # one step: buffer cur is only read
                cell = red_cell(th, x + 1)
                th["up"] = None if cell is None else red(x + 1, *cell)
                if not th["own"]:
                    if cell is not None:
                        publish(cur ^ 1, *cell, th["up"])
                    continue
                y, zb = th["y"], th["za"] + ((x + th["y"] + 1) & 1)
                # every pair thread reads the buffer at its clamped cell's
                # neighbours, padding threads too: in the buffer
                sc = slot(min(y, min(y0 + ty, e1) - 1), min(zb, e2 - 1))
                assert 0 <= sc - (hz if py else 1) and sc + (hz if py else 1) < (ty + 2 * py) * hz
                if th["mine"] and zb < e2:
                    assert (x + y + zb) % 2 == 1
                    s = slot(y, zb)
                    nb = {}
                    if x + 1 < e0:
                        nb["x+"] = th["up"]
                    if x > 0:
                        nb["x-"] = th["lo"]
                    if py and y + 1 < e1:
                        nb["y+"] = buf[cur][s + hz]
                    if py and y > 0:
                        nb["y-"] = buf[cur][s - hz]
                    if zb + 1 < e2:
                        nb["z+"] = buf[cur][s + 1]
                    if zb > 0:
                        nb["z-"] = buf[cur][s - 1]
                    found[(x, y, zb)] = nb
                    writes[(x, y, zb)] = writes.get((x, y, zb), 0) + 1
                if cell is not None:
                    publish(cur ^ 1, *cell, th["up"])
                    if x + 1 < x_end:
                        writes[th["up"]] = writes.get(th["up"], 0) + 1
                th["lo"], th["hold"] = th["hold"], th["up"]
            # the barrier; buffer cur is written again only in the next step
            buf[cur] = {}
    return writes, found


@pytest.mark.parametrize("shape,tiling", [
    ((7, 6, 9), None), ((5, 9, 13), (2, 4, 2)), ((6, 5, 7), (3, 6, 4)), ((9, 11), (1, 4, 3)),
    ((4, 13), None), ((1, 3, 5), (2, 4, 1)), ((3, 1, 6), (1, 4, 2)), ((10, 12, 16), (4, 8, 3)),
])
def test_stage2_kernel_indexing_finds_every_neighbour(shape, tiling):
    """Every cell is written once; every black cell takes the red value of
    exactly its 2·dim neighbours (from its registers along axis 0, from the
    plane buffer in the plane); under the wrapper's plan and under tilings
    that make several tiles, chunks and ring sides."""
    dim = len(shape)
    e0, e1, e2 = shape[0], (shape[1] if dim == 3 else 1), shape[-1]
    plan = kst.stage2_plan(shape, 132)
    if tiling is not None:
        ty, tz, lx = tiling
        plan = kst.Stage2Plan(ty, tz, lx, -(-e1 // ty), -(-e2 // tz), -(-e0 // lx),
                              kst.stage2_ring(dim, ty, tz))
    writes, found = _walk_stage2(plan, shape)
    assert set(writes) == set(itertools.product(range(e0), range(e1), range(e2)))
    assert set(writes.values()) == {1}
    for (x, y, z), nb in found.items():
        want = {}
        if x + 1 < e0:
            want["x+"] = (x + 1, y, z)
        if x > 0:
            want["x-"] = (x - 1, y, z)
        if dim == 3 and y + 1 < e1:
            want["y+"] = (x, y + 1, z)
        if dim == 3 and y > 0:
            want["y-"] = (x, y - 1, z)
        if z + 1 < e2:
            want["z+"] = (x, y, z + 1)
        if z > 0:
            want["z-"] = (x, y, z - 1)
        assert nb == want
    assert len(found) == sum((x + y + z) % 2 for x, y, z in writes)


def test_fused_block_rbgs_is_the_k_zero_call(rng):
    """fused_block_rbgs passes b[:0] as the empty x₁, a contiguous view the
    stage-2 wrapper takes as k = 0."""
    _, ts = block_pair(rng, (3, 4, 5), 2)
    b = t(rng.standard_normal((2, 3, 4, 5)))
    assert b[:0].is_contiguous() and b[:0].shape == (0, 3, 4, 5)
    assert torch.equal(kst.fused_block_rbgs(ts.coef, ts.diag_inverse(), b),
                       kst.fused_block_rbgs_plain(ts.coef, ts.diag_inverse(), b))
