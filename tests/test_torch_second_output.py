"""The smooth's second output, the multigrid cycles that take it, and the
launch plans of the scalar matvec and of the residual/JVP kernel (f64, CPU).

On the card the Chebyshev smooth can return b − A·y or A·y of its result y
from the same launch; on the CPU the plain version forms it as the smooth
followed by the plain matvec, which is what the cycles computed before they
took the second output.  So here: the plain second output is that sequence
bit for bit and agrees with the JAX package's ``chebyshev`` followed by
``ScalarStencil.matvec``; the V- and K-cycle and the CPTR apply give the
bits of the cycles written with a separate matvec; no counter moves on the
CPU.  The plans are pure Python: they are held to covering every cell once,
fitting the card, and refusing 2³¹ cells, and the residual kernel's index
arithmetic (tile, ring, published fluxes) is walked in Python.
"""

import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import assert_close, model_case, poisson_pair, t, torch_block
from thermalporous_torch.kernels import (
    launch_counts,
    reset_launch_counts,
    second_output_counts,
    wrappers,
)
from thermalporous_torch.kernels import residual as kres
from thermalporous_torch.kernels import stencil as kst
from thermalporous_torch.precond import cpr as tcpr
from thermalporous_torch.precond import gmg as tgmg
from thermalporous_torch.precond.chebyshev import chebyshev as t_chebyshev
from thermalporous_torch.precond.chebyshev import gershgorin_lambda_max as t_gershgorin
from thermalporous_tpu.precond import chebyshev as j_chebyshev
from thermalporous_tpu.precond import gershgorin_lambda_max as j_gershgorin

torch.set_num_threads(1)

RTOL = 1e-12
H100 = (132, 232448)     # SMs, bytes of shared memory a block may opt in to
SHAPES = [(9, 7), (5, 4, 6), (7, 5, 3), (9, 13)]


# ------------------------------------------------- the second output, plain

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("degree", [1, 2, 4])
@pytest.mark.parametrize("start", ["x0", "zero"])
def test_second_output_is_the_smooth_then_the_matvec(shape, degree, start, rng):
    js, ts = poisson_pair(rng, shape, shift=0.1)
    b = rng.standard_normal(shape)
    x0 = rng.standard_normal(shape) if start == "x0" else None
    lam_j, lam_t = j_gershgorin(js), t_gershgorin(ts)
    jx = None if x0 is None else jnp.asarray(x0)
    tx = None if x0 is None else t(x0)
    args = (ts.packed, t(b), tx, lam_t, degree, 0.3)
    y = kst.chebyshev_smooth_plain(*args)
    ay = kst.matvec_plain(ts.packed, y)
    jy = j_chebyshev(js, jnp.asarray(b), jx, degree=degree, lam_max=lam_j, lam_min_frac=0.3)
    jay = js.matvec(jy)
    for kind, want, jwant in (("residual", t(b) - ay, jnp.asarray(b) - jay),
                              ("product", ay, jay)):
        for fn in (kst.chebyshev_smooth_plain, kst.chebyshev_smooth):
            got_y, got_2 = fn(*args, second=kind)
            assert torch.equal(got_y, y) and torch.equal(got_2, want)
        assert_close(got_2, jwant, RTOL, 1e-13)
        # through the smoother's front end too
        got_y, got_2 = t_chebyshev(ts, t(b), tx, degree=degree, lam_max=lam_t,
                                   lam_min_frac=0.3, second=kind)
        assert torch.equal(got_y, y) and torch.equal(got_2, want)
    assert torch.equal(kst.chebyshev_smooth(*args), y)


def test_second_output_refuses_an_unknown_kind():
    packed = torch.ones((5, 4, 4), dtype=torch.float64)
    b = torch.ones((4, 4), dtype=torch.float64)
    with pytest.raises(ValueError):
        kst.chebyshev_smooth(packed, b, None, torch.tensor(2.0, dtype=torch.float64), 2, 0.3,
                             second="transpose")


# ------------------------------------- the cycles keep the bits they had

def _v_cycle_separate(state, level, b, cfg):
    """The V-cycle with its residual as a separate matvec after the
    pre-smooth (the cycle as it was before it took the second output)."""
    if level == len(state.stencils) - 1:
        shape = state.stencils[level].grid_shape
        return torch.mv(state.coarse_inv, b.reshape(-1)).reshape(shape)
    st, lam = state.stencils[level], state.lam_max[level]
    fine, coarse = st.grid_shape, state.stencils[level + 1].grid_shape
    factors = tuple(2 if c < f else 1 for f, c in zip(fine, coarse))
    x = tgmg._smooth(st, lam, b, None, cfg)
    r = b - st.matvec(x)
    ec = _correction_separate(state, level + 1, tgmg._blocksum(r, fine, factors), cfg)
    x = x + tgmg._prolong(ec, fine, factors)
    return tgmg._smooth(st, lam, b, x, cfg)


def _correction_separate(state, level, rc, cfg):
    """The coarse correction with the K-cycle's products as separate
    matvecs of the cycles' results."""
    e1 = _v_cycle_separate(state, level, rc, cfg)
    if (cfg.cycle_type == "v" or level == len(state.stencils) - 1
            or math.prod(state.stencils[level].grid_shape) < cfg.kcycle_min_cells):
        return e1
    a_mat = state.stencils[level].matvec
    v1 = a_mat(e1)
    rho1 = tgmg._vdot(v1, e1)
    alpha1 = tgmg._vdot(rc, e1)
    safe = torch.where(torch.abs(rho1) > 0, rho1, 1.0)
    x = (alpha1 / safe) * e1
    r1 = rc - (alpha1 / safe) * v1
    e2 = _v_cycle_separate(state, level, r1, cfg)
    v2 = a_mat(e2)
    gamma = tgmg._vdot(v1, e2)
    beta = tgmg._vdot(v2, e2)
    alpha2 = tgmg._vdot(r1, e2)
    rho2 = beta - gamma * gamma / safe
    safe2 = torch.where(torch.abs(rho2) > 0, rho2, 1.0)
    return x + (alpha2 / safe2) * (e2 - (gamma / safe) * e1)


@pytest.mark.parametrize("shape", [(12, 12), (6, 5, 8)])
@pytest.mark.parametrize("cycle,degree", [("v", 2), ("k", 4), ("k", 1)])
def test_gmg_apply_keeps_its_bits(shape, cycle, degree, rng):
    _, ts = poisson_pair(rng, shape, shift=0.05)
    cfg = tgmg.GMGConfig(cycle_type=cycle, degree=degree, max_coarse_cells=4,
                         kcycle_min_cells=16)
    state = tgmg.gmg_setup(ts, cfg)
    assert len(state.stencils) >= 3
    b = t(rng.standard_normal(shape))
    reset_launch_counts()
    got = tgmg.gmg_apply(state, b, cfg)
    assert torch.equal(got, _v_cycle_separate(state, 0, b, cfg))
    # the K-cycle's second level and below as well
    rc = t(rng.standard_normal(state.stencils[1].grid_shape))
    assert torch.equal(tgmg._coarse_correction(state, 1, rc, cfg),
                       _correction_separate(state, 1, rc, cfg))
    assert launch_counts() == {name: 0 for name in wrappers()}
    assert second_output_counts() == {"residual": 0, "product": 0}


@pytest.mark.parametrize("cols", [True, False])
def test_cpr_apply_keeps_its_bits(cols, monkeypatch):
    c = model_case((12, 12), seed=4)
    js = jax.jit(c["jm"].assemble_stencil)(c["ju"], c["ju0"], c["dt"], c["jd"])
    rhs = t(-np.asarray(c["jm"].residual(c["ju"], c["ju0"], c["dt"], c["jd"])))
    kw = dict(max_coarse_cells=4, degree=4, kcycle_min_cells=16)
    cfg = tcpr.CPRConfig(stage2_cols=cols, gmg=tgmg.GMGConfig(**kw),
                         gmg_t=tgmg.GMGConfig(**dict(kw, cycle_type="v", degree=2)))
    state = tcpr.cpr_setup(torch_block(js), cfg)
    got = tcpr.cpr_apply(state, rhs, cfg)
    monkeypatch.setattr(tgmg, "_v_cycle", _v_cycle_separate)
    assert torch.equal(got, tcpr.cpr_apply(state, rhs, cfg))


# --------------------------------------------------------------- the plans

@pytest.mark.parametrize("n", [1, 3, 4, 5, 1023, 1024, 1025, 60 * 220 * 85, 61 * 219 * 83,
                               1023 * 1021, 2**31 - 1])
def test_matvec_plan_gives_every_quad_one_thread(n):
    blocks, threads = kst.matvec_plan(n)
    quads = -(-n // kst.QUAD)
    assert threads == kst.MATVEC_THREADS and threads % 32 == 0
    assert blocks * threads >= quads > (blocks - 1) * threads
    # quad q covers cells 4q .. 4q+3: every cell below n once, 32-bit indices
    assert 4 * (quads - 1) < n <= 4 * quads < 2**32


@pytest.mark.parametrize("plan", [kst.matvec_plan, lambda n: kres.model_plan((n, 1), 132),
                                  lambda n: kres.model_plan((2, n // 2), 132)])
def test_plans_refuse_two_to_the_31_cells(plan):
    with pytest.raises(ValueError):
        plan(2**31)
    with pytest.raises(ValueError):
        plan(0)


MODEL_GRIDS = [(60, 220, 85), (1024, 1024), (64, 64, 32), (61, 219, 83), (1023, 1021),
               (37, 5, 19), (9, 21), (12, 22, 9), (40, 40), (3, 300, 1000), (2, 2), (1, 1, 1),
               (5, 700), (6, 37, 50)]


@pytest.mark.parametrize("shape", MODEL_GRIDS)
@pytest.mark.parametrize("jvp", [False, True])
def test_model_plan_covers_every_cell_once_and_fits_the_card(shape, jvp):
    sms, smem_max = H100
    plan = kres.model_plan(shape, sms, jvp)
    dim = len(shape)
    e0, e1, e2 = shape[0], (shape[1] if dim == 3 else 1), shape[-1]
    assert 1 <= plan.ty * plan.tz <= kres.MODEL_THREADS
    assert plan.threads % 32 == 0 and plan.ty * plan.tz <= plan.threads <= kres.MODEL_THREADS
    assert dim == 3 or plan.ty == 1
    assert (plan.tiles_y, plan.tiles_z, plan.chunks) == (
        -(-e1 // plan.ty), -(-e2 // plan.tz), -(-e0 // plan.lx))
    # rows of at least 32 consecutive cells where the grid has them
    assert plan.tz >= min(e2, 32)
    seen = np.zeros((e0, e1, e2), dtype=np.int32)
    for bx, by, bz in itertools.product(range(plan.chunks), range(plan.tiles_y),
                                        range(plan.tiles_z)):
        seen[bx * plan.lx:(bx + 1) * plan.lx, by * plan.ty:(by + 1) * plan.ty,
             bz * plan.tz:(bz + 1) * plan.tz] += 1
    assert (seen == 1).all()
    # no chunk is empty, and a chunk is worth its first plane's extra face
    assert (plan.chunks - 1) * plan.lx < e0
    assert plan.lx >= min(e0, kres.MODEL_MIN_PLANES)
    for nc, item in itertools.product((2, 3), (4, 8)):
        assert plan.smem(dim, nc, item, jvp) <= smem_max


def test_model_plan_on_the_main_paths():
    """The flagship's, the benchmark's and the geothermal box's tiling."""
    flag = kres.model_plan((60, 220, 85), 132)
    assert (flag.ty, flag.tz, flag.lx, flag.blocks, flag.threads) == (5, 43, 10, 528, 224)
    bench = kres.model_plan((1024, 1024), 132)
    assert (bench.ty, bench.tz, bench.lx, bench.blocks) == (1, 256, 8, 512)
    geo = kres.model_plan((64, 64, 32), 132)
    assert (geo.ty, geo.tz, geo.lx, geo.blocks) == (8, 32, 4, 128)
    # the J(u)v form takes the same tile in shorter chunks
    dual = kres.model_plan((60, 220, 85), 132, jvp=True)
    assert (dual.ty, dual.tz, dual.lx, dual.blocks) == (5, 43, 5, 1056)
    # the largest request: (value, tangent) pairs in f64, six properties
    assert dual.smem(3, 3, 8, True) == 2 * (6 * 7 * 45 * 16 + 2 * 3 * 5 * 43 * 8)


def _walk_plane(plan, dim, e1, e2, by, bz):
    """One plane of tile (by, bz) as csrc/residual.cu's model_kernel indexes
    it: which cell each slot of the tile-with-ring array holds after the
    threads published theirs and the ring was filled, and for every cell
    thread the cells it finds at its four in-plane neighbours (through the
    array, or through the neighbour thread's published flux)."""
    py = 1 if dim == 3 else 0
    ty, tz = plan.ty, plan.tz
    hz, hp = tz + 2, (ty + 2 * py) * (tz + 2)
    y0, z0 = by * ty, bz * tz
    slots, owner = {}, {}
    for tid in range(plan.threads):
        ly, lz = divmod(tid, tz)
        y, z = y0 + ly, z0 + lz
        if tid < ty * tz and y < e1 and z < e2:
            hown = (ly + py) * hz + lz + 1
            assert hown not in slots and hown < hp
            slots[hown] = (y, z)
            owner[tid] = (y, z, ly, lz, hown)
    for k in range(2 * ty + 2 * py * tz):
        if k < 2 * ty:
            hy, hx = (k >> 1) + py, (tz + 1 if k & 1 else 0)
        else:
            m = k - 2 * ty
            hy, hx = (0 if m < tz else ty + 1), (m if m < tz else m - tz) + 1
        yy, zz = y0 + hy - py, z0 + hx - 1
        if 0 <= yy < e1 and 0 <= zz < e2:
            assert hy * hz + hx not in slots and hy * hz + hx < hp
            slots[hy * hz + hx] = (yy, zz)
    found = {}
    for tid, (y, z, ly, lz, hown) in owner.items():
        nb = {}
        if py and y + 1 < e1:
            nb["y+"] = slots[hown + hz]
        if z + 1 < e2:
            nb["z+"] = slots[hown + 1]
        if py and y > 0:
            nb["y-"] = owner[tid - tz][:2] if ly > 0 else slots[hown - hz]
        if z > 0:
            nb["z-"] = owner[tid - 1][:2] if lz > 0 else slots[hown - 1]
        found[(y, z)] = nb
    return found


@pytest.mark.parametrize("shape", [(6, 37, 50), (5, 700), (4, 3, 7), (3, 9, 21), (2, 300, 40),
                                   (2, 5, 300), (3, 33)])
def test_model_kernel_indexing_finds_every_neighbour(shape):
    plan = kres.model_plan(shape, H100[0])
    dim = len(shape)
    e1, e2 = (shape[1] if dim == 3 else 1), shape[-1]
    cells = {}
    for by, bz in itertools.product(range(plan.tiles_y), range(plan.tiles_z)):
        found = _walk_plane(plan, dim, e1, e2, by, bz)
        assert not set(found) & set(cells)
        cells.update(found)
    assert set(cells) == set(itertools.product(range(e1), range(e2)))
    for (y, z), nb in cells.items():
        want = {}
        if dim == 3 and y + 1 < e1:
            want["y+"] = (y + 1, z)
        if z + 1 < e2:
            want["z+"] = (y, z + 1)
        if dim == 3 and y > 0:
            want["y-"] = (y - 1, z)
        if z > 0:
            want["z-"] = (y, z - 1)
        assert nb == want
