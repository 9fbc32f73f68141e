"""Port parity of bf16 preconditioner coefficients (``CPRConfig.pc_dtype``)
against the JAX package, on the CPU, where every kernel wrapper runs its
plain version.

- The cast: for each mode every leaf of the port's ``CPRState`` has the
  reference's dtype at the same place; the Newton operator's stencil stays
  uncast.
- One CPTR apply per mode in f64 from the reference's own (cast) state
  carried across, and from the same stencil through both set-ups, against
  the reference's at 1e-12 of its largest value: a stray bf16 rounding of a
  vector (or of 1/diag where the reference keeps bf16) would show as ~1e-3.
  The output keeps the vectors' dtype.
- One ``Simulator.step`` per mode in f64 (identical Newton and FGMRES
  counts, states within 1e-8), and the flagship configuration in f32 with
  ``pc_dtype="bf16"`` within ``tests/test_torch_f32_parity.py``'s bands.
- The quirk copied: the line smoothers' Thomas recurrences refuse bf16
  coefficients in both packages (the reference's ``lax.scan`` carry).
- The kernels' bf16 access plan (8-byte quads) walked in Python, the
  wrappers' dtype checks, and the fused subtree sized at the stored dtype.
"""

import dataclasses
import functools

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
from tests.test_newton_cptr import _tp_case
from thermalporous_torch.interop import config_from_dict
from thermalporous_torch.kernels import _lib
from thermalporous_torch.kernels import deep_cycle as kdeep
from thermalporous_torch.kernels import stencil as kst
from thermalporous_torch.precond import cpr as tcpr
from thermalporous_torch.precond import gmg as tgmg
from thermalporous_torch.solve.oracle import oracle_run
from thermalporous_tpu.precond import cpr as jcpr
from thermalporous_tpu.precond import gmg as jgmg

torch.set_num_threads(1)

RTOL = 1e-12
MODES = ("bf16", "bf16_gmg", "bf16_s2")
BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def system():
    """The assembled Jacobian of a 3D two-phase case (6×5×4) and a
    right-hand side, in both packages."""
    c = model_case((6, 5, 4), seed=7)
    js = jax.jit(c["jm"].assemble_stencil)(c["ju"], c["ju0"], c["dt"], c["jd"])
    rhs = -np.asarray(c["jm"].residual(c["ju"], c["ju0"], c["dt"], c["jd"]))
    return js, torch_block(js), rhs


@functools.lru_cache(maxsize=None)
def _jsetup(jcfg):
    """The reference's jitted set-up of one configuration, compiled once for
    the module (every test holds the same stencil)."""
    return jax.jit(lambda s: jcpr.cpr_setup(s, jcfg))


@functools.lru_cache(maxsize=None)
def _japply(jcfg):
    """The reference's jitted apply of one configuration, compiled once."""
    return jax.jit(lambda s, r: jcpr.cpr_apply(s, r, jcfg))


def _configs(gmg=None, **kw):
    """The reference's configuration and the port's carried from its dict."""
    g = dict(OPTION_GMG, **(gmg or {}))
    jcfg = jcpr.CPRConfig(**kw, gmg=jgmg.GMGConfig(**g),
                          gmg_t=jgmg.GMGConfig(**dict(g, cycle_type="v")))
    return jcfg, config_from_dict(tcpr.CPRConfig, dataclasses.asdict(jcfg))


#: configurations that reach every group the modes cast: the stage-2
#: stencil and D⁻¹ through the rbgs stage 2 (k = 3 with the saturation leg),
#: the fused subtree, the inner (p, T) operator and the saturation couplings;
#: block Jacobi over x₁'s columns with jacobi2's second product; the
#: premasked halves and the half-sweeps; the zebra stage 2
APPLY_CONFIGS = {
    "rbgs-inner-s_stage-fused": dict(stage2="rbgs", inner_iters=2, s_stage="rbgs",
                                     gmg=dict(fuse_below=16)),
    "jacobi2-abf-s_jacobi": dict(stage2="jacobi2", decoupling="abf", s_stage="jacobi"),
    "block_jacobi-cols": dict(stage2="block_jacobi", gmg=dict(smoother="rbgs")),
    "rbgs-fused-axes-sweeps": dict(stage2="rbgs", stage2_fused=True, stage2_axes=(2,),
                                   stage2_sweeps=2, gmg=dict(smoother="jacobi")),
    "zebra": dict(stage2="zebra", stage2_axis=1, stage2_sweeps=2),
    "bgmg-sweeps-cycles": dict(stage2="bgmg", bgmg_coarse_cells=16, stage2_sweeps=2,
                               bgmg_cycles=2),
}


def _leaf_dtypes_ref(js) -> dict:
    """dtype name of every leaf group of a reference CPRState."""
    leaves = lambda x: sorted({str(a.dtype) for a in jax.tree.leaves(x)})
    out = {f.name: leaves(getattr(js, f.name)) for f in dataclasses.fields(js)
           if f.name not in ("gmg_p", "gmg_t", "bgmg")}
    for h in ("gmg_p", "gmg_t"):
        g = getattr(js, h)
        if g is not None:
            out.update({f"{h}.stencils": leaves(g.stencils), f"{h}.lam_max": leaves(g.lam_max),
                        f"{h}.coarse_inv": leaves(g.coarse_inv)})
    if js.bgmg is not None:
        out.update({f"bgmg.{k}": leaves(getattr(js.bgmg, k))
                    for k in ("stencils", "dinvs", "coarse_inv")})
    return out


def _leaf_dtypes_port(ts) -> dict:
    name = lambda d: str(d).replace("torch.", "")

    def leaves(x):
        if x is None:
            return []
        if isinstance(x, torch.Tensor):
            return [name(x.dtype)]
        if isinstance(x, (tuple, list)):
            return sorted({d for y in x for d in leaves(y)})
        for attr in ("coef", "packed"):
            if hasattr(x, attr):
                return [name(getattr(x, attr).dtype)]
        raise TypeError(type(x))

    out = {f.name: leaves(getattr(ts, f.name)) for f in dataclasses.fields(ts)
           if f.name not in ("gmg_p", "gmg_t", "bgmg")}
    for h in ("gmg_p", "gmg_t"):
        g = getattr(ts, h)
        if g is not None:
            out.update({f"{h}.stencils": leaves(g.stencils), f"{h}.lam_max": leaves(g.lam_max),
                        f"{h}.coarse_inv": leaves(g.coarse_inv)})
    if ts.bgmg is not None:
        out.update({f"bgmg.{k}": leaves(getattr(ts.bgmg, k))
                    for k in ("stencils", "dinvs", "coarse_inv")})
    return out


@pytest.mark.parametrize("mode,config", [(m, "rbgs-inner-s_stage-fused")
                                         for m in ("f32",) + MODES] + [("bf16", "zebra")]
                         + [(m, "bgmg-sweeps-cycles") for m in MODES])
def test_cast_leaf_dtypes(system, mode, config):
    js, ts, _ = system
    kw = dict(APPLY_CONFIGS[config])
    if config.startswith("rbgs"):       # the premasked halves too
        kw.update(stage2_fused=True, stage2_axes=(2,))
    jcfg, tcfg = _configs(pc_dtype=mode, **kw)
    jstate = _jsetup(jcfg)(js)
    tstate = tcpr.cpr_setup(ts, tcfg)
    assert _leaf_dtypes_port(tstate) == _leaf_dtypes_ref(jstate)
    # the Newton operator's stencil is never cast: the state holds a copy
    assert ts.coef.dtype == torch.float64
    assert (tstate.stencil is ts) == (mode in ("f32", "bf16_gmg"))


@pytest.mark.parametrize("mode,config", [(m, "rbgs-inner-s_stage-fused") for m in MODES]
                         + [("bf16", c) for c in APPLY_CONFIGS
                            if c != "rbgs-inner-s_stage-fused"])
def test_apply_of_the_carried_state(system, mode, config):
    """The port's apply of the reference's own cast state: the apply alone
    is compared, in every mode on the configuration that reaches every
    group, and with everything in bf16 on the others."""
    js, _, rhs = system
    jcfg, tcfg = _configs(pc_dtype=mode, **APPLY_CONFIGS[config])
    jstate = _jsetup(jcfg)(js)
    ref = _japply(jcfg)(jstate, jnp.asarray(rhs))
    got = tcpr.cpr_apply(carry_cpr_state(jstate), t(rhs), tcfg)
    assert got.dtype == torch.float64
    assert_close(got, ref, RTOL, 1e-13)


@pytest.mark.parametrize("mode", MODES)
def test_setup_and_apply(system, mode):
    """Set-up and apply from the same stencil in both packages."""
    js, ts, rhs = system
    jcfg, tcfg = _configs(pc_dtype=mode, **APPLY_CONFIGS["rbgs-inner-s_stage-fused"])
    ref = _japply(jcfg)(_jsetup(jcfg)(js), jnp.asarray(rhs))
    got = tcpr.cpr_apply(tcpr.cpr_setup(ts, tcfg), t(rhs), tcfg)
    assert got.dtype == torch.float64
    assert_close(got, ref, RTOL, 1e-13)
    # the cast changes the apply (the modes are not the f32 apply)
    f32 = tcpr.cpr_apply(tcpr.cpr_setup(ts, dataclasses.replace(tcfg, pc_dtype="f32")),
                         t(rhs), tcfg)
    assert not torch.allclose(got, f32, rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(s_stage="zebra", s_axis=2, pc_dtype="bf16"),
                                dict(s_stage="line", s_axis=1, pc_dtype="bf16"),
                                dict(gmg=dict(smoother="line"), pc_dtype="bf16_gmg")],
                         ids=["s_zebra", "s_line", "gmg_line"])
def test_line_smoothers_refuse_bf16_in_both_packages(system, kw):
    """The reference's Thomas recurrence is a ``lax.scan`` whose carry
    starts in the coefficients' dtype and comes back in the vector's: with
    bf16 coefficients it raises, and the port raises where it does."""
    js, ts, rhs = system
    jcfg, tcfg = _configs(**kw)
    jstate = _jsetup(jcfg)(js)
    with pytest.raises(TypeError, match="carry"):
        _japply(jcfg)(jstate, jnp.asarray(rhs))
    with pytest.raises(TypeError, match="carry"):
        tcpr.cpr_apply(tcpr.cpr_setup(ts, tcfg), t(rhs), tcfg)


# ------------------------------------------------------------ Newton steps

@pytest.fixture(scope="module")
def tp6():
    jm, jd = _tp_case(n=6)
    tm, td = carry_model_data(jm, jd)
    return jm, jd, tm, td, oracle_run(tm, td, [3600.0])[0]


@pytest.mark.parametrize("mode", MODES)
def test_newton_step(tp6, mode):
    jm, jd, tm, td, oracle = tp6
    newton_option_parity(jm, jd, tm, td, oracle,
                         pc=dict(pc_dtype=mode, stage2="rbgs", stage2_sweeps=2))


def test_flagship_f32_bf16_within_bands():
    """The flagship configuration in f32 (8×14×6, rbgs stage 2, the
    subtree fused) with every coefficient group in bf16, through both
    packages' Simulator, held to the f32 parity test's bands."""
    from tests.test_torch_f32_parity import _flagship_runs, check_f32_runs

    check_f32_runs(*_flagship_runs("same", pc_dtype="bf16"))


# ------------------------------------------------------------ the kernels

def test_config_fields_and_interop():
    for mode in ("f32",) + MODES:
        assert tcpr.CPRConfig(pc_dtype=mode).pc_dtype == mode
        jd = dataclasses.asdict(jcpr.CPRConfig(pc_dtype=mode))
        assert config_from_dict(tcpr.CPRConfig, jd) == tcpr.CPRConfig(pc_dtype=mode)
    with pytest.raises(ValueError, match="pc_dtype"):
        tcpr.CPRConfig(pc_dtype="fp8")


def test_wrapper_checks_accept_bf16_coefficients_only():
    """bf16 coefficients beside f32 or f64 vectors run (the plain versions
    on the CPU); bf16 vectors, f16 coefficients and coefficient tensors of
    two dtypes are refused."""
    g = torch.Generator().manual_seed(0)
    shape = (4, 5, 3)
    packed = torch.randn((7,) + shape, generator=g, dtype=torch.float64)
    packed[0] += 8.0
    coef = torch.randn((7, 2, 2) + shape, generator=g, dtype=torch.float64)
    coef[0] += 8.0 * torch.eye(2, dtype=torch.float64).reshape(2, 2, 1, 1, 1)
    for vdt in (torch.float32, torch.float64):
        v = torch.randn(shape, generator=g, dtype=vdt)
        pb = packed.to(BF16)
        y = kst.matvec(pb, v)
        assert y.dtype == vdt
        assert torch.equal(y, kst.matvec_plain(pb.to(vdt), v))
        lam = torch.tensor(2.0, dtype=vdt)
        s = kst.chebyshev_smooth(pb, v, None, lam, 2, 0.3)
        assert s.dtype == vdt
        # 1/diag rounds to bf16, so the smooth is not the f-dtype smooth of
        # the converted stencil, but its first step from zero is exactly
        # (bf16(1/diag)) · b / theta + 0
        inv = (1.0 / pb[0]).to(vdt)
        ref1 = kst.chebyshev_smooth_plain(pb, v, None, lam, 1, 0.3)
        lmax, lmin = lam * 1.05, lam * 0.3
        assert torch.equal(ref1, inv * v / (0.5 * (lmax + lmin)))
        cb = coef.to(BF16)
        vv = torch.randn((2,) + shape, generator=g, dtype=vdt)
        assert kst.block_matvec(cb, vv, 2).dtype == vdt
        with pytest.raises(ValueError):
            kst.matvec(packed.to(torch.float16), v)
        with pytest.raises(ValueError):
            kst.matvec(packed.to(torch.float64 if vdt == torch.float32 else torch.float32), v)
        with pytest.raises(TypeError):
            kst.matvec(packed.to(vdt), v.to(BF16))
        with pytest.raises(ValueError):
            kst.fused_stage2_rbgs(cb, coef[0].to(vdt), vv, vv[:0])
    assert _lib.dtype_code(torch.empty(1), torch.empty(1, dtype=BF16)) == 2
    assert _lib.dtype_code(torch.empty(1, dtype=torch.float64),
                           torch.empty(1, dtype=BF16)) == 3
    assert _lib.dtype_code(torch.empty(1, dtype=torch.float64)) == 1


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("n", [12, 13, 60 * 220 * 85 // 8])
def test_quad_access_plan(n, batch):
    """The smooth kernel's quads walked as csrc/stencil.cu walks them: each
    quad lies in one member, the quads cover every member's cells once, and
    with whole quads (n % 4 == 0) every channel load of a quad starts on an
    8-byte boundary in bf16 (one 8-byte load) and on a 16-byte boundary in
    f32 and f64, members included."""
    quads = -(-n // kst.QUAD)
    seen = np.zeros((batch, n), dtype=np.int64)
    for gq in range(batch * quads):
        m, c0, off = kst.quad_address(gq, n, batch, 7)
        assert off == m * 7 * n + c0
        seen[m, c0:min(c0 + 4, n)] += 1
        if n % kst.QUAD == 0:
            for ch in range(7):
                for item, align in ((2, 8), (4, 16), (8, 16)):
                    assert ((off + ch * n) * item) % align == 0
                    assert ((m * n + c0) * item) % (16 if item > 2 else 8) == 0
    assert (seen == 1).all()
    with pytest.raises(ValueError):
        kst.quad_address(batch * quads, n, batch, 7)


def test_subtree_sized_at_the_stored_dtype():
    """The fused subtree counts its stencils at the stored dtype and its
    vectors and inverse at the apply dtype, for every member; the budget
    decides on those bytes.  A hierarchy of the flagship's pressure sizes
    (145.2k → 36.3k → 5,040 → 630 cells below a 567.6k-cell level): from
    145.2k it fits in f32, with bf16 stencils and for both members of
    batch_pt; from 567.6k it does not, even with bf16 stencils."""
    shapes = [(60, 220, 43), (60, 110, 22), (30, 55, 22), (15, 28, 12), (8, 14, 6)]
    sizes = [int(np.prod(s)) for s in shapes]
    assert sizes[:3] == [567_600, 145_200, 36_300]
    inv = sizes[-1] ** 2
    sub = shapes[1:]
    cells = sum(sizes[1:])
    f32 = kdeep.subtree_bytes(sub, inv, torch.float32)
    bf = kdeep.subtree_bytes(sub, inv, torch.float32, coef_dtype=BF16)
    assert f32 == (7 + 10) * 4 * cells + 4 * inv
    assert bf == (7 * 2 + 10 * 4) * cells + 4 * inv
    assert kdeep.subtree_bytes(sub, inv, torch.float32, batch=2) == 2 * f32
    assert kdeep.subtree_bytes(sub, inv, torch.float64, coef_dtype=BF16) == (
        (7 * 2 + 10 * 8) * cells + 8 * inv)
    budget = tgmg.FUSE_L2_BUDGET_BYTES
    assert bf < f32 <= 2 * f32 <= budget
    assert kdeep.subtree_bytes(shapes, inv, torch.float32, coef_dtype=BF16) > budget
    # _fusable reads the stencils' stored dtype and the batch from the state
    states = []
    for seed in range(2):
        g = torch.Generator().manual_seed(seed)
        levels = tuple(tcpr.ScalarStencil(torch.rand((7,) + s, generator=g) + 1.0)
                       for s in shapes[2:])
        states.append(tgmg.GMGState(levels, tuple(torch.tensor(1.5) for _ in levels[:-1]),
                                    torch.eye(sizes[-1])))
    cfg = tgmg.GMGConfig(fuse_below=40_000)
    st = states[0]
    assert tgmg._fusable(st, 0, cfg, torch.float32)
    stacked = tgmg.stack_states(states)
    assert stacked.shape(0) == shapes[2] and stacked.batch == 2
    assert tgmg._fusable(stacked, 0, cfg, torch.float32)
    tight = kdeep.subtree_bytes(shapes[2:], inv, torch.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgmg, "FUSE_L2_BUDGET_BYTES", tight)
        assert tgmg._fusable(st, 0, cfg, torch.float32)
        assert not tgmg._fusable(stacked, 0, cfg, torch.float32)
        cast = tcpr.cast_coefficients(
            tcpr.CPRState(stencil=None, dinv=None, w=None, gmg_p=stacked, gmg_t=None,
                          a_tp=None), "bf16_gmg")
        assert cast.gmg_p.stencils[0].packed.dtype == BF16
        assert cast.gmg_p.coarse_inv.dtype == torch.float32
        mp.setattr(tgmg, "FUSE_L2_BUDGET_BYTES", tight * 2 - 1)
        assert not tgmg._fusable(stacked, 0, cfg, torch.float32)
        assert tgmg._fusable(cast.gmg_p, 0, cfg, torch.float32)
