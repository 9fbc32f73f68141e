"""Port parity of the operator-weighted and variational multigrid transfers
(``thermalporous_torch/precond/transfer.py`` and the transfer branch of
``precond/gmg.py``) against the JAX package, f64 on the CPU.

- The cases of ``tests/test_transfer.py``: the wide and box stencils'
  matvecs and dense forms, ``as_wide``, the per-axis weights with their
  floor, P and R = Pᵀ, ``galerkin_wide`` (3^dim-colour probing) and
  ``galerkin_variational`` (per-axis conjugation, two levels deep), each
  against the reference's function at 1e-12 of its largest value.
- ``gmg_setup`` and ``gmg_apply`` per transfer: every level, every weight,
  λ (the variational levels' power iteration from the reference's start
  vector) and the coarsest inverse, and the apply at 1e-12.
- Routing by type: the fused subtree is refused under transfers
  (``_fusable``), and the wide levels never reach the smooth or scalar
  matvec wrappers, which see the finest grid only.
- ``pc_dtype="bf16_gmg"`` casts the wide levels but not the weights, as the
  reference casts them; one ``Simulator.step`` per transfer (and with the
  batched p/T traversal) with the reference's Newton and FGMRES counts.
"""

import dataclasses

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
    torch_scalar,
)
from tests.test_newton_cptr import _tp_case
from tests.test_transfer import _random_diffusion_stencil
from thermalporous_torch import utils as tutils
from thermalporous_torch.interop import config_from_dict
from thermalporous_torch.kernels import stencil as kst
from thermalporous_torch.precond import cpr as tcpr
from thermalporous_torch.precond import gmg as tgmg
from thermalporous_torch.precond import transfer as ttr
from thermalporous_torch.solve.oracle import oracle_run
from thermalporous_tpu.precond import cpr as jcpr
from thermalporous_tpu.precond import gmg as jgmg
from thermalporous_tpu.precond import transfer as jtr

torch.set_num_threads(1)

RTOL = 1e-12

#: (shape, per-axis factors) of the reference's probing and conjugation cases
FACTOR_CASES = [((6, 7), (2, 2)), ((5, 8), (2, 1)), ((4, 6, 5), (2, 2, 2)),
                ((4, 6, 5), (1, 1, 2))]


def _pair(rng, shape, contrast=1.5):
    js = _random_diffusion_stencil(rng, shape, contrast=contrast)
    return js, torch_scalar(js)


def _coarse(shape, factors):
    return tuple(-(-n // 2) if f == 2 else n for n, f in zip(shape, factors))


def _zero_outside(coef, dim):
    """A random wide coefficient tensor with the couplings that point
    outside the domain zeroed (the full-shape convention)."""
    coef = coef.copy()
    shape = coef.shape[dim:]
    widths = coef.shape[:dim]
    for off in np.ndindex(*widths):
        for a, o in enumerate(off):
            d = o - (widths[a] - 1) // 2
            idx = [slice(None)] * dim
            if d > 0:
                idx[a] = slice(shape[a] - d, shape[a])
            elif d < 0:
                idx[a] = slice(0, -d)
            else:
                continue
            coef[off][tuple(idx)] = 0.0
    return coef


def _assert_weights(tw, jw, rtol=RTOL):
    assert len(tw) == len(jw)
    for a, b in zip(tw, jw):
        assert (a is None) == (b is None)
        if a is not None:
            assert_close(a.w_self, b.w_self, rtol, 1e-15)
            assert_close(a.w_out, b.w_out, rtol, 1e-15)


@pytest.mark.parametrize("shape", [(6, 7), (4, 6, 5)])
@pytest.mark.parametrize("kind", ["wide", "box"])
def test_wide_and_box_matvec_match_the_reference(rng, shape, kind):
    dim = len(shape)
    widths = (3,) * dim if kind == "wide" else (5,) + (3,) * (dim - 1)
    coef = _zero_outside(rng.standard_normal(widths + shape), dim)
    jcls, tcls = ((jtr.WideStencil, ttr.WideStencil) if kind == "wide"
                  else (jtr.BoxStencil, ttr.BoxStencil))
    js, ts = jcls(coef=jnp.asarray(coef)), tcls(t(coef))
    v = rng.standard_normal(shape)
    assert_close(ts.matvec(t(v)), js.matvec(jnp.asarray(v)), RTOL, 1e-15)
    assert_close(ts.to_dense(), js.to_dense(), 0.0)
    assert_close(ts.row_abs_sum(), js.row_abs_sum(), RTOL)
    assert_close(ts.diag, js.diag, 0.0)
    assert ts.grid_shape == tuple(js.grid_shape) and ts.dim == js.dim
    # a leading batch axis applies the stencil to each vector
    vb = rng.standard_normal((3,) + shape)
    assert_close(ts.matvec(t(vb)), np.stack([np.asarray(js.matvec(jnp.asarray(x)))
                                             for x in vb]), RTOL, 1e-15)


def test_as_wide_is_the_same_operator(rng):
    js, ts = _pair(rng, (5, 6, 4), contrast=1.0)
    tw, jw = ttr.as_wide(ts), jtr.as_wide(js)
    assert_close(tw.coef, jw.coef, 0.0)
    v = rng.standard_normal((5, 6, 4))
    assert_close(tw.matvec(t(v)), ts.matvec(t(v)), RTOL, 1e-15)


#: the reference's transfer functions, each compiled once per shape
J_WEIGHTS = jax.jit(jtr.transfer_weights, static_argnums=(1, 2))
J_WIDE = jax.jit(jtr.galerkin_wide, static_argnums=2)
J_VAR = jax.jit(jtr.galerkin_variational, static_argnums=2)


@pytest.mark.parametrize("floor", [0.75, 0.5, 0.25])
@pytest.mark.parametrize("shape,factors", FACTOR_CASES)
def test_transfer_weights_match(rng, shape, factors, floor):
    """The weights of a scalar level with the parent-weight floor."""
    js, ts = _pair(rng, shape)
    _assert_weights(ttr.transfer_weights(ts, factors, floor=floor),
                    jtr.transfer_weights(js, factors, floor=floor))
    for w in ttr.transfer_weights(ts, factors, floor=floor):
        if w is not None:
            assert float(w.w_self.min()) >= floor
            assert_close(w.w_self + w.w_out, np.ones(tuple(w.w_self.shape)), 1e-15)


@pytest.mark.parametrize("shape,factors", [FACTOR_CASES[0], FACTOR_CASES[3]])
def test_wide_and_box_level_weights_match(rng, shape, factors):
    """The weights of the wide and box levels below a scalar one: their
    |coupling| sums over each side of the axis."""
    js, ts = _pair(rng, shape)
    jw, tw = J_WEIGHTS(js, factors, 0.5), ttr.transfer_weights(ts, factors, floor=0.5)
    cs = _coarse(shape, factors)
    f2 = tuple(2 if n > 1 else 1 for n in cs)
    for jg, tg in ((J_WIDE, ttr.galerkin_wide), (J_VAR, ttr.galerkin_variational)):
        jl, tl = jg(js, jw, cs), tg(ts, tw, cs)
        _assert_weights(ttr.transfer_weights(tl, f2, floor=0.5), J_WEIGHTS(jl, f2, 0.5))


def test_axis_weights_floor_and_lone_child():
    """The reference's floor regression case, and the lone even child at
    the end of an odd-length axis, which injects."""
    wl = np.array([[1e8, 1e-6, 3.0, 0.0, 2.0]])
    wr = np.array([[1e-6, 1e8, 1.0, 0.0, 0.0]])
    for floor in (0.75, 0.3):
        jw = jtr._axis_weights(jnp.asarray(wl), jnp.asarray(wr), a=1, floor=floor)
        tw = ttr._axis_weights(t(wl), t(wr), a=1, floor=floor)
        assert_close(tw.w_self, jw.w_self, 0.0)
        assert_close(tw.w_out, jw.w_out, 0.0)
        assert float(tw.w_self[0, 4]) == 1.0 and float(tw.w_self[0, 3]) == 1.0


@pytest.mark.parametrize("shape,factors", FACTOR_CASES)
def test_prolong_and_restrict_match_and_restrict_is_the_adjoint(rng, shape, factors):
    js, ts = _pair(rng, shape)
    jw, tw = jtr.transfer_weights(js, factors), ttr.transfer_weights(ts, factors)
    cs = _coarse(shape, factors)
    e, r = rng.standard_normal(cs), rng.standard_normal(shape)
    assert_close(ttr.prolong_weighted(t(e), shape, tw),
                 jtr.prolong_weighted(jnp.asarray(e), shape, jw), RTOL, 1e-15)
    assert_close(ttr.restrict_weighted(t(r), tw),
                 jtr.restrict_weighted(jnp.asarray(r), jw), RTOL, 1e-15)
    # dense P and R: R = Pᵀ
    m, nf = int(np.prod(cs)), int(np.prod(shape))
    P = np.stack([ttr.prolong_weighted(t(c.reshape(cs)), shape, tw).numpy().ravel()
                  for c in np.eye(m)]).T
    R = np.stack([ttr.restrict_weighted(t(c.reshape(shape)), tw).numpy().ravel()
                  for c in np.eye(nf)]).T
    np.testing.assert_allclose(R, P.T, rtol=0, atol=1e-14)
    np.testing.assert_allclose(P.sum(axis=1), 1.0, atol=1e-12)


@pytest.mark.parametrize("shape,factors", FACTOR_CASES)
def test_galerkin_wide_matches_the_reference_and_dense_rap(rng, shape, factors):
    js, ts = _pair(rng, shape)
    jw, tw = jtr.transfer_weights(js, factors), ttr.transfer_weights(ts, factors)
    cs = _coarse(shape, factors)
    got = ttr.galerkin_wide(ts, tw, cs)
    assert_close(got.coef, J_WIDE(js, jw, cs).coef, RTOL, 1e-15)
    m = int(np.prod(cs))
    P = np.stack([ttr.prolong_weighted(t(c.reshape(cs)), shape, tw).numpy().ravel()
                  for c in np.eye(m)]).T
    R = np.stack([tgmg._blocksum(t(c.reshape(shape)), shape, factors).numpy().ravel()
                  for c in np.eye(int(np.prod(shape)))]).T
    np.testing.assert_allclose(got.to_dense().numpy(), R @ ts.to_dense().numpy() @ P,
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("shape,factors,floor", [c + (f,) for c, f in
                                                 zip(FACTOR_CASES, (0.75, 0.5, 0.5, 0.25))])
def test_galerkin_variational_matches_two_levels_deep(rng, shape, factors, floor):
    """PᵀAP per axis against the reference's, and the next level (a box
    level conjugated again) too; the result is the dense PᵀAP."""
    js, ts = _pair(rng, shape)
    jw = J_WEIGHTS(js, factors, floor)
    tw = ttr.transfer_weights(ts, factors, floor=floor)
    cs = _coarse(shape, factors)
    jl, tl = J_VAR(js, jw, cs), ttr.galerkin_variational(ts, tw, cs)
    assert tuple(tl.coef.shape) == tuple(jl.coef.shape)
    assert_close(tl.coef, jl.coef, RTOL, 1e-15)
    m = int(np.prod(cs))
    P = np.stack([ttr.prolong_weighted(t(c.reshape(cs)), shape, tw).numpy().ravel()
                  for c in np.eye(m)]).T
    np.testing.assert_allclose(tl.to_dense().numpy(), P.T @ ts.to_dense().numpy() @ P,
                               rtol=1e-10, atol=1e-10)
    f2 = tuple(2 if n > 1 else 1 for n in cs)
    c2 = _coarse(cs, f2)
    jw2 = J_WEIGHTS(jl, f2, floor)
    tw2 = ttr.transfer_weights(tl, f2, floor=floor)
    assert_close(ttr.galerkin_variational(tl, tw2, c2).coef,
                 J_VAR(jl, jw2, c2).coef, RTOL, 1e-15)


def test_power_iteration_start_is_the_references():
    """The start vector of the port's power iteration is the reference's
    ``jax.random.normal(PRNGKey(seed), shape)``: the same counter bits, so
    a few iterations give the reference's estimate."""
    for dt, jt in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
        for seed, shape in ((0, (7, 9, 5)), (3, (12, 10)), (2**33 + 5, (4, 4))):
            ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, dtype=jt))
            got = tutils.normal_start(shape, dt, seed, device="cpu")
            assert got.dtype == dt and tuple(got.shape) == shape
            tol = 1e-13 if dt == torch.float64 else 1e-5
            np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)


# ------------------------------------------------------------ hierarchies

#: (shape, transfer, GMG overrides): full coarsening in 2D with the K-, V-
#: and W-cycle and Jacobi or rbgs on the wide levels (rbgs falls back to
#: Chebyshev there), a z-first schedule in 3D
HIER_CASES = [((12, 10), "weighted", dict()),
              ((12, 10), "variational", dict(transfer_floor=0.5)),
              ((10, 9), "variational", dict(cycle_type="v", degree=3, smoother="jacobi")),
              ((10, 9), "weighted", dict(cycle_type="w", kcycle_min_cells=4,
                                         smoother="rbgs", cycles=2)),
              ((6, 4, 8), "weighted", dict(level_factors=((1, 1, 2), (2, 2, 1)))),
              ((6, 4, 8), "variational", dict(level_factors=((1, 1, 2), (1, 1, 2)),
                                              transfer_floor=0.5))]


@pytest.mark.parametrize("shape,transfer,kw", HIER_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{tr}-{k}" for s, tr, k in HIER_CASES])
def test_gmg_setup_and_apply_match(rng, shape, transfer, kw):
    js, ts = _pair(rng, shape, contrast=1.0)
    g = dict(dict(max_coarse_cells=8, kcycle_min_cells=16), transfer=transfer, **kw)
    jcfg, tcfg = jgmg.GMGConfig(**g), tgmg.GMGConfig(**g)
    jstate = jax.jit(lambda s: jgmg.gmg_setup(s, jcfg))(js)
    tstate = tgmg.gmg_setup(ts, tcfg)
    assert len(tstate.stencils) == len(jstate.stencils) >= 3
    assert isinstance(tstate.stencils[0], tcpr.ScalarStencil)
    for a, b in zip(tstate.stencils[1:], jstate.stencils[1:]):
        assert type(a).__name__ == type(b).__name__
        assert_close(a.coef, b.coef, RTOL, 1e-15)
    for a, b in zip(tstate.transfers, jstate.transfers):
        _assert_weights(a, b)
    for a, b in zip(tstate.lam_max, jstate.lam_max):
        assert_close(a, b, RTOL)
    assert_close(tstate.coarse_inv, jstate.coarse_inv, 1e-11, 1e-14)
    rhs = rng.standard_normal(shape)
    ref = jax.jit(lambda s, r: jgmg.gmg_apply(s, r, jcfg))(jstate, jnp.asarray(rhs))
    assert_close(tgmg.gmg_apply(tstate, t(rhs), tcfg), ref, RTOL, 1e-13)


def test_transfers_take_no_fused_subtree_and_wide_levels_no_kernel(rng, monkeypatch):
    """With transfers the fused subtree is refused at every level (as the
    reference's ``_fusable``), even with ``fuse_below`` above every level,
    and the wrappers of the smooth and the scalar matvec see the finest
    (scalar) grid only: the wide levels are routed by type to the plain
    iteration and their own matvec."""
    js, ts = _pair(rng, (8, 6, 6), contrast=1.0)
    seen = {"smooth": set(), "matvec": set()}
    real_smooth, real_matvec = kst.chebyshev_smooth, kst.matvec

    def smooth(packed, *a, **k):
        seen["smooth"].add(tuple(packed.shape[1:]))
        return real_smooth(packed, *a, **k)

    def matvec(packed, v):
        seen["matvec"].add(tuple(packed.shape[1:]))
        return real_matvec(packed, v)

    monkeypatch.setattr(kst, "chebyshev_smooth", smooth)
    monkeypatch.setattr(kst, "matvec", matvec)
    for transfer in ("weighted", "variational"):
        cfg = tgmg.GMGConfig(max_coarse_cells=8, transfer=transfer, fuse_below=10**6)
        state = tgmg.gmg_setup(ts, cfg)
        assert state.transfers and not any(tgmg._fusable(state, lv, cfg, torch.float64)
                                           for lv in range(len(state.stencils)))
        assert all(ttr.is_wide(s) for s in state.stencils[1:])
        tgmg.gmg_apply(state, t(rng.standard_normal((8, 6, 6))), cfg)
    assert seen["smooth"] == {(8, 6, 6)}
    assert seen["matvec"] <= {(8, 6, 6)}
    # constant transfer with the same fuse_below does fuse
    cfg = tgmg.GMGConfig(max_coarse_cells=8, fuse_below=10**6)
    assert tgmg._fusable(tgmg.gmg_setup(ts, cfg), 1, cfg, torch.float64)


def test_unknown_transfer_raises():
    with pytest.raises(ValueError, match="transfer"):
        tgmg.GMGConfig(transfer="kwak")


def test_stacked_hierarchies_with_transfers(rng):
    """``stack_states`` carries the wide levels and the weights, ``member``
    gives each back, and the batched apply is each member's own."""
    _, ta = _pair(rng, (8, 6, 6), contrast=1.0)
    _, tb = _pair(rng, (8, 6, 6), contrast=1.0)
    cfg = tgmg.GMGConfig(max_coarse_cells=8, transfer="variational")
    sa, sb = tgmg.gmg_setup(ta, cfg), tgmg.gmg_setup(tb, cfg)
    st = tgmg.stack_states([sa, sb])
    assert st.batch == 2 and st.shape(1) == sa.shape(1)
    for m, s in enumerate((sa, sb)):
        back = st.member(m)
        for x, y in zip(back.stencils[1:], s.stencils[1:]):
            assert torch.equal(x.coef, y.coef)
        for ws, vs in zip(back.transfers, s.transfers):
            for w, v in zip(ws, vs):
                assert (w is None) == (v is None)
                if w is not None:
                    assert torch.equal(w.w_self, v.w_self)
    b = t(rng.standard_normal((2, 8, 6, 6)))
    out = tgmg.gmg_apply(st, b, cfg)
    assert torch.equal(out[0], tgmg.gmg_apply(sa, b[0], cfg))
    assert torch.equal(out[1], tgmg.gmg_apply(sb, b[1], cfg))


# ------------------------------------------------------------ CPTR

@pytest.fixture(scope="module")
def system():
    c = model_case((8, 7), seed=7)
    js = jax.jit(c["jm"].assemble_stencil)(c["ju"], c["ju0"], c["dt"], c["jd"])
    rhs = -np.asarray(c["jm"].residual(c["ju"], c["ju0"], c["dt"], c["jd"]))
    return js, torch_block(js), rhs


def _configs(pc_dtype="f32", **g):
    gg = dict(OPTION_GMG, **g)
    jcfg = jcpr.CPRConfig(stage2="rbgs", pc_dtype=pc_dtype, gmg=jgmg.GMGConfig(**gg),
                          gmg_t=jgmg.GMGConfig(**dict(gg, cycle_type="v")))
    return jcfg, config_from_dict(tcpr.CPRConfig, dataclasses.asdict(jcfg))


@pytest.mark.parametrize("transfer,pc_dtype", [("weighted", "f32"),
                                               ("variational", "bf16_gmg")])
def test_cptr_setup_and_apply_match(system, transfer, pc_dtype):
    """Set-up and apply from the same stencil, and the port's apply of the
    reference's own state carried across; under ``bf16_gmg`` the wide
    levels are bf16 and the weights are not, as in the reference."""
    js, ts, rhs = system
    jcfg, tcfg = _configs(pc_dtype=pc_dtype, transfer=transfer)
    jstate = jax.jit(lambda s: jcpr.cpr_setup(s, jcfg))(js)
    ref = jax.jit(lambda s, r: jcpr.cpr_apply(s, r, jcfg))(jstate, jnp.asarray(rhs))
    tstate = tcpr.cpr_setup(ts, tcfg)
    assert_close(tcpr.cpr_apply(tstate, t(rhs), tcfg), ref, RTOL, 1e-13)
    assert_close(tcpr.cpr_apply(carry_cpr_state(jstate), t(rhs), tcfg), ref, RTOL, 1e-13)
    want = torch.bfloat16 if pc_dtype == "bf16_gmg" else torch.float64
    for g, jg in ((tstate.gmg_p, jstate.gmg_p), (tstate.gmg_t, jstate.gmg_t)):
        assert g.transfers
        assert all(s.coef.dtype == want for s in g.stencils[1:])
        assert all(str(s.coef.dtype) == str(want).replace("torch.", "") for s in jg.stencils[1:])
        assert all(w.w_self.dtype == torch.float64 for ws in g.transfers for w in ws
                   if w is not None)


@pytest.fixture(scope="module")
def tp6():
    jm, jd = _tp_case(n=6)
    tm, td = carry_model_data(jm, jd)
    return jm, jd, tm, td, oracle_run(tm, td, [3600.0])[0]


@pytest.mark.parametrize("opt", [
    dict(gmg=dict(transfer="weighted")),
    dict(gmg=dict(transfer="variational", transfer_floor=0.5)),
    dict(pc=dict(stage2="rbgs", batch_pt=True, triangular=False),
         gmg=dict(transfer="variational")),
], ids=["weighted", "variational", "variational-batch_pt"])
def test_simulator_step_per_transfer(tp6, opt):
    """One ``Simulator.step`` per transfer: the reference's Newton and FGMRES
    counts, states within 1e-8 (``newton_option_parity``)."""
    jm, jd, tm, td, oracle = tp6
    newton_option_parity(jm, jd, tm, td, oracle, **opt)
