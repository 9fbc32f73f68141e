"""Port parity of the batched p/T traversal (``CPRConfig.batch_pt``) on the
CPU, where the batched smooth and subtree wrappers run their plain versions
member by member.

- Batched against the sequential block-diagonal stage 1 in the port
  (``triangular=False``, the reference's ``tests/test_variants.py``
  check): the same bits here, with the K-cycle, the fused subtree, the
  other smoothers, two cycles and bf16 coefficients.
- Against the reference's batched (vmapped) apply at 1e-12, from its own
  stacked state carried across and from the same stencil; one
  ``Simulator.step`` with identical Newton and FGMRES counts.
- The reference's two refusals, raised where it raises them (in
  ``cpr_setup``'s CPTR branch: ``variant="cpr"`` ignores the option), and
  the batched wrappers against their members one by one.
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
)
from tests.test_newton_cptr import _tp_case
from thermalporous_torch.interop import config_from_dict
from thermalporous_torch.kernels import deep_cycle as kdeep
from thermalporous_torch.kernels import stencil as kst
from thermalporous_torch.precond import cpr as tcpr
from thermalporous_torch.precond import gmg as tgmg
from thermalporous_torch.solve.oracle import oracle_run
from thermalporous_tpu.precond import cpr as jcpr
from thermalporous_tpu.precond import gmg as jgmg

torch.set_num_threads(1)

RTOL = 1e-12


@pytest.fixture(scope="module")
def system():
    """The assembled Jacobian of a 3D two-phase case (6×5×4) and a
    right-hand side, in both packages."""
    c = model_case((6, 5, 4), seed=7)
    js = jax.jit(c["jm"].assemble_stencil)(c["ju"], c["ju0"], c["dt"], c["jd"])
    rhs = -np.asarray(c["jm"].residual(c["ju"], c["ju0"], c["dt"], c["jd"]))
    return js, torch_block(js), rhs


def _configs(gmg=None, **kw):
    """The reference's configuration (one hierarchy configuration for p and
    T, gmg_t=None) and the port's carried from its dict."""
    jcfg = jcpr.CPRConfig(**kw, gmg=jgmg.GMGConfig(**dict(OPTION_GMG, **(gmg or {}))))
    return jcfg, config_from_dict(tcpr.CPRConfig, dataclasses.asdict(jcfg))


BATCHED = {
    "k-cycle": {},
    "fused": dict(gmg=dict(fuse_below=16)),
    "w-cycle-fused-bf16": dict(gmg=dict(cycle_type="w", fuse_below=16), pc_dtype="bf16"),
    "jacobi-cycles2": dict(gmg=dict(smoother="jacobi", cycles=2)),
    "rbgs-inner": dict(gmg=dict(smoother="rbgs"), inner_iters=2),
}


@pytest.mark.parametrize("name", list(BATCHED))
def test_batched_equals_sequential(system, name):
    kw = dict(BATCHED[name])
    _, ts, rhs = system
    _, seq_cfg = _configs(triangular=False, **kw)
    _, bat_cfg = _configs(triangular=False, batch_pt=True, **kw)
    seq, bat = tcpr.cpr_setup(ts, seq_cfg), tcpr.cpr_setup(ts, bat_cfg)
    assert bat.gmg_t is None and bat.gmg_p.batch == 2 and seq.gmg_p.batch == 0
    # the stacked hierarchy is the two sequential ones, member by member
    for m, h in enumerate((seq.gmg_p, seq.gmg_t)):
        for a, b in zip(bat.gmg_p.stencils, h.stencils):
            assert torch.equal(a.packed[m], b.packed)
        assert torch.equal(bat.gmg_p.coarse_inv[m], h.coarse_inv)
    x_seq = tcpr.cpr_apply(seq, t(rhs), seq_cfg)
    x_bat = tcpr.cpr_apply(bat, t(rhs), bat_cfg)
    assert_close(x_bat, x_seq, RTOL)
    assert torch.equal(x_bat, x_seq)


@pytest.mark.parametrize("pc_dtype", ["f32", "bf16"])
def test_batched_apply_matches_the_reference(system, pc_dtype):
    js, ts, rhs = system
    jcfg, tcfg = _configs(triangular=False, batch_pt=True, pc_dtype=pc_dtype,
                          gmg=dict(fuse_below=16))
    jstate = jax.jit(lambda s: jcpr.cpr_setup(s, jcfg))(js)
    assert jstate.gmg_t is None and jstate.gmg_p.coarse_inv.ndim == 3
    ref = jax.jit(lambda s, r: jcpr.cpr_apply(s, r, jcfg))(jstate, jnp.asarray(rhs))
    carried = carry_cpr_state(jstate)
    assert carried.gmg_p.batch == 2
    assert_close(tcpr.cpr_apply(carried, t(rhs), tcfg), ref, RTOL, 1e-13)
    assert_close(tcpr.cpr_apply(tcpr.cpr_setup(ts, tcfg), t(rhs), tcfg), ref, RTOL, 1e-13)


def test_newton_step():
    jm, jd = _tp_case(n=6)
    tm, td = carry_model_data(jm, jd)
    newton_option_parity(jm, jd, tm, td, oracle_run(tm, td, [3600.0])[0],
                         pc=dict(batch_pt=True, triangular=False))


def test_refusals_where_the_reference_refuses(system):
    js, ts, _ = system
    for kw, match in ((dict(batch_pt=True), "batch_pt requires triangular=False"),
                      (dict(batch_pt=True, triangular=False,
                            gmg_t=jgmg.GMGConfig(**OPTION_GMG)),
                       "batch_pt requires gmg_t")):
        jcfg = jcpr.CPRConfig(**dict(dict(gmg=jgmg.GMGConfig(**OPTION_GMG)), **kw))
        tcfg = config_from_dict(tcpr.CPRConfig, dataclasses.asdict(jcfg))   # constructs
        with pytest.raises(ValueError, match=match):
            jcpr.cpr_setup(js, jcfg)
        with pytest.raises(ValueError, match=match):
            tcpr.cpr_setup(ts, tcfg)
    # the CPR variant never reads it, in either package
    _, tcfg = _configs(variant="cpr", batch_pt=True)
    assert tcpr.cpr_setup(ts, tcfg).gmg_p.batch == 0


def test_batched_wrappers_are_their_members():
    """The batched smooth (lam_max of shape (2,)) and subtree (an inverse of
    shape (2, m, m)) return each member's own result, with every second
    output; the smooth's launch plan numbers both members' quads."""
    g = torch.Generator().manual_seed(3)
    shapes = [(6, 5, 4), (3, 3, 2), (2, 2, 1)]
    hier = []
    for m in range(2):
        levels = []
        for s in shapes:
            p = torch.rand((7,) + s, generator=g, dtype=torch.float64) - 0.5
            p[0] = 4.0 + p[0]
            levels.append(tgmg.ScalarStencil(p))
        lam = tuple(tgmg.gershgorin_lambda_max(x) for x in levels[:-1])
        inv = tgmg.dense_inv(levels[-1].to_dense())
        hier.append(tgmg.GMGState(tuple(levels), lam, inv))
    stacked = tgmg.stack_states(hier)
    b = torch.rand((2,) + shapes[0], generator=g, dtype=torch.float64)
    x = torch.rand((2,) + shapes[0], generator=g, dtype=torch.float64)
    packed = stacked.stencils[0].packed
    for second in (None, "residual", "product"):
        got = kst.chebyshev_smooth(packed, b, x, stacked.lam_max[0], 3, 0.3, second=second)
        for m in range(2):
            one = kst.chebyshev_smooth(packed[m], b[m], x[m], stacked.lam_max[0][m], 3, 0.3,
                                       second=second)
            for a, c in zip((got,) if second is None else got,
                            (one,) if second is None else one):
                assert torch.equal(a[m], c)
    kw = dict(degree=2, lam_min_frac=0.3, cycle_type="k", kcycle_min_cells=16)
    rc = b
    got = kdeep.deep_correction([s.packed for s in stacked.stencils], stacked.lam_max,
                                stacked.coarse_inv, rc, **kw)
    for m in range(2):
        h = stacked.member(m)
        one = kdeep.deep_correction([s.packed for s in h.stencils], h.lam_max,
                                    h.coarse_inv, rc[m], **kw)
        assert torch.equal(got[m], one)
    with pytest.raises(ValueError):
        kst.chebyshev_smooth(packed, b[0], None, stacked.lam_max[0], 2, 0.3)
    # 120 cells are 30 quads a member: the batched plan covers 60
    plan1 = kst.smooth_plan(120, 3, 8, 132, 227 * 1024)
    plan2 = kst.smooth_plan(120, 3, 8, 132, 227 * 1024, batch=2)
    assert plan1.blocks * plan1.per_block >= 30
    assert plan2.blocks * plan2.per_block >= 60 > plan1.blocks * plan1.per_block
    with pytest.raises(ValueError):
        kst.smooth_plan(120, 3, 8, 132, 227 * 1024, batch=3)


@pytest.mark.parametrize("members", [1, 2])
def test_subtree_scratch_layout(members):
    """The batched subtree's scratch walked as the kernel addresses it
    (member m of a level's vector k at its offset + m·n): every value of
    the vectors belongs to exactly one (level, vector, member), and the
    blocks' partial sums start right after them."""
    sizes = [145_200 // 100, 363, 50, 6]
    offsets = kdeep.scratch_offsets(sizes, members)
    n_vecs = kdeep.VECS_PER_LEVEL * members * sum(sizes)
    seen = np.zeros(n_vecs, dtype=np.int64)
    for ell, n in enumerate(sizes):
        assert len(offsets[ell]) == kdeep.VECS_PER_LEVEL
        for off in offsets[ell]:
            for m in range(members):
                seen[off + m * n: off + (m + 1) * n] += 1
    assert (seen == 1).all()

