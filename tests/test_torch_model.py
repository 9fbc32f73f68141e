"""Port parity: the two-phase model (residual, scales, initial state, stencil
assembly) and the fused-residual kernel's plain path against the JAX package
(f64, CPU), in 2D and in 3D with gravity, with an injector, a producer, a
rate well and a heater."""

import jax
import numpy as np
import pytest
import torch

import thermalporous_torch.models as tm
import thermalporous_torch.physics as tp
from tests._torch_parity import F64, assert_close, model_case, torch_block
from thermalporous_torch.kernels.residual import fused_residual
from thermalporous_tpu.kernels.residual_pallas import fused_residual as j_fused_residual
from thermalporous_tpu.physics import build_well_fields as j_build_well_fields

torch.set_num_threads(1)

RTOL = 1e-12

CASES = [(8, 6), (5, 4, 6)]


@pytest.fixture(scope="module", params=CASES, ids=["2d", "3d"])
def case(request):
    return model_case(request.param)


def test_problem_data_matches(case):
    c = case
    # the port's own make_problem_data gives the reference's fields
    own = tm.make_problem_data(c["tgrid"], tp.PhysicalParams(), kx=c["k"], phi=0.2,
                               wells=c["twells"], heaters=c["theaters"],
                               dtype=F64, device="cpu")
    assert_close(own.fields, c["td"].fields, RTOL)
    assert c["td"].wells.has_tinj.sum() == 1.0
    wf = tp.build_well_fields(c["tgrid"], c["twells"], c["theaters"], kx=c["k"],
                              dtype=F64, device="cpu")
    jw = j_build_well_fields(c["jm"].grid, c["jwells"], c["jheaters"], kx=c["k"])
    for name in ("wi", "pbh", "tinj", "has_tinj", "qrate", "qheat"):
        assert_close(getattr(wf, name), getattr(jw, name), RTOL)


def test_residual_scales_and_initial_state(case):
    c = case
    jm, jd, tmod, td, dt = c["jm"], c["jd"], c["tm"], c["td"], c["dt"]
    assert_close(tmod.initial_state(td), jm.initial_state(jd), RTOL)
    ref = jm.residual(c["ju"], c["ju0"], dt, jd)
    got = tmod.residual(c["tu"], c["tu0"], dt, td)
    assert_close(got, ref, RTOL, 1e-12)
    assert_close(tmod.residual_scales(c["tu0"], dt, td),
                 jm.residual_scales(c["ju0"], dt, jd), RTOL)


def test_fused_residual_plain_path(case):
    """The kernel wrapper on CPU tensors is the plain residual, which matches
    the Pallas kernel (interpret mode)."""
    c = case
    ref = j_fused_residual(c["jm"], c["ju"], c["ju0"], c["dt"], c["jd"],
                           interpret=True)
    got = fused_residual(c["tm"], c["tu"], c["tu0"], c["dt"], c["td"])
    assert_close(got, ref, RTOL, 1e-12)


def test_assemble_stencil(case):
    c = case
    js = jax.jit(c["jm"].assemble_stencil)(c["ju"], c["ju0"], c["dt"], c["jd"])
    ts = c["tm"].assemble_stencil(c["tu"], c["tu0"], c["dt"], c["td"])
    assert_close(ts.coef, torch_block(js).coef, RTOL, 1e-14)


def test_stencil_is_the_dense_jacobian():
    c = model_case((4, 3), seed=2)
    tmod, td, u, u0, dt = c["tm"], c["td"], c["tu"], c["tu0"], c["dt"]
    st = tmod.assemble_stencil(u, u0, dt, td)
    jac = torch.func.jacfwd(lambda x: tmod.residual(x, u0, dt, td))(u)
    n = u.numel()
    assert_close(st.to_dense(), jac.reshape(n, n), 1e-11, 1e-13)
    # and the reference's dense Jacobian
    jj = jax.jit(jax.jacfwd(lambda x: c["jm"].residual(x, c["ju0"], dt, c["jd"])))(
        c["ju"])
    assert_close(jac.reshape(n, n), np.asarray(jj).reshape(n, n), RTOL, 1e-14)


def test_fused_residual_refuses_other_devices():
    c = model_case((4, 3), seed=2)
    meta = lambda x: torch.empty_like(x, device="meta")
    with pytest.raises(ValueError):
        fused_residual(c["tm"], meta(c["tu"]), meta(c["tu0"]), 1.0,
                       tm.ProblemData(meta(c["td"].fields)))
    with pytest.raises(ValueError):   # wrong state shape
        fused_residual(c["tm"], c["tu"][:2].contiguous(), c["tu0"][:2].contiguous(),
                       1.0, c["td"])
