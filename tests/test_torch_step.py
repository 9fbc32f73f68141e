"""Port parity of the whole slice: the benchmark step (two-phase CPTR,
``make_step_fn``) of each package on the same 16×16 problem (f64, CPU).

The configuration is ``bench.py``'s, cut to 16×16 cells, with
``max_coarse_cells=16`` so that both multigrid hierarchies keep three levels
(the benchmark's 1024 would leave a 16×16 grid without coarsening, and
neither the K-cycle nor the Chebyshev smoother would run).  One 600 s step,
then two Δt-doubling steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thermalporous_torch.core as tc
import thermalporous_torch.models as tm
import thermalporous_torch.physics as tp
from thermalporous_torch import require_cuda
from thermalporous_torch.interop import state_to_numpy
from thermalporous_torch.kernels import launch_counts, reset_launch_counts, wrappers
from thermalporous_torch.precond import CPRConfig, GMGConfig
from thermalporous_torch.solve import NewtonConfig, make_step_fn
from thermalporous_tpu.core import Grid as JGrid
from thermalporous_tpu.models import TwoPhaseModel as JTwoPhaseModel
from thermalporous_tpu.models import make_problem_data as j_make_problem_data
from thermalporous_tpu.physics import PhysicalParams as JPhysicalParams
from thermalporous_tpu.physics import Well as JWell
from thermalporous_tpu.precond import CPRConfig as JCPRConfig
from thermalporous_tpu.precond import GMGConfig as JGMGConfig
from thermalporous_tpu.solve import NewtonConfig as JNewtonConfig
from thermalporous_tpu.solve import make_step_fn as j_make_step_fn

torch.set_num_threads(1)

N = 16
DT0 = 600.0
NEWTON_KW = dict(rtol=1e-4, atol=2e-5, ksp_rtol=1e-2, ksp_maxiter=24, max_iters=14,
                 pc_lag="every", krylov_op="stencil", ksp_orth="cgs2g")
GMG_P = dict(cycle_type="k", max_coarse_cells=16, degree=4)
GMG_T = dict(cycle_type="v", max_coarse_cells=16, degree=2)


def _problem():
    rng = np.random.default_rng(11)
    kx = 2e-13 * np.exp(0.5 * rng.standard_normal((N, N)))
    wells = [dict(cells=((0, 0),), control="bhp", p_bh=4.0e7, T_inj=420.0),
             dict(cells=((N - 1, N - 1),), control="bhp", p_bh=1.0e7)]
    return kx, wells


def _jax_run(basis: str):
    kx, wells = _problem()
    g = JGrid(shape=(N, N), spacing=(5.0, 5.0), thickness=10.0)
    pp = JPhysicalParams()
    data = j_make_problem_data(g, pp, kx=kx, phi=0.2,
                               wells=[JWell(**w) for w in wells])
    model = JTwoPhaseModel(g, pp, s_init=0.2)
    pc = JCPRConfig(stage2_cols=True, gmg=JGMGConfig(**GMG_P),
                    gmg_t=JGMGConfig(**GMG_T))
    step = jax.jit(j_make_step_fn(model, "cptr",
                                  JNewtonConfig(ksp_basis=basis, **NEWTON_KW), pc))
    u, dt, out = model.initial_state(data), DT0, []
    for _ in range(3):
        u, st = step(u, jnp.asarray(dt), data)
        st = jax.device_get(st)
        assert bool(st.converged)
        out.append((int(st.iters), int(st.ksp_iters), np.asarray(u)))
        dt *= 2.0
    return out


def _torch_step(basis: str, device="cpu", **newton_overrides):
    kx, wells = _problem()
    g = tc.Grid(shape=(N, N), spacing=(5.0, 5.0), thickness=10.0)
    pp = tp.PhysicalParams()
    data = tm.make_problem_data(g, pp, kx=kx, phi=0.2,
                                wells=[tp.Well(**w) for w in wells],
                                dtype=torch.float64, device="cpu")
    model = tm.TwoPhaseModel(g, pp, s_init=0.2)
    pc = CPRConfig(stage2_cols=True, gmg=GMGConfig(**GMG_P), gmg_t=GMGConfig(**GMG_T))
    cfg = NewtonConfig(ksp_basis=basis, **dict(NEWTON_KW, **newton_overrides))
    return model, data, make_step_fn(model, "cptr", cfg, pc, device=device)


def _torch_run(basis: str):
    model, data, step = _torch_step(basis)
    u, dt, out = model.initial_state(data), DT0, []
    for _ in range(3):
        u, st = step(u, dt, data)
        assert st.converged and not st.failed
        out.append((st.iters, st.ksp_iters, state_to_numpy(u)))
        dt *= 2.0
    return out


@pytest.fixture(scope="module")
def runs_same():
    reset_launch_counts()
    return _jax_run("same"), _torch_run("same")


def test_step_same_basis_matches(runs_same):
    jax_out, torch_out = runs_same
    for (jn, jk, ju), (tn, tk, tu) in zip(jax_out, torch_out):
        assert (tn, tk) == (jn, jk)
        scale = np.abs(ju).max(axis=(1, 2), keepdims=True)
        assert (np.abs(tu - ju) <= 1e-8 * scale).all()
    assert sum(n for n, _, _ in torch_out) >= 4
    assert sum(k for _, k, _ in torch_out) >= 8


def test_cpu_run_launches_no_kernel(runs_same):
    """On the CPU every wrapper takes its plain path: no counter moved."""
    assert launch_counts() == {name: 0 for name in wrappers()}


def test_step_bf16_basis_matches():
    jax_out, torch_out = _jax_run("bf16"), _torch_run("bf16")
    assert [n for n, _, _ in torch_out] == [n for n, _, _ in jax_out]
    jk = sum(k for _, k, _ in jax_out)
    tk = sum(k for _, k, _ in torch_out)
    assert abs(tk - jk) <= 0.1 * jk


def test_cuda_requests_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA device")
    with pytest.raises(RuntimeError):
        require_cuda("cuda")
    with pytest.raises(RuntimeError):
        _torch_step("same", device="cuda")
    # a wrapper given tensors on a device that is neither cpu nor cuda
    # refuses them instead of computing anywhere
    from thermalporous_torch.kernels.stencil import matvec

    meta = torch.empty((5, 4, 4), device="meta")
    with pytest.raises(ValueError):
        matvec(meta, torch.empty((4, 4), device="meta"))


def test_step_refuses_tensors_off_its_device():
    model, data, step = _torch_step("same")
    with pytest.raises(ValueError):
        step(torch.empty((3, N, N), device="meta"), DT0, data)


def test_predictor_guess_anchors_on_the_step_start():
    """A guess equal to the step start changes nothing; a guess worse than
    the step start is discarded (norm_from)."""
    model, data, step = _torch_step("same")
    u0 = model.initial_state(data)
    ref, st_ref = step(u0, DT0, data)
    same, st_same = step(u0, DT0, data, u_guess=u0.clone())
    bad = u0.clone()
    bad[2] += 0.3          # 30% more water in every cell: a far worse residual
    back, st_back = step(u0, DT0, data, u_guess=bad)
    for u, st in ((same, st_same), (back, st_back)):
        assert (st.iters, st.ksp_iters, st.norm0) == (st_ref.iters, st_ref.ksp_iters,
                                                      st_ref.norm0)
        assert torch.equal(u, ref)


def test_unported_newton_options_raise():
    """Every Newton option of the reference is ported: Krylov recycling
    converges, and with ``ksp_restart`` it raises ``ValueError`` as the
    reference does; the single-pass and selective orthogonalization,
    restarts and the frozen preconditioner run (their parity:
    tests/test_torch_krylov_options.py, tests/test_torch_deflate.py)."""
    model, data, step = _torch_step("same", ksp_recycle=4)
    _, st = step(model.initial_state(data), DT0, data)
    assert st.converged
    model, data, step = _torch_step("same", ksp_recycle=4, ksp_restart=8)
    with pytest.raises(ValueError, match="ksp_recycle"):
        step(model.initial_state(data), DT0, data)
    for kw in (dict(ksp_orth="cgs1"), dict(ksp_restart=8), dict(pc_lag="step")):
        model, data, step = _torch_step("same", **kw)
        _, st = step(model.initial_state(data), DT0, data)
        assert st.converged
    assert dataclasses.fields(NewtonConfig)   # same fields as the reference
    assert ({f.name for f in dataclasses.fields(NewtonConfig)}
            == {f.name for f in dataclasses.fields(JNewtonConfig)})
