"""Shared case construction for the torch-port parity tests (not collected).

Inputs are made with numpy from a seed and handed to both packages: the JAX
package builds its problem, and the port receives the same arrays through
``thermalporous_torch.interop``.
"""

from __future__ import annotations

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import torch

import thermalporous_torch.core as tc
import thermalporous_torch.models as tm
import thermalporous_torch.physics as tp
from thermalporous_torch.interop import problem_data_from_numpy, state_from_numpy
from thermalporous_tpu.core import BlockStencil as JBlockStencil
from thermalporous_tpu.core import Grid as JGrid
from thermalporous_tpu.core import ScalarStencil as JScalarStencil
from thermalporous_tpu.kernels.stencil_pallas import pack_block_stencil, pack_stencil
from thermalporous_tpu.models import SinglePhaseModel as JSinglePhaseModel
from thermalporous_tpu.models import TwoPhaseModel as JTwoPhaseModel
from thermalporous_tpu.models import make_problem_data as j_make_problem_data
from thermalporous_tpu.physics import Heater as JHeater
from thermalporous_tpu.physics import PhysicalParams as JPhysicalParams
from thermalporous_tpu.physics import Well as JWell

F64 = torch.float64
PORT_DIR = pathlib.Path(__file__).resolve().parent.parent / "thermalporous_torch"


def t(a, dtype=F64) -> torch.Tensor:
    """numpy / jax array -> contiguous CPU tensor."""
    return torch.as_tensor(np.array(a), dtype=dtype).contiguous()


def n(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_close(got, ref, rtol: float, atol_scale: float = 0.0) -> None:
    """|got − ref| ≤ rtol·|ref| + atol_scale·max|ref| elementwise."""
    got, ref = n(got), n(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol_scale * float(np.abs(ref).max()))


# ------------------------------------------------------------- stencils

def random_block_parts(rng, shape, nc):
    """diag/upper/lower numpy arrays of a diagonally dominant block stencil
    (boundary couplings zero, as an assembled stencil has them)."""
    dim = len(shape)
    blk = lambda: rng.standard_normal((nc, nc) + shape)
    diag = blk() + 4.0 * np.eye(nc).reshape((nc, nc) + (1,) * dim)
    ups, los = [], []
    for a in range(dim):
        up, lo = blk(), blk()
        idx = np.arange(shape[a]).reshape([-1 if i == a else 1 for i in range(dim)])
        up = up * (idx < shape[a] - 1)
        lo = lo * (idx > 0)
        ups.append(up)
        los.append(lo)
    return diag, ups, los


def block_pair(rng, shape, nc):
    """(JAX BlockStencil, torch BlockStencil) with identical coefficients."""
    d, ups, los = random_block_parts(rng, shape, nc)
    js = JBlockStencil(diag=jnp.asarray(d), upper=tuple(map(jnp.asarray, ups)),
                       lower=tuple(map(jnp.asarray, los)))
    return js, torch_block(js)


def torch_block(js: JBlockStencil) -> tc.BlockStencil:
    nc = js.nc
    shape = tuple(js.grid_shape)
    coef = np.asarray(pack_block_stencil(js)).reshape((-1, nc, nc) + shape)
    return tc.BlockStencil(t(coef))


def torch_scalar(js: JScalarStencil) -> tc.ScalarStencil:
    return tc.ScalarStencil(t(pack_stencil(js)))


def poisson_pair(rng, shape, shift=0.5):
    """(JAX, torch) TPFA diffusion stencils with a lognormal coefficient."""
    from tests.test_gmg import poisson_stencil

    k = jnp.asarray(np.exp(rng.standard_normal(shape)))
    js = poisson_stencil(shape, k=k, shift=shift)
    return js, torch_scalar(js)


# --------------------------------------------------------------- models

def model_case(shape, seed=0, dt=1200.0, rate_well=True, heater=True,
               single_phase=False):
    """The two-phase (or, with ``single_phase``, the single-phase) test
    problem in both packages.

    2D grids are horizontal; 3D grids carry gravity.  Wells: a BHP injector
    with T_inj at the origin, a BHP producer at the far corner, optionally a
    producing rate well and a heater.  Returns a dict with ``jm, jd, ju0,
    ju`` (JAX) and ``tm, td, tu0, tu`` (torch, data carried through
    ``interop``), ``v`` (a direction with the state's scales, numpy) and
    ``dt``.
    """
    dim = len(shape)
    grav = 9.81 if dim == 3 else 0.0
    rng = np.random.default_rng(seed)
    k = 2e-13 * np.exp(0.5 * rng.standard_normal(shape))
    corner = tuple(m - 1 for m in shape)
    mid = tuple(min(2, m - 1) for m in shape)
    jwells = [JWell(cells=((0,) * dim,), control="bhp", p_bh=4.0e7, T_inj=420.0),
              JWell(cells=(corner,), control="bhp", p_bh=1.0e7)]
    if rate_well:
        jwells.append(JWell(cells=(mid,), control="rate", rate=-0.5))
    jheaters = [JHeater(cells=(tuple(min(1, m - 1) for m in shape),), power=2e4)] \
        if heater else []
    jg = JGrid(shape=shape, spacing=(5.0,) * dim, thickness=10.0, gravity=grav)
    jpp = JPhysicalParams()
    jd = j_make_problem_data(jg, jpp, kx=k, phi=0.2, wells=jwells, heaters=jheaters)
    jm = (JSinglePhaseModel if single_phase else JTwoPhaseModel)(jg, jpp)
    ju0 = jm.initial_state(jd)
    amp = np.array([1e5, 5.0, 0.1][:jm.nc]).reshape((jm.nc,) + (1,) * dim)
    ju = ju0 + jnp.asarray(amp * rng.standard_normal(ju0.shape))
    v = amp * rng.standard_normal(ju0.shape)

    tg = tc.Grid(shape=shape, spacing=(5.0,) * dim, thickness=10.0, gravity=grav)
    tmod = (tm.SinglePhaseModel if single_phase else tm.TwoPhaseModel)(
        tg, tp.PhysicalParams())
    w = jd.wells
    td = problem_data_from_numpy(
        [np.asarray(a) for a in jd.tgeo], [np.asarray(a) for a in jd.tcond],
        np.asarray(jd.phi), np.asarray(w.wi), np.asarray(w.pbh),
        np.asarray(w.tinj), np.asarray(w.has_tinj), np.asarray(w.qrate),
        np.asarray(w.qheat), dtype=F64, device="cpu")
    torch_wells = [tp.Well(cells=x.cells, control=x.control, p_bh=x.p_bh,
                           rate=x.rate, T_inj=x.T_inj, radius=x.radius)
                   for x in jwells]
    torch_heaters = [tp.Heater(cells=h.cells, power=h.power) for h in jheaters]
    return dict(
        jm=jm, jd=jd, ju0=ju0, ju=ju, tm=tmod, td=td, dt=dt, k=k, v=v,
        tu0=state_from_numpy(np.asarray(ju0), dtype=F64, device="cpu"),
        tu=state_from_numpy(np.asarray(ju), dtype=F64, device="cpu"),
        tgrid=tg, twells=torch_wells, theaters=torch_heaters,
        jwells=jwells, jheaters=jheaters,
    )


# ---------------------------------------------------------------- hygiene

def forbidden_imports(root: pathlib.Path = PORT_DIR) -> list[str]:
    """Every import of jax / thermalporous_tpu under the port package (or in
    one file)."""
    bad = []
    for path in [root] if root.is_file() else sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "thermalporous_tpu"):
                    bad.append(f"{path.relative_to(root.parent)}:{node.lineno} {name}")
    return bad


# ------------------------------------------------------- solver parity

def carry_model_data(jmodel, jdata, dtype=F64):
    """The port's model and problem data of a reference model and its
    ``ProblemData``, carried across as plain arrays (``interop``)."""
    import dataclasses

    from thermalporous_torch.interop import case_from_numpy

    w = jdata.wells
    arrays = dict(tgeo=[np.asarray(a) for a in jdata.tgeo],
                  tcond=[np.asarray(a) for a in jdata.tcond], phi=np.asarray(jdata.phi),
                  wi=np.asarray(w.wi), pbh=np.asarray(w.pbh), tinj=np.asarray(w.tinj),
                  has_tinj=np.asarray(w.has_tinj), qrate=np.asarray(w.qrate),
                  qheat=np.asarray(w.qheat))
    two = jmodel.nc == 3
    case = case_from_numpy(
        model=type(jmodel).__name__, grid=dataclasses.asdict(jmodel.grid),
        params=dataclasses.asdict(jmodel.pp),
        relperm=dataclasses.asdict(jmodel.relperm) if two else None,
        s_init=jmodel.s_init if two else None, data=arrays, newton={}, pc=None,
        time={}, t_end=0.0, dtype=dtype, device="cpu")
    return case.model, case.data


def newton_step_pair(jmodel, jdata, tmodel, tdata, *, precond, jpc, tpc, jnewton, tnewton,
                     dt):
    """One backward-Euler step from the initial state through each package's
    ``Simulator.step``: (JAX state as numpy, JAX stats, port state as numpy,
    port stats)."""
    from thermalporous_torch.solve.timeloop import Simulator as TSimulator
    from thermalporous_tpu.solve import Simulator as JSimulator

    jsim = JSimulator(jmodel, jdata, precond=precond, pc_cfg=jpc, newton_cfg=jnewton)
    ju, jst = jsim.step(jmodel.initial_state(jdata), dt)
    tsim = TSimulator(tmodel, tdata, precond=precond, pc_cfg=tpc, newton_cfg=tnewton,
                      device="cpu")
    tu, tst = tsim.step(tmodel.initial_state(tdata), dt)
    return np.asarray(ju), jst, n(tu), tst


def assert_states_close(got, ref, rtol: float) -> None:
    """|got − ref| ≤ rtol · (each equation's largest |ref|), elementwise."""
    got, ref = n(got), n(ref)
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(axis=1)
    scale = scale.reshape((-1,) + (1,) * (ref.ndim - 1))
    assert got.shape == ref.shape
    assert (np.abs(got - ref) <= rtol * scale).all(), np.abs(got - ref).max()


#: the multigrid of the solver-option cases: a 6×6 grid keeps three levels
#: (36 → 9 → 4 cells), the finest one K-cycled
OPTION_GMG = dict(max_coarse_cells=4, kcycle_min_cells=16, degree=2)
OPTION_DT = 3600.0


def newton_option_parity(jm, jd, tm, td, oracle, *, precond="cptr", pc=None, gmg=None,
                         newton=None):
    """One Newton step from the initial state under one solver option in
    both packages, from the reference's configuration objects carried
    across as dicts: identical Newton and FGMRES counts, states within 1e-8
    of the reference's (per equation's largest value), and within the
    reference's own oracle bound (``tests/test_newton_cptr.py``'s
    ``_compare_states``) of the port's oracle state ``oracle``.  Returns
    both stats."""
    import dataclasses

    from tests.test_newton_cptr import TIGHT, _compare_states
    from thermalporous_torch.interop import config_from_dict
    from thermalporous_torch.precond import CPRConfig
    from thermalporous_torch.solve import NewtonConfig
    from thermalporous_tpu.precond import CPRConfig as JCPRConfig
    from thermalporous_tpu.precond import GMGConfig as JGMGConfig

    jpc = JCPRConfig(**(pc or {}), gmg=JGMGConfig(**dict(OPTION_GMG, **(gmg or {}))))
    jnewton = dataclasses.replace(TIGHT, **(newton or {}))
    tpc = config_from_dict(CPRConfig, dataclasses.asdict(jpc))
    tnewton = config_from_dict(NewtonConfig, dataclasses.asdict(jnewton))
    ju, jst, tu, tst = newton_step_pair(jm, jd, tm, td, precond=precond, jpc=jpc, tpc=tpc,
                                        jnewton=jnewton, tnewton=tnewton, dt=OPTION_DT)
    assert bool(jst.converged) and tst.converged
    assert (tst.iters, tst.ksp_iters) == (int(jst.iters), int(jst.ksp_iters))
    assert_states_close(tu, ju, 1e-8)
    _compare_states(tu, n(oracle))
    return jst, tst


# ------------------------------------------------- preconditioner states

def carry_array(a) -> torch.Tensor | None:
    """A reference array as a contiguous CPU tensor of the same dtype (bf16
    through f32, which holds every bf16 value exactly)."""
    if a is None:
        return None
    if str(a.dtype) == "bfloat16":
        return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(torch.bfloat16).contiguous()
    return torch.as_tensor(np.array(a)).contiguous()


def carry_cpr_state(js):
    """The port's ``CPRState`` of a reference ``CPRState``, leaf by leaf
    and dtype by dtype (the stencils repacked in the port's layout), so
    that the port applies exactly the reference's set-up: its cast
    coefficients included."""
    from thermalporous_torch.precond import transfer as ttr
    from thermalporous_torch.precond.block_gmg import BlockGMGState
    from thermalporous_torch.precond.cpr import CPRState
    from thermalporous_torch.precond.gmg import GMGState
    from thermalporous_tpu.precond import transfer as jtr

    wide = {jtr.WideStencil: ttr.WideStencil, jtr.BoxStencil: ttr.BoxStencil}

    def weights(ws):
        return tuple(None if w is None else ttr.AxisWeights(carry_array(w.w_self),
                                                            carry_array(w.w_out))
                     for w in ws)

    def block(st):
        if st is None:
            return None
        coef = carry_array(pack_block_stencil(st))
        return tc.BlockStencil(coef.reshape((-1, st.nc, st.nc) + tuple(st.grid_shape)))

    def scalar(st):
        return None if st is None else tc.ScalarStencil(carry_array(pack_stencil(st)))

    def gmg(g):
        if g is None:
            return None
        batch = g.coarse_inv.ndim == 3
        stencils = []
        for s in g.stencils:
            if type(s) in wide:     # weighted/variational levels: one tensor
                stencils.append(wide[type(s)](carry_array(s.coef)))
            elif batch:             # stacked: pack each member and stack
                members = [JScalarStencil(diag=s.diag[m], upper=tuple(u[m] for u in s.upper),
                                          lower=tuple(lo[m] for lo in s.lower))
                           for m in range(g.coarse_inv.shape[0])]
                stencils.append(tc.ScalarStencil(torch.stack(
                    [carry_array(pack_stencil(x)) for x in members])))
            else:
                stencils.append(scalar(s))
        return GMGState(tuple(stencils), tuple(carry_array(x) for x in g.lam_max),
                        carry_array(g.coarse_inv), batch=g.coarse_inv.shape[0] if batch else 0,
                        transfers=tuple(weights(ws) for ws in g.transfers))

    def bgmg(b):
        if b is None:
            return None
        return BlockGMGState(tuple(block(s) for s in b.stencils),
                             tuple(carry_array(d) for d in b.dinvs), carry_array(b.coarse_inv))

    fac = None if js.zebra_fac is None else tuple(carry_array(x) for x in js.zebra_fac)
    return CPRState(stencil=block(js.stencil), dinv=carry_array(js.dinv), w=carry_array(js.w),
                    gmg_p=gmg(js.gmg_p), gmg_t=gmg(js.gmg_t), a_tp=scalar(js.a_tp),
                    pt=block(js.pt), a_sp=scalar(js.a_sp), a_st=scalar(js.a_st),
                    a_ss=scalar(js.a_ss), zebra_fac=fac, bgmg=bgmg(js.bgmg),
                    dinv_red=carry_array(js.dinv_red), dinv_black=carry_array(js.dinv_black))


def assert_grad_data_close(got, ref, rtol: float) -> None:
    """A port ``ProblemData``-shaped gradient against the reference's, leaf by
    leaf (``tgeo``/``tcond`` per axis, ``phi`` and each well field):
    |got − ref| ≤ rtol · max|ref leaf| elementwise (a leaf that is zero in the
    reference must be zero in the port)."""
    from thermalporous_torch.interop import problem_data_to_numpy

    g = problem_data_to_numpy(got)
    w = ref.wells
    want = dict(tgeo=ref.tgeo, tcond=ref.tcond, phi=ref.phi, wi=w.wi, pbh=w.pbh,
                tinj=w.tinj, has_tinj=w.has_tinj, qrate=w.qrate, qheat=w.qheat)
    assert set(g) == set(want)
    for name, r in want.items():
        pairs = (zip(g[name], r) if isinstance(r, (tuple, list)) else [(g[name], r)])
        for i, (a, b) in enumerate(pairs):
            b = np.asarray(b)
            assert a.shape == b.shape, (name, i)
            err = float(np.abs(a - b).max())
            assert err <= rtol * float(np.abs(b).max()), (name, i, err, float(np.abs(b).max()))
