"""The probed assembly (``models/base.py:probe_stencil``) on the CPU, f64:
the block stencil from J·v products on coloured unit tangents, held to the
broadcast-tangent assembly (``assemble_stencil``'s plain form, itself held
to the reference in ``tests/test_torch_model.py``).

The J·v product here is the plain ``model.jvp``, the function the
``fused_jvp`` kernel computes on the card.  Cases: both models, 2D and 3D
with gravity, a BHP injector with a temperature, a BHP producer, a rate
well and a heater; the two-phase states hold saturations of exactly 0 and
1 (the cells of ``tests/test_torch_jvp.py::_tie_case``), where the
relative permeabilities' clip passes half the tangent.  Grids of at most
6×5×4 cells; no JAX.
"""

import itertools

import numpy as np
import pytest
import torch

from thermalporous_torch import tracing
from thermalporous_torch.core.grid import Grid
from thermalporous_torch.core.stencil import BlockStencil
from thermalporous_torch.models import SinglePhaseModel, TwoPhaseModel, make_problem_data
from thermalporous_torch.models.base import (
    PROBE_COLOURING,
    _probe_index,
    probe_colours,
    probe_stencil,
)
from thermalporous_torch.physics.props import PhysicalParams
from thermalporous_torch.physics.wells import Heater, Well

torch.set_num_threads(1)

F64 = torch.float64
RTOL = 1e-12
DT = 1200.0


def problem(shape, single_phase=False, seed=0, ties=False):
    """(model, data, u_old, u): ``tests/_torch_parity.py:model_case``'s
    problem built by the port alone — lognormal k, the wells and the heater
    of that case, gravity in 3D — at a perturbed state; with ``ties``, the
    saturation exactly 0 or 1 in the cells of the tie case (their first
    two indices; every layer in 3D)."""
    dim = len(shape)
    rng = np.random.default_rng(seed)
    k = 2e-13 * np.exp(0.5 * rng.standard_normal(shape))
    corner = tuple(m - 1 for m in shape)
    mid = tuple(min(2, m - 1) for m in shape)
    wells = [Well(cells=((0,) * dim,), control="bhp", p_bh=4.0e7, T_inj=420.0),
             Well(cells=(corner,), control="bhp", p_bh=1.0e7),
             Well(cells=(mid,), control="rate", rate=-0.5)]
    heaters = [Heater(cells=(tuple(min(1, m - 1) for m in shape),), power=2e4)]
    grid = Grid(shape=shape, spacing=(5.0,) * dim, thickness=10.0,
                gravity=9.81 if dim == 3 else 0.0)
    pp = PhysicalParams()
    data = make_problem_data(grid, pp, kx=k, phi=0.2, wells=wells, heaters=heaters,
                             dtype=F64, device="cpu")
    model = (SinglePhaseModel if single_phase else TwoPhaseModel)(grid, pp)
    u0 = model.initial_state(data)
    amp = torch.tensor([1e5, 5.0, 0.1][:model.nc], dtype=F64).reshape(
        (model.nc,) + (1,) * dim)
    u = u0 + amp * torch.as_tensor(rng.standard_normal(tuple(u0.shape)), dtype=F64)
    if ties:
        s = u[2]
        for (i, j), value in (((0, 0), 0.0), ((5, 4), 1.0), ((2, 1), 0.0), ((2, 2), 1.0),
                              ((2, 3), 0.0), ((4, 2), 1.0)):
            if i < shape[0] and j < shape[1]:
                s[i, j] = value
    return model, data, u0, u.contiguous()


def assert_stencils_close(got: BlockStencil, ref: BlockStencil) -> None:
    """Every coefficient within RTOL of the largest of its block entry
    (r, c) over slots and cells, whose units it shares."""
    assert got.coef.shape == ref.coef.shape and got.coef.dtype == ref.coef.dtype
    dims = (0,) + tuple(range(3, ref.coef.dim()))
    scale = ref.coef.abs().amax(dim=dims, keepdim=True)
    assert ((got.coef - ref.coef).abs() <= RTOL * scale).all()


def probed(model, data, u0, u) -> BlockStencil:
    return probe_stencil(model.nc, tuple(u.shape[1:]), model.jvp(u, u0, DT, data), u.dtype,
                         u.device)


@pytest.mark.parametrize("kind,shape", [("tp", (6, 5)), ("tp", (5, 4, 3)), ("sp", (6, 5)),
                                        ("sp", (5, 4, 3))],
                         ids=["tp-2d", "tp-3d", "sp-2d", "sp-3d"])
def test_probe_matches_the_assembly(kind, shape):
    """The probed stencil through the plain J·v equals the broadcast-tangent
    assembly at 1e-12 (two-phase: at saturations 0 and 1 too)."""
    model, data, u0, u = problem(shape, single_phase=kind == "sp", seed=4, ties=kind == "tp")
    if kind == "tp":
        assert bool((u[2] == 0).any()) and bool((u[2] == 1).any())
    assert_stencils_close(probed(model, data, u0, u), model.assemble_stencil(u, u0, DT, data))


@pytest.mark.parametrize("kind,shape", [("tp", (2, 1, 4)), ("sp", (1, 5))],
                         ids=["tp-3d-2x1x4", "sp-2d-1x5"])
def test_edge_slots_are_exact_zeros(kind, shape):
    """On grids with axes of 1 and 2 cells: every slot whose neighbour lies
    outside the grid reads an exact zero, and the rest equal the
    assembly's."""
    model, data, u0, u = problem(shape, single_phase=kind == "sp", seed=2)
    got = probed(model, data, u0, u)
    assert_stencils_close(got, model.assemble_stencil(u, u0, DT, data))
    for axis in range(len(shape)):
        last = got.upper[axis].select(2 + axis, shape[axis] - 1)
        first = got.lower[axis].select(2 + axis, 0)
        assert bool((last == 0).all()) and bool((first == 0).all())
    # and nowhere else a zero block where the neighbour exists
    assert bool((got.diag != 0).any(dim=(0, 1)).all())


@pytest.mark.parametrize("dim", [2, 3])
def test_colouring_separates_every_stencil(dim):
    """The offsets 0, ±w_a are distinct mod the colour count, and on a grid
    the gather index names each in-grid neighbour's colour."""
    weights, q = PROBE_COLOURING[dim]
    offsets = [0] + [o for w in weights for o in (w, -w)]
    assert len({o % q for o in offsets}) == len(offsets) == 2 * dim + 1
    shape = (6, 5, 4)[:dim]
    colour = probe_colours(shape, "cpu")
    index = _probe_index(shape, torch.device("cpu")).reshape(2 * dim + 1, *shape)
    for cell in itertools.product(*(range(m) for m in shape)):
        seen = {int(colour[cell])}
        assert int(index[(0,) + cell]) == int(colour[cell])
        for axis, step in itertools.product(range(dim), (1, -1)):
            nb = list(cell)
            nb[axis] += step
            if not 0 <= nb[axis] < shape[axis]:
                continue
            slot = 1 + 2 * axis + (step < 0)
            assert int(index[(slot,) + cell]) == int(colour[tuple(nb)])
            seen.add(int(colour[tuple(nb)]))
        assert len(seen) == 1 + sum(0 <= cell[a] + s < shape[a]
                                    for a in range(dim) for s in (1, -1))


@pytest.mark.parametrize("dim,nc", [(2, 3), (3, 3), (3, 2)])
def test_probe_recovers_any_stencil_and_counts(dim, nc):
    """Through the product of a random block stencil the probe gives back
    its coefficients, the slots outside the grid zeroed; one recorded
    assembly counts ``assembly.probed`` once and ``assembly.probes`` q·nc
    times, one product a probe."""
    shape = (4, 5, 3)[:dim]
    g = torch.Generator().manual_seed(dim * 10 + nc)
    st = BlockStencil(torch.randn((2 * dim + 1, nc, nc) + shape, generator=g, dtype=F64))
    calls = []

    def jvp(v):
        calls.append(v)
        return st.matvec(v)

    with tracing.recording() as rec:
        got = probe_stencil(nc, shape, jvp, F64, "cpu")
    q = PROBE_COLOURING[dim][1]
    assert rec.counters == {"assembly.probed": 1, "assembly.probes": q * nc}
    assert len(calls) == q * nc
    want = st.coef.clone()
    for axis in range(dim):
        want[1 + 2 * axis].select(2 + axis, shape[axis] - 1).zero_()
        want[2 + 2 * axis].select(2 + axis, 0).zero_()
    assert torch.equal(got.coef, want)


def test_cpu_assembly_keeps_the_broadcast_form():
    """On the CPU a given J·v is not used: the assembly stays the
    broadcast-tangent form, and records no probe."""
    model, data, u0, u = problem((4, 3), single_phase=True)

    def jvp(v):
        raise AssertionError("probed on the CPU")

    with tracing.recording() as rec:
        st = model.assemble_stencil(u, u0, DT, data, jvp=jvp)
    assert "assembly.probed" not in rec.counters
    assert torch.equal(st.coef, model.assemble_stencil(u, u0, DT, data).coef)
