"""The plain reference against the program, on the CPU at the
configurations' rehearsal sizes: the residual and the Newton test's scales
agree with the program's plain PyTorch model in float64, the reference
accepts the states the program's run produces, on the configuration's own
field and on two others, and it refuses those states rounded to bfloat16
(the control)."""

import json
import math

import pytest
import torch

from portbench import check
from portbench.calibrate import readings_for_field
from portbench.problem import build_program, make_inputs, resolved
from portbench.reference.residual import Reference, peaceman, transmissibility
from portbench.run import ROOT, load_cell

CONFIGS = ("spe10_tp", "geothermal_sp")
CELLS = {"spe10_tp": "spe10_tp.ramp", "geothermal_sp": "geothermal_sp.ramp"}


def f64_inputs(name):
    cell = load_cell(ROOT, CELLS[name])
    cfg = resolved(cell["config"], rehearse=True)
    cfg["dtype"] = "float64"
    inputs = make_inputs(cfg, torch.device("cpu"), ROOT)
    return cfg, inputs


def reference_of(inputs):
    return Reference(inputs.model, inputs.shape, inputs.spacing, inputs.gravity, inputs.fields,
                     inputs.wells, inputs.heaters, inputs.physics, inputs.relperm,
                     torch.device("cpu"))


def varied_state(model, data, seed):
    """The initial state moved by a few percent per cell (both upwind
    directions occur), saturation kept inside (0, 1)."""
    u = model.initial_state(data)
    g = torch.Generator().manual_seed(seed)
    amp = torch.tensor([2e5, 3.0, 0.05][: model.nc], dtype=u.dtype).reshape(
        (-1,) + (1,) * (u.dim() - 1))
    u = u + amp * torch.randn(u.shape, generator=g, dtype=u.dtype)
    if model.nc == 3:
        u[2] = u[2].clamp(0.01, 0.99)
    return u


@pytest.mark.parametrize("name", CONFIGS)
def test_residual_and_scales_match_the_program(name):
    cfg, inputs = f64_inputs(name)
    prog = build_program(cfg, inputs, torch.device("cpu"))
    model, data = prog.model, prog.data
    ref = reference_of(inputs)
    u_old = varied_state(model, data, 1)
    u = varied_state(model, data, 2)
    dt = 1234.5
    want = model.residual(u, u_old, dt, data)
    got = ref.residual(u, u_old, dt)
    for c in range(model.nc):
        scale = float(want[c].abs().max())
        assert float((got[c] - want[c]).abs().max()) <= 1e-10 * scale, c
    want_s = model.residual_scales(u_old, dt, data)
    assert torch.allclose(ref.scales(u_old, dt), want_s, rtol=1e-12, atol=0.0)


def test_transmissibility_and_peaceman():
    k = torch.tensor([[1.0, 3.0, 0.0, 0.0]], dtype=torch.float64).T    # (4, 1)
    t = transmissibility(k, 0, area=2.0, delta=4.0)
    assert torch.allclose(t[:, 0], torch.tensor([2.0 * 2 * 3 / (4 * 4), 0.0, 0.0],
                                                dtype=torch.float64))
    # isotropic: r_e = 0.14·√(dx² + dy²)
    wi = peaceman(1e-13, 1e-13, 10.0, 10.0, 2.0, 0.1)
    assert math.isclose(wi, 2 * math.pi * 1e-13 * 2.0 / math.log(0.14 * math.sqrt(200) / 0.1),
                        rel_tol=1e-14)


# None: the configuration's own field; the others show the reference more
# than the one field a run draws
@pytest.mark.parametrize("base_seed", (None, 11, 4000000019))
@pytest.mark.parametrize("name", CONFIGS)
def test_reference_accepts_the_run_and_refuses_the_control(name, base_seed):
    cell = load_cell(ROOT, CELLS[name])
    row = readings_for_field(cell, base_seed, 1, torch.device("cpu"), rehearse=True)
    limits = cell["limits"]
    ok, shown = check.verdict(row["program"], limits)
    assert ok, shown
    bad, shown = check.verdict(row["control"], limits)
    assert not bad, shown
    # the control fails by the residual, with room: at least 3x the limit
    assert row["control"]["res_rms"] >= 3 * limits["res_rms"], json.dumps(row)
