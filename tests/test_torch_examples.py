"""The port's example drivers and package exports against the JAX package,
f64 on the CPU.

- ``thermalporous_torch`` exports ``Grid``, ``PhysicalParams`` and
  ``__version__`` as the reference's package does, with the same fields and
  defaults; ``Grid.cell_centers`` against the reference's at 1e-15.
- ``python -m thermalporous_torch.custom_case`` on the CPU at a short
  ``--days`` against the reference's case through its ``Simulator``: the
  same step records and well rates within 1e-8.
- ``python -m thermalporous_torch.iteration_study``'s 20² row with one step:
  each column's FGMRES and Newton totals equal to the reference's
  ``Simulator.step`` counts.
- Both modules' ``--help``, the refusal of ``--device cuda`` without CUDA,
  and no ``jax`` import in the new modules.
"""

import dataclasses

import numpy as np
import pytest
import torch

import thermalporous_torch
import thermalporous_tpu
from tests._torch_parity import PORT_DIR, forbidden_imports
from thermalporous_torch import custom_case, iteration_study

torch.set_num_threads(1)

DAYS = 0.05


def test_package_exports_match_the_references():
    for name in ("Grid", "PhysicalParams", "__version__"):
        assert name in thermalporous_torch.__all__ and name in thermalporous_tpu.__all__
    assert thermalporous_torch.__version__ == thermalporous_tpu.__version__ == "0.1.0"
    assert dataclasses.asdict(thermalporous_torch.PhysicalParams()) == \
        dataclasses.asdict(thermalporous_tpu.PhysicalParams())
    kw = dict(shape=(4, 3, 2), spacing=(1.0, 2.0, 3.0), thickness=2.0, gravity=9.81,
              depth_top=10.0)
    assert dataclasses.asdict(thermalporous_torch.Grid(**kw)) == \
        dataclasses.asdict(thermalporous_tpu.Grid(**kw))


@pytest.mark.parametrize("shape,spacing", [((7, 5), (3.0, 0.7)),
                                           ((6, 220, 85), (6.096, 3.048, 0.6096))],
                         ids=["2d", "3d"])
def test_cell_centers_match_the_references(shape, spacing):
    tg = thermalporous_torch.Grid(shape=shape, spacing=spacing)
    jg = thermalporous_tpu.Grid(shape=shape, spacing=spacing)
    got = tg.cell_centers(torch.float64, "cpu")
    want = jg.cell_centers()
    assert len(got) == len(want) == len(shape)
    for a, b, n in zip(got, want, shape):
        assert a.shape == (n,) and a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15, atol=0.0)
    assert tg.cell_centers(torch.float32, "cpu")[0].dtype == torch.float32


def _reference_custom_case():
    """The reference's case of ``examples/custom_case.py`` (the same
    construction), run for DAYS: (records, well rates)."""
    from thermalporous_tpu import Grid, PhysicalParams
    from thermalporous_tpu.models import TwoPhaseModel, make_problem_data
    from thermalporous_tpu.physics import CoreyRelPerm, Heater, Well, per_well_masks, well_rates
    from thermalporous_tpu.solve import NewtonConfig, Simulator, TimeConfig

    n = 48
    grid = Grid(shape=(n, n), spacing=(8.0, 8.0), thickness=6.0)
    rng = np.random.default_rng(5)
    kx = 3e-13 * np.exp(0.8 * rng.standard_normal(grid.shape))
    c = n // 2
    wells = [
        Well(cells=((c, c),), control="rate", rate=4.0, T_inj=430.0, name="INJ"),
        Well(cells=((1, 1),), control="bhp", p_bh=1.2e7, name="P_SW"),
        Well(cells=((1, n - 2),), control="bhp", p_bh=1.2e7, name="P_NW"),
        Well(cells=((n - 2, 1),), control="bhp", p_bh=1.2e7, name="P_SE"),
        Well(cells=((n - 2, n - 2),), control="bhp", p_bh=1.2e7, name="P_NE"),
    ]
    heaters = [Heater(cells=((c, c // 2),), power=2.0e5, name="HEAT")]
    pp = PhysicalParams()
    data = make_problem_data(grid, pp, kx=kx, phi=0.22, wells=wells, heaters=heaters)
    model = TwoPhaseModel(grid, pp, relperm=CoreyRelPerm(s_wr=0.1, s_or=0.15, n_w=2.0,
                                                          n_o=2.0), s_init=0.15)
    sim = Simulator(model, data, precond="cptr", newton_cfg=NewtonConfig(ksp_maxiter=80),
                    time_cfg=TimeConfig(dt_init=900.0, dt_max=3 * 86400.0))
    result = sim.run(t_end=DAYS * 86400.0)
    return result.records, well_rates(model, result.u, data,
                                      per_well_masks(grid, wells, heaters))


def test_custom_case_matches_the_reference(capsys):
    from thermalporous_torch.physics import per_well_masks, well_rates

    refs, ref_rates = _reference_custom_case()
    assert custom_case.main(["--days", str(DAYS), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    steps = [line for line in out if line.startswith("step ")]
    assert len(steps) == len(refs) >= 2
    for line, r in zip(steps, refs):
        assert line == (f"step {r.step:4d}  t={r.t:.4e}  dt={r.dt:.3e}  "
                        f"newton={r.newton_iters}  ksp={r.ksp_iters}  retries={r.retries}")
    assert any(line.startswith("convergence: {'steps': ") for line in out)
    assert [line.split()[0] for line in out[-len(ref_rates):]] == list(ref_rates)

    model, data, wells, heaters, sim = custom_case.build("cpu")
    result = sim.run(t_end=DAYS * 86400.0)
    assert [(r.t, r.dt, r.newton_iters, r.ksp_iters, r.retries) for r in result.records] == \
        [(r.t, r.dt, r.newton_iters, r.ksp_iters, r.retries) for r in refs]
    rates = well_rates(model, result.u, data, per_well_masks(model.grid, wells, heaters))
    assert list(rates) == list(ref_rates)
    for name, rec in ref_rates.items():
        assert set(rates[name]) == set(rec)
        for key, want in rec.items():
            assert abs(rates[name][key] - want) <= 1e-8 * max(abs(want), 1.0), (name, key)


def test_iteration_study_row_matches_the_references_counts():
    """The 20x20 single-phase row, one step per column: each column's FGMRES
    and Newton totals equal to the reference's Simulator.step, and the row's
    printed form."""
    from thermalporous_tpu.precond import CPRConfig as JCPRConfig
    from thermalporous_tpu.solve import NewtonConfig as JNewtonConfig
    from thermalporous_tpu.solve import Simulator as JSimulator
    from thermalporous_torch.interop import config_from_dict
    from thermalporous_tpu.core import Grid as JGrid
    from thermalporous_tpu.models import SinglePhaseModel as JSinglePhaseModel
    from thermalporous_tpu.models import make_problem_data as j_make_problem_data
    from thermalporous_tpu.physics import PhysicalParams as JPhysicalParams
    from thermalporous_tpu.physics import Well as JWell

    name, model, data, dt = iteration_study.problems(False, "cpu")[0]
    assert name == "homog 20x20" and dt == 2.0e4
    cols = iteration_study.preconds(False)
    assert [p for p, _ in cols] == ["jacobi", "rbgs", "cpr", "cptr", "cptr-in3"]
    got = iteration_study.row(model, data, dt, cols, 1, "cpu")

    n = 20
    pp = JPhysicalParams()
    g = JGrid(shape=(n, n), spacing=(400.0 / n, 400.0 / n), thickness=10.0)
    k = 1e-13 * np.exp(0.5 * np.random.default_rng(0).standard_normal(g.shape))
    wells = [JWell(cells=((0, 0),), control="bhp", p_bh=3.0e7, T_inj=420.0),
             JWell(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7)]
    jd = j_make_problem_data(g, pp, kx=k, phi=0.2, wells=wells)
    jm = JSinglePhaseModel(g, pp)
    np.testing.assert_array_equal(data.fields.numpy()[0], np.asarray(jd.tgeo[0]))
    want = []
    for (pc, pc_cfg), mine in zip(cols, got):
        jpc = None if pc_cfg is None else JCPRConfig(variant="cptr", inner_iters=3)
        if pc_cfg is not None:
            assert config_from_dict(type(pc_cfg), dataclasses.asdict(jpc)) == pc_cfg
        sim = JSimulator(jm, jd, precond="cptr" if pc.startswith("cptr") else pc, pc_cfg=jpc,
                         newton_cfg=JNewtonConfig(ksp_maxiter=300))
        _, st = sim.step(jm.initial_state(jd), dt)
        assert bool(st.converged)
        want.append((int(st.ksp_iters), int(st.iters)))
    assert got == want
    assert iteration_study.format_row(name, got) == f"{name:20s} " + "  ".join(
        f"{k / n_:8.1f}" for k, n_ in want)


@pytest.mark.parametrize("module", [custom_case, iteration_study],
                         ids=["custom_case", "iteration_study"])
def test_cli_help_and_the_cuda_refusal(module, capsys):
    with pytest.raises(SystemExit) as ex:
        module.main(["--help"])
    assert ex.value.code == 0
    out = capsys.readouterr().out
    assert f"python -m thermalporous_torch.{module.__name__.split('.')[-1]}" in out
    assert "--device" in out
    if not torch.cuda.is_available():
        assert module.main(["--device", "cuda"]) == 1
        assert module.main([]) == 1


def test_new_modules_import_no_jax():
    for rel in ("custom_case.py", "iteration_study.py", "__init__.py", "dist",
                "solve/adjoint.py", "solve/ensemble_data.py", "core/grid.py", "interop.py"):
        assert forbidden_imports(PORT_DIR / rel) == [], rel
