"""The ``run_case`` CLI against the reference's ``examples/run_case.py``
(f64, CPU), and ``Simulator`` parity of three presets.

- ``--list`` names exactly the reference's cases.
- In process, ``sp_hot_injection_2d --t-end-days 0.2 --device cpu`` with
  ``--vtk``, ``--metrics``, ``--ckpt-dir`` and ``--balance`` writes every
  output, and its per-step (Δt, Newton, FGMRES) equal the reference
  ``Simulator``'s on that preset; ``--resume`` from a mid-run checkpoint
  ends on the uninterrupted run's final state bit for bit.
- Each flag builds the configuration the reference's ``main`` builds (its
  ``Simulator`` replaced by a recorder; compared through
  ``interop.config_from_dict``).
- ``--device cuda`` without CUDA exits nonzero; the module entry point runs.
- ``tp_thermal_2d``, ``tp_spe10_3d`` and ``sp_spe10_layer_2d`` through
  both packages' ``Simulator`` for 2 controller steps at the smallest size
  each preset takes (``sp_spe10_layer_2d`` has one size): identical Δt and
  counts, states within 1e-8.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests._torch_parity import F64, assert_states_close
from thermalporous_torch import presets as tpre
from thermalporous_torch import run_case
from thermalporous_torch.interop import config_from_dict
from thermalporous_torch.precond import CPRConfig
from thermalporous_torch.solve import NewtonConfig, TimeConfig
from thermalporous_tpu import presets as jpre
from thermalporous_tpu.solve import Simulator as JSimulator

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
CASE = "sp_hot_injection_2d"
T_END_DAYS = 0.2


def _reference_main():
    spec = importlib.util.spec_from_file_location("reference_run_case",
                                                  REPO / "examples" / "run_case.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def test_list_names_the_reference_cases(capsys):
    assert run_case.main(["--list"]) == 0
    names = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert names == sorted(jpre.CASE_DESCRIPTIONS)
    assert tpre.CASE_DESCRIPTIONS == jpre.CASE_DESCRIPTIONS


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The CLI with every output on, then resumed from its step-2
    checkpoint, and the reference Simulator on the same preset."""
    out = tmp_path_factory.mktemp("cli")
    common = ["--case", CASE, "--t-end-days", str(T_END_DAYS), "--device", "cpu"]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        run_case.main(common + ["--vtk", str(out / "vtk"), "--vtk-every", "2",
                                "--metrics", str(out / "m.jsonl"), "--ckpt-dir",
                                str(out / "ck"), "--ckpt-every", "1", "--balance"])
    (out / "stdout.txt").write_text(printed.getvalue())
    common.append("--quiet")
    ckpts = sorted((out / "ck").glob("ckpt_*.npz"))
    resume_from = [p for p in ckpts if p.name == "ckpt_0000002.npz"]
    run_case.main(common + ["--resume", str(resume_from[0]), "--ckpt-dir", str(out / "ck2"),
                            "--ckpt-every", "1", "--metrics", str(out / "m2.jsonl")])
    case = jpre.get_case(CASE)
    jres = JSimulator(case.model, case.data, precond=case.precond, pc_cfg=case.pc_cfg,
                      newton_cfg=case.newton_cfg,
                      time_cfg=case.time_cfg).run(T_END_DAYS * 86400.0)
    return out, jres


def test_cli_writes_every_output_and_matches_the_reference(cli_run, capsys):
    out, jres = cli_run
    recs = [json.loads(line) for line in open(out / "m.jsonl")]
    assert ([(r["dt"], r["newton_iters"], r["ksp_iters"]) for r in recs]
            == [(r.dt, r.newton_iters, r.ksp_iters) for r in jres.records])
    assert all(r["case"] == CASE and r["cell_updates_per_s"] > 0 for r in recs)
    assert all(r["residual_norm"] < r["residual_norm0"] for r in recs)
    n_steps = len(recs)
    assert sorted(os.listdir(out / "vtk")) == (
        [f"{CASE}.pvd"] + [f"{CASE}_{i:05d}.vti" for i in range(1 + n_steps // 2)])
    # the default retention keeps the last three
    assert sorted(os.listdir(out / "ck")) == [f"ckpt_{s:07d}.npz"
                                              for s in range(n_steps - 2, n_steps + 1)]


def test_cli_prints_the_reference_lines(cli_run):
    out, jres = cli_run
    text = (out / "stdout.txt").read_text()
    n_steps = len(jres.records)
    for head in ("# sp_hot_injection_2d:", "# grid (40, 40) = 1600 cells", "step    1  t=",
                 f"# done: t={jres.t:.4e}s in {n_steps} steps", "# newton total",
                 "# throughput", f"# material/energy balance audit ({n_steps} steps)",
                 "#   mass_kg", "#   energy_J", "# final well rates", "#   INJ", "#   PROD"):
        assert head in text, head


def test_cli_resume_is_bitwise(cli_run):
    out, _ = cli_run
    full = np.load(sorted((out / "ck").glob("ckpt_*.npz"))[-1])
    resumed = np.load(sorted((out / "ck2").glob("ckpt_*.npz"))[-1])
    for key in ("u", "t", "dt", "step"):
        assert np.array_equal(full[key], resumed[key]), key
    full_recs = [json.loads(line) for line in open(out / "m.jsonl")]
    again = [json.loads(line) for line in open(out / "m2.jsonl")]
    key = lambda r: (r["step"], r["t"], r["dt"], r["newton_iters"], r["ksp_iters"])
    assert [key(r) for r in again] == [key(r) for r in full_recs[2:]]


FLAG_SETS = [
    ["--case", "tp_thermal_2d"],
    ["--case", "tp_thermal_2d", "--precond", "cpr", "--decoupling", "timpes"],
    ["--case", "tp_thermal_2d", "--cycle", "w", "--fuse-below", "0"],
    ["--case", "tp_thermal_2d", "--ds-max", "0.1", "--ls-mode", "nonmonotone"],
    ["--case", "tp_thermal_2d", "--ds-max", "0", "--predictor", "linear"],
    ["--case", "sp_hot_injection_2d", "--fuse-below", "500", "--cycle", "k"],
    ["--case", "sp_hot_injection_2d", "--block-steps", "3", "--precond", "rbgs",
     "--decoupling", "abf"],
    ["--case", "sp_hot_injection_2d", "--f32", "--ls-mode", "armijo", "--predictor", "none"],
]


class _Built(Exception):
    pass


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: " ".join(f[1:]))
def test_flags_build_the_reference_configuration(flags, monkeypatch):
    import thermalporous_tpu.solve as jsolve

    seen = {}

    def recorder(model, data, **kw):
        seen.update(kw)
        raise _Built

    monkeypatch.setattr(jsolve, "Simulator", recorder)
    monkeypatch.setattr(sys, "argv", ["run_case.py", *flags])
    with pytest.raises(_Built):
        _reference_main()()
    case, kw = run_case.build(run_case.parser().parse_args(flags + ["--device", "cpu"]))
    assert kw["precond"] == seen["precond"]
    assert kw["pc_cfg"] == config_from_dict(
        CPRConfig, None if seen["pc_cfg"] is None else dataclasses.asdict(seen["pc_cfg"]))
    assert kw["newton_cfg"] == config_from_dict(NewtonConfig,
                                                dataclasses.asdict(seen["newton_cfg"]))
    assert kw["time_cfg"] == config_from_dict(TimeConfig, dataclasses.asdict(seen["time_cfg"]))
    assert not seen["fuse"]
    assert case.data.fields.dtype == (torch.float32 if "--f32" in flags else F64)
    assert case.data.fields.device.type == "cpu"


def test_device_cuda_without_cuda_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA device")
    with pytest.raises(SystemExit) as exc:
        run_case.main(["--case", CASE, "--t-end-days", "0.01"])
    assert exc.value.code not in (0, None)
    assert "--device cpu" in str(exc.value.code)


def test_module_entry_point_lists_cases():
    out = subprocess.run([sys.executable, "-m", "thermalporous_torch.run_case", "--list"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert [line.split()[0] for line in out.stdout.splitlines()] == sorted(
        jpre.CASE_DESCRIPTIONS)
    # the reference's flags left out are named in the help
    helped = run_case.parser().format_help()
    for flag in ("--fuse", "--pallas-gmg", "--qualify", "--platform", "--device"):
        assert flag in helped


PRESET_RUNS = {
    "tp_thermal_2d": dict(n=8),
    "tp_spe10_3d": dict(nx=6, ny=8, nz=3),
    "sp_spe10_layer_2d": {},
}


@pytest.mark.parametrize("name", list(PRESET_RUNS))
def test_preset_simulator_matches_the_reference(name):
    kw = PRESET_RUNS[name]
    jcase = jpre.get_case(name, **kw)
    jres = JSimulator(jcase.model, jcase.data, precond=jcase.precond, pc_cfg=jcase.pc_cfg,
                      newton_cfg=jcase.newton_cfg,
                      time_cfg=jcase.time_cfg).run(jcase.t_end, max_steps=2)
    case = tpre.get_case(name, device="cpu", dtype=F64, **kw)
    res = case.simulator().run(case.t_end, max_steps=2)
    rec = lambda r: (r.step, r.t, r.dt, r.newton_iters, r.ksp_iters, r.retries, r.next_dt)
    assert [rec(r) for r in res.records] == [rec(r) for r in jres.records]
    assert len(res.records) == 2
    assert_states_close(res.u, np.asarray(jres.u), 1e-8)
