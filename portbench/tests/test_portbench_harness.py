"""The harness on the CPU, through its own rehearsal option: every cell runs
end to end at its rehearsal size; a traffic file copied under a new name
runs with no code edit; the last line carries the contract's keys; the
frozen roofline reckoning reproduces the kernel table's bounds; no module
of JAX or of the JAX package is loaded by a run, and a run that finds one
prints no result; a run without a card, or whose window's profile holds
no device operation, prints none either; each fault the cells can have,
planted in the program's step, turns ``correct`` false.
The ``card`` tests run the control at the cells' own size on the card."""

import contextlib
import io
import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import roofline
from portbench.run import ROOT, load_cell, main
from portbench.trace import Stamps

CELLS = ("spe10_tp.ramp", "geothermal_sp.ramp")
KEYS = {"correct", "attempted", "failed", "metrics", "device"}
FORBIDDEN = {"jax", "jaxlib", "flax", "thermalporous_tpu"}


def run_main(argv) -> tuple[int, list[str]]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().splitlines()


def result_of(lines) -> dict:
    return json.loads(lines[-1])


def rehearse(cell, seed=7, seconds="0.1", trace="0", root=ROOT):
    return run_main(["--workload", cell, "--seed", str(seed), "--seconds", seconds,
                     "--trace", trace, "--rehearse", "--root", str(root)])


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_of_each_cell_loads_no_jax(cell):
    code = ("import json, sys\n"
            "from portbench.run import main\n"
            f"rc = main(['--workload', '{cell}', '--seed', '2147483999', '--seconds', '0.1', "
            "'--rehearse'])\n"
            "print(json.dumps({'rc': rc, 'modules': sorted({m.split('.')[0] "
            "for m in sys.modules})}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    tail = json.loads(lines[-1])
    assert tail["rc"] == 0
    assert not FORBIDDEN & set(tail["modules"])
    result = json.loads(lines[-2])
    assert result["correct"] is True, result
    assert result["attempted"] > 0 and result["failed"] == 0
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(result["metrics"]) == {m["name"] for m in bench["end_to_end"]}


def test_last_line_keys_traced():
    rc, lines = rehearse("geothermal_sp.ramp", trace="1")
    assert rc == 0
    result = result_of(lines)
    assert KEYS <= set(result) and list(result)[-1] == "limits"
    assert {"busy_s", "window_s", "platform", "kind", "count",
            "memory_peak_bytes"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    per_layer = {m["name"] for m in load_cell(ROOT, "geothermal_sp.ramp")["per_layer"]}
    # on the CPU no device operation is profiled: the device's two readers
    # find nothing and are left out
    assert set(result["metrics"]) == per_layer - {"kernels_roofline", "device.idle_pct"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0


def test_a_layer_the_trace_misses_refuses_the_result(monkeypatch):
    """A traced run whose spans see no call into the layers (as when the
    program stops calling them through the instrumented module attributes)
    prints no result instead of leaving the metrics out."""
    from portbench import trace

    monkeypatch.setattr(trace.Spans, "active", lambda self: contextlib.nullcontext(self))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, lines = rehearse("geothermal_sp.ramp", trace="1")
    assert rc != 0
    assert not any(line.startswith("{") for line in lines)
    assert "assembly.ms_per_newton" in err.getvalue()


def test_a_window_with_no_device_operation_prints_no_result(monkeypatch):
    """``device_sim_rate`` divides by the window's busy seconds: a profile
    that holds no device operation gives no result rather than a rate."""
    from portbench import trace

    monkeypatch.setattr(trace.Profile, "busy_seconds", lambda self: 0.0)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, lines = rehearse("geothermal_sp.ramp")
    assert rc != 0
    assert not any(line.startswith("{") for line in lines)
    assert "no device operation" in err.getvalue()


def test_device_rate_is_the_windows_simulated_over_busy_seconds():
    rc, lines = rehearse("geothermal_sp.ramp", seconds="0.3")
    assert rc == 0
    window = next(line for line in lines if line.startswith("# window:"))
    sim_s = float(window.split(" steps, ")[1].split(" simulated s")[0])
    busy = float(window.split("device busy ")[1].split(" s over")[0])
    assert busy > 0.0
    assert result_of(lines)["metrics"]["device_sim_rate"]["value"] == sim_s / busy


def test_launches_outside_the_stamped_calls_are_named():
    stamps = Stamps()
    stamps.seen = {"matvec": 5, "fused_residual": 3}
    before = {"matvec": 10, "block_matvec": 2, "fused_residual": 1, "fused_residual_sp": 0}
    after = {"matvec": 15, "block_matvec": 4, "fused_residual": 1, "fused_residual_sp": 3}
    assert stamps.unseen(before, after) == {"block_matvec": 2}


def test_a_new_traffic_file_runs_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    traffic = json.loads((ROOT / "portbench/traffic/ramp_k5.json").read_text())
    traffic["episode"]["steps"] = 2
    (tmp_path / "portbench/traffic/ramp_k2_copy.json").write_text(json.dumps(traffic))
    shutil.copy(ROOT / "portbench/limits/geothermal_sp.ramp.json",
                tmp_path / "portbench/limits/geothermal_sp.copy.json")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "geothermal_sp.copy", "config": "geothermal_sp",
                               "traffic": "ramp_k2_copy", "chips": 1, "why": "a copy"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, lines = rehearse("geothermal_sp.copy", root=tmp_path)
    assert rc == 0
    result = result_of(lines)
    assert result["correct"] is True
    assert result["attempted"] % 2 == 0    # whole episodes of the copy's two steps


def test_forbidden_module_refuses_the_result():
    code = ("import sys, types\n"
            "sys.modules['jax'] = types.ModuleType('jax')\n"
            "from portbench.run import main\n"
            "sys.exit(main(['--workload', 'geothermal_sp.ramp', '--seed', '1', "
            "'--seconds', '0.1', '--rehearse']))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode != 0
    assert "jax" in proc.stderr
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc, lines = run_main(["--workload", "geothermal_sp.ramp", "--seed", "1",
                          "--seconds", "1"])
    assert rc != 0 and not lines


def broken_step(kind):
    from thermalporous_torch.solve.timeloop import Simulator

    real = Simulator.step

    def step(self, u_old, dt, u_guess=None):
        u, stats = real(self, u_old, dt, u_guess)
        if kind == "unchanged":            # a step that returns its state unchanged
            return u_old, stats
        u = u.clone()
        if kind == "half":                 # half of the cells left at the old state
            n = u.shape[1] // 2
            u[:, :n] = u_old[:, :n]
        elif kind == "altered":            # one answer altered where it is produced
            u[1, 1, 1, 1] += 25.0
        return u, stats

    return step


@pytest.mark.parametrize("kind", ("unchanged", "half", "altered"))
@pytest.mark.parametrize("cell", ("spe10_tp.ramp", "geothermal_sp.ramp"))
def test_a_broken_step_is_not_correct(monkeypatch, cell, kind):
    from thermalporous_torch.solve.timeloop import Simulator

    monkeypatch.setattr(Simulator, "step", broken_step(kind))
    rc, lines = rehearse(cell)
    assert rc == 0
    assert result_of(lines)["correct"] is False


# the kernel table's bound column (PERF.md, f32 rows) at its shapes
FLAG = 60 * 220 * 85
P_LEVELS = [(60, 110, 22), (60, 55, 11), (30, 28, 6), (15, 14, 3)]


@pytest.mark.parametrize("cost, bound", [
    (roofline.cost_block_matvec(FLAG, 3, 3, 3, 4), 0.0924),                  # B1
    (roofline.cost_block_matvec(FLAG, 3, 2, 2, 4), 0.0429),                  # B1 inner
    (roofline.cost_block_matvec(FLAG, 3, 3, 2, 4, 2), 0.0348),               # B1 bf16
    (roofline.cost_matvec(FLAG, 3, 4), 0.0121),                              # B2
    (roofline.cost_matvec(FLAG, 3, 4, 2), 0.0074),                           # B2 bf16
    (roofline.cost_chebyshev(FLAG, 3, 4, True, 4), 0.0134),                  # B3
    (roofline.cost_chebyshev(FLAG, 3, 4, True, 4, 2), 0.0087),               # B3 bf16
    (roofline.cost_residual_counts(3, (60, 220, 85), 425, 85, 0, 4), 0.0295),  # B4
    (roofline.cost_residual_counts(2, (64, 64, 32), 32, 16, 0, 4), 0.0030),    # B4 sp
    (roofline.cost_stage2(FLAG, 3, 3, 2, 4), 0.0911),                         # B5
    (roofline.cost_stage2(FLAG, 3, 3, 3, 4), 0.1085),                         # B5 k=3
    (roofline.cost_stage2(FLAG, 3, 3, 2, 4, 2), 0.0509),                      # B5 bf16
    (roofline.cost_half(FLAG, 3, 3, 4), 0.0583),                              # half-sweep
    (roofline.cost_deep(P_LEVELS, 4, "k", 8192, 4), 0.0024),                  # B6
    (roofline.cost_jvp_counts(3, (60, 220, 85), 425, 85, 0, 4), 0.0295),      # B7
    (roofline.cost_jvp_counts(2, (64, 64, 32), 32, 16, 0, 4), 0.0030),        # B7 sp
])
def test_roofline_reproduces_the_kernel_table(cost, bound):
    assert round(roofline.bound_ms(*cost)[0], 4) == bound


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(card, cell):
    """On the card, at the cell's own size, on the configuration's own field
    and on two others (a run's seed changes nothing, so other fields are
    what shows the reference more than one input): the program's states
    pass every limit and the same states in bfloat16 fail one."""
    from portbench import check
    from portbench.calibrate import readings_for_field

    spec = load_cell(ROOT, cell)
    for base_seed in (None, 5101, 3000005103):
        row = readings_for_field(spec, base_seed, 1, card, rehearse=False)
        assert check.verdict(row["program"], spec["limits"])[0], row
        assert not check.verdict(row["control"], spec["limits"])[0], row
