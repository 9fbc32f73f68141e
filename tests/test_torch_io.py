"""Port parity of the I/O package (CPU): VTK ImageData series byte for
byte against the reference's writer (2D and 3D, f32 and f64, the native
and the pure-Python path), the native float parser against numpy,
checkpoints across the two packages in both directions (with the
controller's ``dt_cap``), the checkpoint manager's retention and cadence,
and the metrics lines against the reference's."""

import json
import os

import numpy as np
import pytest
import torch

from thermalporous_torch.core import Grid
from thermalporous_torch.data import spe10 as tspe10
from thermalporous_torch.io import (
    CheckpointManager,
    MetricsLogger,
    PVDWriter,
    load_checkpoint,
    save_checkpoint,
    state_fields,
    write_vti,
)
from thermalporous_torch.io import native
from thermalporous_torch.solve import StepRecord
from thermalporous_tpu import io as jio
from thermalporous_tpu.core import Grid as JGrid
from thermalporous_tpu.io import native as jnative
from thermalporous_tpu.solve import StepRecord as JStepRecord

GRIDS = {
    "2d": dict(shape=(7, 9), spacing=(1.0, 2.5), thickness=0.5),
    "3d": dict(shape=(3, 4, 5), spacing=(1.0, 1.0, 2.0)),
}


def _python_path(mp, mod):
    """Make ``mod`` (a native binding) report its library unavailable."""
    mp.setattr(mod, "_lib", None)
    mp.setattr(mod, "_load_attempted", True)


@pytest.fixture
def reference_python(monkeypatch):
    # the reference writes the same bytes on either of its paths; its
    # pure-Python one needs no build in its source tree
    _python_path(monkeypatch, jnative)


@pytest.mark.parametrize("path", ["native", "python"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_write_vti_bytes_equal_the_reference(tmp_path, monkeypatch, reference_python, dim,
                                             dtype, path):
    spec = GRIDS[dim]
    rng = np.random.default_rng(1)
    fields = {"pressure": rng.standard_normal(spec["shape"]).astype(dtype),
              "temperature": rng.standard_normal(spec["shape"]).astype(dtype),
              "a<b&c": rng.integers(0, 9, spec["shape"]).astype(np.int32)}
    if path == "native":
        assert native.available()
    else:
        _python_path(monkeypatch, native)
    ref, got = tmp_path / "ref.vti", tmp_path / "got.vti"
    jio.write_vti(str(ref), JGrid(**spec), fields)
    write_vti(str(got), Grid(**spec), {k: torch.as_tensor(v) for k, v in fields.items()})
    assert got.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("path", ["native", "python"])
def test_pvd_series_bytes_equal_the_reference(tmp_path, monkeypatch, reference_python, path):
    if path == "python":
        _python_path(monkeypatch, native)
    spec = GRIDS["3d"]
    rng = np.random.default_rng(2)
    states = [rng.standard_normal((3,) + spec["shape"]) for _ in range(3)]
    jw = jio.PVDWriter(str(tmp_path / "ref"), "case", JGrid(**spec))
    tw = PVDWriter(str(tmp_path / "got"), "case", Grid(**spec))
    for i, u in enumerate(states):
        jw.write(10.0 * i + 0.25, jio.state_fields(None, u))
        tw.write(10.0 * i + 0.25, state_fields(None, torch.as_tensor(u)))
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "got")) and len(names) == 4
    for name in names:
        assert (tmp_path / "got" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()


def test_write_vti_refuses_a_wrong_shape(tmp_path):
    with pytest.raises(ValueError, match="shape"):
        write_vti(str(tmp_path / "x.vti"), Grid(**GRIDS["2d"]), {"p": np.zeros((7, 8))})


def test_parse_floats_matches_numpy(tmp_path, monkeypatch):
    vals = np.random.default_rng(0).uniform(1e-6, 1e6, 5000)
    path = tmp_path / "vals.dat"
    path.write_text("\n".join(" ".join(f"{v:.8e}" for v in vals[i: i + 7])
                              for i in range(0, vals.size, 7)))
    ref = np.fromfile(str(path), sep=" ")
    np.testing.assert_array_equal(native.parse_floats(str(path), vals.size + 10), ref)
    np.testing.assert_array_equal(native.parse_floats(str(path), 100), ref[:100])
    # the SPE10 reader through the native parser, and through numpy without it
    np.testing.assert_array_equal(tspe10._read_floats(str(path), vals.size + 1), ref)
    _python_path(monkeypatch, native)
    assert native.parse_floats(str(path), 10) is None
    np.testing.assert_array_equal(tspe10._read_floats(str(path), vals.size + 1), ref)


def test_parse_floats_missing_file(tmp_path):
    with pytest.raises(IOError):
        native.parse_floats(str(tmp_path / "missing.dat"), 10)


def test_native_library_builds_outside_the_sources():
    path = native.lib_path()
    assert native.available() and path.exists()
    assert path.parent.parent.name == "_build"
    src_dir = os.path.dirname(native._SRC)
    assert sorted(os.listdir(src_dir)) == ["tp_io.cc"]


@pytest.mark.parametrize("direction", ["port", "port_to_reference", "reference_to_port"])
def test_checkpoint_round_trip(tmp_path, direction):
    u = np.random.default_rng(0).standard_normal((3, 5, 4))
    path = str(tmp_path / "c.npz")
    meta = {"case": "x", "dt_cap": 1234.5678901234567}
    if direction == "reference_to_port":
        jio.save_checkpoint(path, u, t=123.5, dt=7.25, step=42, meta=meta)
    else:
        save_checkpoint(path, torch.as_tensor(u), t=123.5, dt=7.25, step=42, meta=meta)
    if direction == "port_to_reference":
        u2, t, dt, step, meta2 = jio.load_checkpoint(path)
    else:
        u2, t, dt, step, meta2 = load_checkpoint(path, device="cpu")
        assert isinstance(u2, torch.Tensor) and u2.dtype == torch.float64
    np.testing.assert_array_equal(np.asarray(u2), u)
    assert (t, dt, step, meta2) == (123.5, 7.25, 42, meta)


def test_load_checkpoint_dtype_and_device(tmp_path):
    u = torch.arange(12, dtype=torch.float64).reshape(2, 3, 2)
    path = save_checkpoint(str(tmp_path / "c.npz"), u, 1.0, 2.0, 3)
    u32 = load_checkpoint(path, device="cpu", dtype=torch.float32)[0]
    assert u32.dtype == torch.float32 and torch.equal(u32, u.float())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            load_checkpoint(path)


def _rec(cls, step, **kw):
    return cls(step=step, t=step * 1.0, dt=1.0, newton_iters=1, ksp_iters=1, retries=0,
               residual_norm0=1.0, residual_norm=0.0, wall_s=0.1, **kw)


def test_checkpoint_manager_retention_and_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=2, keep=2)
    u = torch.zeros((2, 3, 3))
    for step in range(1, 9):
        mgr(step, step * 1.0, u, _rec(StepRecord, step, next_dt=1.5,
                                      dt_cap=7.0 if step == 8 else None))
    assert sorted(os.listdir(tmp_path)) == ["ckpt_0000006.npz", "ckpt_0000008.npz"]
    _, t, dt, step, meta = load_checkpoint(mgr.latest(), device="cpu")
    assert (t, dt, step, meta) == (8.0, 1.5, 8, {"dt_cap": 7.0})
    # a new manager on the same directory finds the files and keeps pruning
    again = CheckpointManager(str(tmp_path), every=2, keep=2)
    assert again.latest() == mgr.latest()
    for step in (9, 10):
        again(step, step * 1.0, u, _rec(StepRecord, step))
    assert sorted(os.listdir(tmp_path)) == ["ckpt_0000008.npz", "ckpt_0000010.npz"]


def test_checkpoint_cadence_survives_block_final_step_drift(tmp_path):
    """Only block-final records are consistent, and retries shift their step
    numbers off any modulus (finals at 3, 7, 11 with every=4): the manager
    still writes, as the reference's does."""
    written = {}
    for pkg, cls, mgr_cls, u in (("port", StepRecord, CheckpointManager, torch.zeros(2, 3)),
                                 ("ref", JStepRecord, jio.CheckpointManager, np.zeros((2, 3)))):
        mgr = mgr_cls(str(tmp_path / pkg), every=4, keep=100)
        for step in range(1, 13):
            mgr(step, step * 1.0, u,
                _rec(cls, step, state_consistent=step in (3, 7, 11)))
        written[pkg] = sorted(os.listdir(tmp_path / pkg))
    assert written["port"] == written["ref"] == ["ckpt_0000007.npz", "ckpt_0000011.npz"]


def test_metrics_lines_equal_the_reference(tmp_path):
    kw = [dict(step=1, t=10.0, dt=10.0, newton_iters=4, ksp_iters=20, retries=0,
               residual_norm0=1.0, residual_norm=1e-8, wall_s=0.5, next_dt=15.0),
          dict(step=2, t=25.0, dt=15.0, newton_iters=3, ksp_iters=9, retries=2,
               residual_norm0=2.0, residual_norm=3e-9, wall_s=0.25, next_dt=15.0,
               dt_cap=18.0, state_consistent=False, src_dt=(1.5, -2.25, 3.0)),
          dict(step=3, t=40.0, dt=15.0, newton_iters=2, ksp_iters=4, retries=0,
               residual_norm0=1.0, residual_norm=1e-9, wall_s=0.0)]
    lines = {}
    for pkg, cls, logger in (("port", StepRecord, MetricsLogger),
                             ("ref", JStepRecord, jio.MetricsLogger)):
        path = str(tmp_path / f"{pkg}.jsonl")
        with logger(path, ncells=100, extra={"case": "t"}) as log:
            for k in kw:
                log(k["step"], k["t"], None, cls(**k))
        lines[pkg] = [json.loads(line) for line in open(path)]
    for got, ref in zip(lines["port"], lines["ref"], strict=True):
        assert got.pop("wallclock") >= 0.0 and "wallclock" in ref
        ref.pop("wallclock")
        assert got == ref
    assert lines["port"][0]["cell_updates_per_s"] == 100 * 4 / 0.5
    assert "cell_updates_per_s" not in lines["port"][2]
