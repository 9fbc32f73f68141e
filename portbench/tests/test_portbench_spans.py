"""The reader of the program's spans (``portbench/spans.py``) on the CPU,
through its rehearsal: each cell prints every figure not read from the
device, every linked operation falls inside an episode and the
``newton.iter`` spans match the records; a program that records no
``assembly`` span gets no result."""

import contextlib
import io
import json

import pytest

from portbench.spans import FIGURES, main

CELLS = ("spe10_tp.ramp", "geothermal_sp.ramp")


def rehearse(cell):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--workload", cell, "--seed", "2147483999", "--seconds", "0.1",
                   "--rehearse"])
    return rc, out.getvalue().splitlines()


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_prints_the_figures_not_read_from_the_device(cell):
    rc, lines = rehearse(cell)
    assert rc == 0
    result = json.loads(lines[-1])
    assert set(result["figures"]) == {k for k, (_, device) in FIGURES.items() if not device}
    for name, fig in result["figures"].items():
        assert fig["unit"] == FIGURES[name][0] and fig["value"] > 0
    checks = result["checks"]
    assert checks["linked_in_episode_pct"] == 100.0
    assert checks["newton_iter_spans"] == checks["records_newton_iters"] > 0
    assert 0 < result["off_cost"]["pct_of_newton"] < 0.1


def test_no_assembly_span_no_result(monkeypatch):
    from thermalporous_torch import tracing
    from thermalporous_torch.models import base

    monkeypatch.setattr(base, "span", lambda name: tracing.OFF if name == "assembly"
                        else tracing.span(name))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, lines = rehearse("geothermal_sp.ramp")
    assert rc == 5
    assert not any(line.startswith("{") for line in lines)
    assert "no assembly" in err.getvalue()
