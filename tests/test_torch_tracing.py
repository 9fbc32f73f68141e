"""The port's recorder (``thermalporous_torch/tracing.py``) on the CPU.

One small case, the flagship configuration on an 8×14×6 synthetic SPE10
grid in f64 (hierarchies cut to it as in ``test_torch_simulator.py``), runs
two controller steps from the same state: once with the recorder off, once
on under a CPU ``torch.profiler`` profile, and once on in blocks of two
steps.  The recorder must not change a bit of the result, every read of a
tensor must go through ``host_read``, the spans must nest as the module's
docstring lists them, and the spans and the profiler's events must share
one clock.
"""

import bisect
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from thermalporous_torch import presets, tracing
from thermalporous_torch.solve.newton import NewtonStats

torch.set_num_threads(1)

SHAPE = (8, 14, 6)
STEPS = 2
SMALL_GMG = dict(max_coarse_cells=8, fuse_below=100)

# the parents each span may have (None: opened outside every span)
PARENTS = {
    "setup.simulator": {None},
    "setup.coarsening_bake": {"setup.simulator"},
    "episode": {None},
    "step": {"episode"},
    "attempt": {"step"},
    "newton.iter": {"attempt"},
    "residual": {"newton.iter", "attempt"},
    "assembly": {"newton.iter", "setup.coarsening_bake"},
    "pc_setup": {"newton.iter"},
    "gmg_setup": {"pc_setup"},
    "fgmres": {"newton.iter"},
    "pc_apply": {"fgmres"},
}


def _simulator(block_steps=1, count_solves=False):
    case = presets.tp_spe10_full(shape=SHAPE, device="cpu", dtype=torch.float64)
    pc = case.pc_cfg
    pc = dataclasses.replace(
        pc, gmg=dataclasses.replace(pc.gmg, kcycle_min_cells=64, **SMALL_GMG),
        gmg_t=dataclasses.replace(pc.gmg_t, **SMALL_GMG))
    time_cfg = dataclasses.replace(case.time_cfg, block_steps=block_steps)
    with tracing.recording() as setup:
        sim = case.simulator(pc_cfg=pc, time_cfg=time_cfg)
    # every Newton solve's statistics, failed attempts included
    solves, advance = [], sim._advance

    def counted(*args):
        u, stats = advance(*args)
        solves.append(stats)
        return u, stats

    if count_solves:
        sim._advance = counted
    return case, sim, setup, solves


@pytest.fixture(scope="module")
def runs():
    case, sim, setup, solves = _simulator(count_solves=True)
    off = sim.run(case.t_end, max_steps=STEPS)
    n_off = len(solves)
    with tracing.recording() as rec, profile(activities=[ProfilerActivity.CPU]) as prof:
        on = sim.run(case.t_end, max_steps=STEPS)
    bcase, bsim, _, _ = _simulator(block_steps=2)
    with tracing.recording() as brec:
        blocked = bsim.run(bcase.t_end, max_steps=STEPS)
    return dict(off=off, on=on, rec=rec, ops=_operators(prof), setup=setup,
                solves=solves[n_off:],
                blocked=dict(rec=brec, records=blocked.records))


def test_off_records_nothing():
    assert tracing.span("assembly") is tracing.OFF
    assert tracing.span("episode").set("k", 1) is tracing.OFF
    assert not tracing.OFF
    x = torch.tensor(2.5, dtype=torch.float64)
    assert tracing.host_read(x) == 2.5
    assert torch.equal(tracing.host_read(torch.arange(3.0)), torch.arange(3.0))
    tracing.count("host.reads")
    with tracing.span("episode"):
        pass
    with tracing.recording() as rec:
        with tracing.recording() as inner:       # nested: the same record
            assert inner is rec
        assert tracing.span("episode") is not tracing.OFF
    assert tracing.span("episode") is tracing.OFF
    assert rec.spans == [] and rec.counters == {}


def test_recording_changes_no_bit(runs):
    off, on = runs["off"], runs["on"]
    assert torch.equal(off.u, on.u)
    key = lambda r: (r.dt, r.newton_iters, r.ksp_iters, r.retries, r.residual_norm0,
                     r.residual_norm, r.next_dt, r.dt_cap)
    assert [key(r) for r in off.records] == [key(r) for r in on.records]
    assert len(on.records) == STEPS


def _operators(prof):
    """(start_ns, end_ns, name, names of the operators around it) of every
    operator of the profile, on the events' own clock, in the order they
    started."""
    events = sorted(((e.start_ns(), -e.duration_ns(), e.name())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CPU))
    out, around = [], []
    for start, neg, name in events:
        end = start - neg
        while around and around[-1][1] < end:
            around.pop()
        out.append((start, end, name, [a[2] for a in around]))
        around.append((start, end, name))
    return out


def test_every_tensor_read_goes_through_host_read(runs):
    """On the CPU every tensor counts: each ``.item()`` of the run is one
    ``aten::_local_scalar_dense`` called from Python (those a library
    operator calls inside itself, as the CPU's ``linalg_inv_ex`` does,
    are its own); a tensor read whole (``.cpu()``) calls no operator on
    the CPU and is told apart by its ``values`` attribute."""
    rec = runs["rec"]
    scalar_reads = sum(around in ([], ["aten::item"])
                       for _, _, name, around in runs["ops"]
                       if name == "aten::_local_scalar_dense")
    waits = [s for s in rec.spans if s.name == "wait"]
    whole = [s for s in waits if "values" in s.attrs]
    assert rec.counters["host.reads"] == len(waits)
    assert scalar_reads == len(waits) - len(whole) > 0
    assert whole        # FGMRES's Hessenberg columns


@pytest.mark.parametrize("run", ["plain", "blocked"])
def test_spans_nest_as_listed(runs, run):
    rec = runs["rec"] if run == "plain" else runs["blocked"]["rec"]
    by_id = {s.id: s for s in rec.spans}
    episodes = [s for s in rec.spans if s.name == "episode"]
    assert len(episodes) == 1
    names = set()
    for s in rec.spans:
        parent = by_id.get(s.parent)
        names.add(s.name)
        if s.name != "wait":
            assert (parent.name if parent else None) in PARENTS[s.name], s
        if parent is not None:
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns, s
        assert s.episode == episodes[0].id
    assert names == set(PARENTS) - {"setup.simulator", "setup.coarsening_bake"} | {"wait"}
    steps = [s for s in rec.spans if s.name == "step"]
    assert len(steps) == STEPS and all(s.attrs["retries"] == 0 for s in steps)
    attempts = [s for s in rec.spans if s.name == "attempt"]
    assert [s.attrs["failed"] for s in attempts] == [False] * STEPS
    whys = {s.attrs["why"] for s in rec.spans if s.name == "residual"}
    assert whys == {"start", "line_search"}
    fields = [s.attrs["field"] for s in rec.spans if s.name == "gmg_setup"]
    assert fields == ["p", "T"] * (len(fields) // 2) and fields


def test_setup_spans(runs):
    rec = runs["setup"]
    by_id = {s.id: s for s in rec.spans}
    names = [s.name for s in rec.spans if s.name != "wait"]
    assert names == ["setup.simulator", "setup.coarsening_bake", "assembly"]
    for s in rec.spans[1:]:
        assert by_id[s.parent].name in PARENTS.get(s.name, {"setup.coarsening_bake"})
        assert s.episode is None


@pytest.mark.parametrize("run", ["plain", "blocked"])
def test_newton_iterations_are_counted(runs, run):
    """Against every Newton solve's statistics (the blocked run's
    records: its block step calls the solver itself, and it retried no
    step)."""
    if run == "plain":
        rec, solves = runs["rec"], runs["solves"]
    else:
        rec, solves = runs["blocked"]["rec"], [
            NewtonStats(r.newton_iters, r.ksp_iters, 0.0, 0.0, True, False)
            for r in runs["blocked"]["records"]]
    iters = [s for s in rec.spans if s.name == "newton.iter"]
    assert len(iters) == sum(st.iters for st in solves) > 0
    fgmres = [s for s in rec.spans if s.name == "fgmres"]
    assert sum(s.attrs["iters"] for s in fgmres) == sum(st.ksp_iters for st in solves)


def test_spans_share_the_profilers_clock(runs):
    """Every operator called from Python inside a span, by its start, ends
    inside it; each scalar read's operator lies inside its ``wait``."""
    rec = runs["rec"]
    spans = rec.spans                  # in the order they opened
    starts = [s.start_ns for s in spans]
    ops = [(start, end, name) for start, end, name, around in runs["ops"] if not around]
    inside = 0
    for start, end, name in ops:
        # the latest-opened span still open at the operator's start
        for s in reversed(spans[:bisect.bisect_right(starts, start)]):
            if start <= s.end_ns:
                assert end <= s.end_ns, (name, s)
                inside += 1
                break
    assert inside > 0.9 * len(ops)
    waits = [s for s in spans if s.name == "wait" and "values" not in s.attrs]
    items = [(s, e) for s, e, name in ops if name == "aten::item"]
    assert len(items) == len(waits)
    for (start, end), w in zip(items, waits):
        assert w.start_ns <= start <= end <= w.end_ns
