"""Run one cell of the benchmark and print its result as the last line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  In order: build the cell's configuration on
the card (its fields drawn from the configuration's own ``base_seed``, so
every run of a cell does the same work); run the cell's set-up (its traffic
file's first steps, then one episode as a warm-up, and one short profile
so that the profiler's start-up falls there too), counted in ``setup_s``
from the process's start; measure a window of whole episodes — each one
``Simulator.run`` call of the traffic's K controller steps from the
set-up's state, started back to back while the clock is under
``--seconds``, the window closed by a synchronize after the last, with
Python's cyclic collector off and the main thread on one core — then judge
every accepted step against the plain reference (``check.py``) and print
one JSON object.

``--trace 0`` reports the cell's end-to-end metrics: ``device_sim_rate``,
the simulated seconds of every accepted step in the window over the
seconds in which the device ran an operation in it (the union of the
device's operations in a ``torch.profiler`` profile of the device's
activity alone, over the whole window), and ``setup_s``.  The window's
wall rate is printed on an earlier line.  ``--trace 1`` reports its
per-layer metrics instead, from three parts after the set-up: a plain
window as the end-to-end one runs it but without the profile (the host's
wall rate); a window of episodes with synchronized layer spans; then
episodes under a profile of the device's activity alone, with every
kernel wrapper call and layer call stamped on the host (busy and idle
time, the kernels' roofline share, the device operations that took most
time, what the host did while the device idled).  A traced run in which a
metric listed for the cell finds nothing to read, or in which a kernel
wrapper launched more kernels than the harness saw calls of it, prints no
result: the program no longer calls a layer the way the harness
instruments it.  A run whose window's profile holds no device operation
prints none either.

``--rehearse`` runs the cell on the CPU at its configuration's rehearsal
size (the harness's own rehearsal, for the CPU tests; there the profile's
CPU operators stand in for the device's); ``--root`` reads
``BENCHMARK.json`` and the cell's files from another directory laid out
like the checkout.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from portbench import check, trace  # noqa: E402
from portbench.trace import sync  # noqa: E402
from portbench.problem import build_program, load_json, make_inputs, resolved  # noqa: E402
from portbench.reference.residual import Reference  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "thermalporous_tpu")
# a traced run's profile of the device's activity alone covers whole
# episodes until it has lasted this long
PROFILE_SECONDS = 3.0


def log(msg: str) -> None:
    print(f"# {msg}", flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU at the configuration's rehearsal size")
    ap.add_argument("--root", type=pathlib.Path, default=ROOT,
                    help="directory holding BENCHMARK.json and portbench/'s data files")
    return ap.parse_args(argv)


def load_cell(root: pathlib.Path, workload: str) -> dict:
    """The workload's entry of ``BENCHMARK.json`` with its configuration,
    traffic mix and limits, each found by name."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"unknown workload {workload!r}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])

    def wanted(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return dict(entry=entry, config=load_json(root / conf["file"]),
                traffic=load_json(root / "portbench" / "traffic" / f"{entry['traffic']}.json"),
                limits=load_json(root / "portbench" / "limits" / f"{workload}.json"),
                end_to_end=wanted(bench["end_to_end"]), per_layer=wanted(bench["per_layer"]))


def reader(root: pathlib.Path, name: str):
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def run_episode(sim, start, steps: int, t_end: float) -> check.Episode:
    """One ``Simulator.run`` of ``steps`` controller steps from ``start``
    (u, t, Δt, cap), keeping every accepted state and record."""
    u0, t0, dt0, cap0 = start
    ep = check.Episode(u0=u0, t0=t0, dt0=dt0, cap0=cap0)

    def keep(step, t, u, rec):
        ep.states.append(u)
        ep.records.append(dict(dt=rec.dt, newton=rec.newton_iters, ksp=rec.ksp_iters,
                               retries=rec.retries, wall=rec.wall_s))

    try:
        sim.run(t_end, u0=u0, dt0=dt0, t0=t0, max_steps=steps, dt_cap0=cap0, callback=keep)
    except RuntimeError as err:       # the controller's retries exhausted
        ep.failed = 1
        log(f"episode failed: {err}")
    return ep


def window(sim, start, steps, t_end, seconds, device) -> tuple[list, float]:
    """Whole episodes back to back while the clock is under ``seconds``;
    returns (episodes, wall seconds to the end of the last).  Python's
    cyclic collector is off inside (its pauses fall at random into the
    window); reference counting frees the episodes' tensors."""
    sync(device)
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        t0 = time.perf_counter()
        episodes = []
        while not episodes or time.perf_counter() - t0 < seconds:
            episodes.append(run_episode(sim, start, steps, t_end))
        sync(device)
        wall = time.perf_counter() - t0
    finally:
        gc.enable()
        gc.unfreeze()
    return episodes, wall


def profiled(device):
    """A profile of the device's activity alone (of the CPU's operators in
    the CPU rehearsal)."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA if device.type == "cuda"
                               else ProfilerActivity.CPU])


def profiled_window(sim, start, steps, t_end, seconds, device) -> tuple[list, float, float, int]:
    """:func:`window` under a profile of the device's activity; returns
    (episodes, wall seconds, seconds in which at least one device
    operation ran, device operations)."""
    with profiled(device) as prof:
        episodes, wall = window(sim, start, steps, t_end, seconds, device)
    kind = torch.autograd.DeviceType.CUDA if device.type == "cuda" else torch.autograd.DeviceType.CPU
    pr = trace.Profile.of(prof, kind)
    return episodes, wall, pr.busy_seconds(), len(pr.ops)


def steady_host() -> str:
    """One intra-op thread, and the calling (main) thread alone bound to the
    highest-numbered core it may run on, so that the host's dispatch loop
    stays on one core; threads started earlier keep their cores."""
    torch.set_num_threads(1)
    core = max(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {core})
    return f"main thread on core {core}"


def setup(sim, traffic: dict, t_end: float) -> tuple:
    """The traffic's set-up: its ``steps`` controller steps from the initial
    state.  Returns the episodes' start (u, t, Δt, cap)."""
    u, t, dt, cap = None, 0.0, None, None
    for step in range(int(traffic["setup"]["steps"])):
        res = sim.run(t_end, u0=u, dt0=dt, t0=t, step0=step, max_steps=step + 1,
                      dt_cap0=cap)
        rec = res.records[-1]
        u, t, dt, cap = res.u, res.t, rec.next_dt, rec.dt_cap
        log(f"setup step {step + 1}: dt {rec.dt} s newton {rec.newton_iters} "
            f"fgmres {rec.ksp_iters} retries {rec.retries} wall {rec.wall_s:.4f} s; "
            f"t {t} s, next dt {dt} s, cap {cap}")
    return u, t, dt, cap


def card_record(device) -> dict:
    if device.type != "cuda":
        return {}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,temperature.gpu",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30)
        smi = out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        smi = f"unavailable ({err})"
    return {"nvidia_smi": smi}


def traced(sim, start, steps, t_end, seconds, device):
    """The traced run's three parts (see the module's docstring); returns
    (all episodes, the readers' trace, breakdown, busy_s, window_s)."""
    eps_h, wall_h = window(sim, start, steps, t_end, seconds, device)
    sim_h = sum(r["dt"] for ep in eps_h for r in ep.records)
    log(f"plain window: {len(eps_h)} episodes, {sim_h} simulated s in {wall_h} s")

    spans = trace.Spans(device)
    with spans.active():
        eps_c, wall_c = window(sim, start, steps, t_end, seconds, device)
    log(f"spans over {len(eps_c)} episodes in {wall_c:.4f} s: "
        + ", ".join(f"{k} {v:.4f} s/{spans.calls.get(k, 0)}" for k, v in spans.seconds.items()))

    from thermalporous_torch.kernels import launch_counts

    stamps = trace.Stamps()
    before = launch_counts()
    with stamps.active(), profiled(device) as prof:
        eps_a, window_s = window(sim, start, steps, t_end, PROFILE_SECONDS, device)
    unseen = stamps.unseen(before, launch_counts())
    t = time.perf_counter()
    pr = trace.Profile.of(prof)
    busy_s = pr.busy_seconds()
    kernel_s, credited = pr.wrapper_seconds(stamps.calls)
    least_s = sum(c[3] for c in stamps.calls)
    log(f"device profile: {len(eps_a)} episodes, {len(pr.ops)} device operations "
        f"({sum(a is not None for a in pr.launched)} linked to a launch, {credited} inside "
        f"{len(stamps.calls)} wrapper calls), busy {busy_s} s of {window_s} s; wrapper calls' "
        f"least {least_s} s, device {kernel_s} s; read in {time.perf_counter() - t:.3f} s")
    tr = {"unseen": unseen,
          "host": {"sim_s": sim_h, "wall_s": wall_h},
          "records": [r for ep in eps_c for r in ep.records],
          "spans": {k: {"seconds": v, "calls": spans.calls.get(k, 0)}
                    for k, v in spans.seconds.items()},
          "newton_all": spans.newton,
          "roofline": {"least_s": least_s, "device_s": kernel_s, "calls": len(stamps.calls)},
          "device": {"busy_s": busy_s, "window_s": window_s}}
    breakdown = {"device_ops": pr.top_ops(), "idle_gaps": pr.idle_by_layer(stamps.layers)}
    return eps_h + eps_c + eps_a, tr, breakdown, busy_s, window_s


def main(argv=None) -> int:
    args = parse(argv)
    cell = load_cell(args.root, args.workload)
    entry, config, traffic = cell["entry"], cell["config"], cell["traffic"]
    if args.rehearse:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    cfg = resolved(config, args.rehearse)
    marks = [("imports", time.perf_counter())]
    if device.type == "cuda":
        from thermalporous_torch.kernels import _lib

        torch.cuda.init()
        marks.append(("CUDA context", time.perf_counter()))
        _, build_s, _ = _lib.build()
        _lib.load()
        marks.append(("kernel library", time.perf_counter()))
        log(f"kernel library build {build_s:.3f} s (0 when already built)")

    inputs = make_inputs(cfg, device, args.root)
    sync(device)
    marks.append(("inputs", time.perf_counter()))
    prog = build_program(cfg, inputs, device)
    sync(device)
    marks.append(("program and Simulator", time.perf_counter()))
    sim = prog.simulator
    log(f"cell {args.workload}: grid {inputs.shape}, dtype {cfg['dtype']}, seed {args.seed}")
    for key, value in prog.settings.items():
        log(f"resolved {key}: {value}")
    start = setup(sim, traffic, prog.t_end)
    sync(device)
    marks.append(("set-up steps", time.perf_counter()))
    steps = int(traffic["episode"]["steps"])
    warm = run_episode(sim, start, steps, prog.t_end)
    sync(device)
    marks.append(("warm-up episode", time.perf_counter()))
    with profiled(device):      # the profiler's own start-up, once
        torch.ones(8, device=device).sum().item()
    setup_s = time.perf_counter() - _T0
    marks.append(("profiler start-up", time.perf_counter()))
    log("warm-up episode: " + " ".join(f"({r['dt']}, {r['newton']}, {r['ksp']}, "
                                        f"{r['retries']}, {r['wall']:.4f})" for r in warm.records))
    if device.type == "cuda":     # the CPU rehearsal runs inside test processes
        log(steady_host())
    log("set-up " + ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b)
                              in zip([("start", _T0)] + marks, marks)) + f"; {setup_s:.3f} s")

    from thermalporous_torch.kernels import launch_counts, reset_launch_counts, variant_counts

    reset_launch_counts()
    breakdown = None
    if args.trace:
        episodes, tr, breakdown, busy_s, window_s = traced(
            sim, start, steps, prog.t_end, args.seconds, device)
        wall = None
    else:
        episodes, wall, busy, ops = profiled_window(sim, start, steps, prog.t_end,
                                                    args.seconds, device)
    sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"launches {launch_counts()} variants {variant_counts()}")
    for i, ep in enumerate(episodes):
        log(f"episode {i}: " + " ".join(
            f"({r['dt']}, {r['newton']}, {r['ksp']}, {r['retries']}, {r['wall']:.4f})"
            for r in ep.records) + (" FAILED" if ep.failed else ""))
    log(f"peak {peak / 2**30:.4f} GiB; {card_record(device)}")

    # the program's state goes before the reference runs
    del sim, prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = Reference(inputs.model, inputs.shape, inputs.spacing, inputs.gravity, inputs.fields,
                    inputs.wells, inputs.heaters, inputs.physics, inputs.relperm, device)
    readings = check.judge(ref, episodes, cfg, float(config["t_end"]))
    correct, shown = check.verdict(readings, cell["limits"])

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 4

    accepted = [r for ep in episodes for r in ep.records]
    attempted = len(accepted) + sum(ep.failed for ep in episodes)
    if args.trace:
        metrics, missing = {}, []
        for m in cell["per_layer"]:
            value = reader(args.root, m["name"])(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            elif device.type == "cuda" or m["source"] != "device_trace":
                # listed for this cell, so there is something to read; the
                # CPU rehearsal profiles no device
                missing.append(m["name"])
        if missing or tr["unseen"]:
            print(f"the traced run found nothing to read for {missing}; kernel launches "
                  f"outside the wrapper calls the harness saw: {tr['unseen']}. The program "
                  "no longer calls these layers or kernels through the module attributes "
                  "that trace.py instruments", file=sys.stderr)
            return 5
    else:
        sim_s = sum(r["dt"] for r in accepted)
        log(f"window: {len(episodes)} episodes, {len(accepted)} steps, {sim_s} simulated s "
            f"in {wall} s (wall rate {sim_s / wall} sim-s/s under the profile); device busy "
            f"{busy} s over {ops} operations")
        if busy <= 0.0:
            print("the window's profile holds no device operation", file=sys.stderr)
            return 6
        values = {"device_sim_rate": sim_s / busy, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if args.trace:
        dev.update(busy_s=busy_s, window_s=window_s)
    result = {"correct": bool(correct), "attempted": attempted, "failed": readings["failed"],
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # a reading that is no finite number is shown as text
    result["limits"] = {k: [v if math.isfinite(v) else str(v), lim] for k, (v, lim) in shown.items()}
    print(f"steps_judged {readings['steps']} (at least 1)", file=sys.stderr)
    for name, (value, limit) in shown.items():
        print(f"{name} {value} limit {limit}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
