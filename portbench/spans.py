"""The program's own spans and counters (``thermalporous_torch/tracing.py``)
in one cell, read into the per-layer figures they measure.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s> [--rehearse]

From the root of a checkout; the cell is built as ``run.py`` builds it.  In
order:

1. the set-up under the recorder, from before the kernel library's build
   through the traffic's set-up steps: seconds by span name, and
   ``setup.first_assembly_s``, the process's first ``assembly`` span (its
   first ``torch.func`` call);
2. the recorder's cost on: plain windows of ``--seconds`` (``run.py``'s
   window, no profile), the recorder off and on in turns, off first;
3. a window of whole episodes of at least ``PROFILE_SECONDS`` under the
   recorder and a profile of the device's activity alone: each device
   operation is credited to the innermost span that holds the runtime call
   that made it (a launch, a copy or a fill), each idle gap between the device's
   operations to the innermost span at its middle, and each CUDA runtime
   call (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ``cudaStreamSynchronize``
   and the rest) to the innermost span at its start; Newton iterations are
   the ``newton.iter`` spans, retries included;
4. the recorder's cost off: a disabled ``span()`` and ``host_read`` of a
   0-dim tensor against its bare ``.item()``, on the host, times the spans
   and reads a Newton iteration makes, over the host's seconds a Newton
   iteration takes in the plain windows.

The last line is one JSON object: ``figures`` (:data:`FIGURES`, each
``{"value", "unit"}``), ``checks`` (the share of linked device operations
launched inside an ``episode`` span; ``newton.iter`` spans against the
records' Newton iterations), ``setup``, ``on_cost`` and ``off_cost``.  A
run whose profiled window holds no ``assembly`` or no ``newton.iter`` span
prints no result (exit 5): the program no longer records the layers these
figures read.  ``--rehearse`` runs on the CPU at the configuration's
rehearsal size, where the profile's operators called from Python stand in
for the device's and the two figures read from the device are left out.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

import torch

from portbench import run, trace
from portbench.problem import build_program, make_inputs, resolved
from portbench.trace import sync

PROFILE_SECONDS = run.PROFILE_SECONDS

# name: (unit, read from the device's profile)
FIGURES = {
    "assembly.ops_per_newton": ("ops/newton", True),
    "cptr.setup_ops_per_newton": ("ops/newton", True),
    "host.us_per_op": ("us/op", False),
    "host.reads_per_newton": ("reads/newton", False),
    "host.wait_ms_per_newton": ("ms/newton", False),
    "setup.first_assembly_s": ("s", False),
}


def log(msg: str) -> None:
    print(f"# {msg}", flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU at the configuration's rehearsal size")
    ap.add_argument("--root", type=pathlib.Path, default=run.ROOT,
                    help="directory holding BENCHMARK.json and portbench/'s data files")
    return ap.parse_args(argv)


def innermost(spans, times) -> list:
    """The index in ``spans`` (nested intervals, in the order they opened)
    of the innermost span open at each of ``times``, None outside all."""
    out = [None] * len(times)
    stack, i = [], 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while i < len(spans) and spans[i].start_ns <= t:
            while stack and spans[stack[-1]].end_ns < spans[i].start_ns:
                stack.pop()
            stack.append(i)
            i += 1
        while stack and spans[stack[-1]].end_ns < t:
            stack.pop()
        out[k] = stack[-1] if stack else None
    return out


def within(spans) -> list[frozenset]:
    """The names of each span and of every span around it."""
    index = {s.id: i for i, s in enumerate(spans)}
    out: list[frozenset] = []
    for s in spans:
        up = out[index[s.parent]] if s.parent in index else frozenset()
        out.append(up | {s.name})
    return out


def seconds_by_name(spans, name: str) -> float:
    return sum(s.end_ns - s.start_ns for s in spans if s.name == name) * 1e-9


def device_ops(prof) -> tuple[trace.Profile, list[tuple[int, str]]]:
    """The device's operations of a profile of its activity alone, each with
    the start of the runtime call that made it (a launch, and a copy or a
    fill too: ``trace.Profile.of`` links launches alone), and (start_ns,
    name) of every CUDA runtime call (every ``cu*`` entry)."""
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    host, calls = {}, []
    for e in events:
        if e.device_type() != cuda and e.name().startswith("cu"):
            host[e.correlation_id()] = e.start_ns()
            calls.append((e.start_ns(), e.name()))
    ops, launched = [], []
    for e in events:
        if e.device_type() == cuda:
            ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
            launched.append(host.get(e.correlation_id(), host.get(e.linked_correlation_id())))
    return trace.Profile(ops, launched), calls


def read_profile(rec, prof, episodes, device) -> tuple[dict, dict, dict]:
    """The profiled window's figures, checks and breakdown."""
    spans = [s for s in rec.spans if s.end_ns]
    up = within(spans)
    newton = sum(s.name == "newton.iter" for s in spans)
    if device.type == "cuda":
        pr, calls = device_ops(prof)
        linked = [(op, at) for op, at in zip(pr.ops, pr.launched) if at is not None]
        ops, times = [op for op, _ in linked], [at for _, at in linked]
    else:       # the CPU's operators called from Python, each at its own start
        ops = [op for op, around in operators(prof) if not around]
        times = [s for s, _, _ in ops]
        pr, calls = trace.Profile(ops, times), []
    where = innermost(spans, times)
    inside = lambda name: sum(w is not None and name in up[w] for w in where)
    in_episode = inside("episode")
    episode_s = seconds_by_name(spans, "episode")
    wait_s = seconds_by_name(spans, "wait")
    iters = sum(r["newton"] for ep in episodes for r in ep.records)
    figures = {
        "assembly.ops_per_newton": inside("assembly") / newton if newton else None,
        "cptr.setup_ops_per_newton": inside("pc_setup") / newton if newton else None,
        "host.us_per_op": 1e6 * (episode_s - wait_s) / in_episode if in_episode else None,
        "host.reads_per_newton": rec.counters.get("host.reads", 0) / newton if newton else None,
        "host.wait_ms_per_newton": 1e3 * wait_s / newton if newton else None,
    }
    checks = {"linked_ops": len(ops), "device_ops": len(pr.ops),
              "linked_in_episode_pct": 100.0 * in_episode / len(ops) if ops else None,
              "newton_iter_spans": newton, "records_newton_iters": iters}

    def by_span(indices, weights=None):
        out: dict[str, float] = {}
        for n, w in enumerate(indices):
            name = "outside" if w is None else spans[w].name
            out[name] = out.get(name, 0) + (1 if weights is None else weights[n])
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    busy = trace.merged(pr.ops)
    gaps = [(a, b) for (_, a), (b, _) in zip(busy, busy[1:])]
    idle = by_span(innermost(spans, [(a + b) // 2 for a, b in gaps]),
                   [(b - a) * 1e-9 for a, b in gaps])
    call_where = innermost(spans, [t for t, _ in calls])
    runtime: dict[str, dict[str, int]] = {}
    for (_, name), w in zip(calls, call_where):
        per = runtime.setdefault("outside" if w is None else spans[w].name, {})
        per[name] = per.get(name, 0) + 1
    breakdown = {"ops_by_span": by_span(where), "idle_s_by_span": idle,
                 "runtime_calls_by_span": runtime,
                 "span_ms_per_newton": {
                     name: 1e3 * seconds_by_name(spans, name) / newton
                     for name in sorted({s.name for s in spans})} if newton else {}}
    return figures, checks, breakdown


def operators(prof) -> list:
    """Every CPU operator of the profile as ((start_ns, end_ns, name), the
    names of the operators around it), in the order they started."""
    events = sorted((e.start_ns(), -e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == torch.autograd.DeviceType.CPU)
    out, around = [], []
    for start, neg, name in events:
        end = start - neg
        while around and around[-1][1] < end:
            around.pop()
        out.append(((start, end, name), [a[2] for a in around]))
        around.append((start, end, name))
    return out


def off_cost(n: int = 200_000) -> dict:
    """Host seconds of a disabled span with an attribute, and of
    ``host_read`` of a 0-dim CPU tensor over its bare ``.item()``."""
    from thermalporous_torch.tracing import host_read, span

    x = torch.zeros(())
    best = {}
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            pass
        t1 = time.perf_counter()
        for _ in range(n):
            with span("x").set("k", 0):
                pass
        t2 = time.perf_counter()
        for _ in range(n):
            x.item()
        t3 = time.perf_counter()
        for _ in range(n):
            host_read(x)
        t4 = time.perf_counter()
        for key, value in (("span_s", (t2 - t1 - (t1 - t0)) / n),
                           ("read_s", (t4 - t3 - (t3 - t2)) / n)):
            best[key] = min(best.get(key, value), value)
    return best


def main(argv=None) -> int:
    args = parse(argv)
    cell = run.load_cell(args.root, args.workload)
    config, traffic = cell["config"], cell["traffic"]
    if args.rehearse:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print(f"{args.workload} needs a CUDA device", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    from thermalporous_torch import tracing

    cfg = resolved(config, args.rehearse)
    with tracing.recording() as setup_rec:
        if device.type == "cuda":
            from thermalporous_torch.kernels import _lib

            torch.cuda.init()
            _lib.build()
            _lib.load()
        inputs = make_inputs(cfg, device, args.root)
        prog = build_program(cfg, inputs, device)
        sim = prog.simulator
        start = run.setup(sim, traffic, prog.t_end)
        sync(device)
    steps = int(traffic["episode"]["steps"])
    run.run_episode(sim, start, steps, prog.t_end)          # the warm-up
    with run.profiled(device):      # the profiler's own start-up, once
        torch.ones(8, device=device).sum().item()
    if device.type == "cuda":
        log(run.steady_host())
    first = next((s for s in setup_rec.spans if s.name == "assembly"), None)
    setup = {name: seconds_by_name(setup_rec.spans, name)
             for name in sorted({s.name for s in setup_rec.spans})}
    log("set-up spans (s): " + ", ".join(f"{k} {v:.4f}" for k, v in setup.items()))

    rates: dict[str, list] = {"off": [], "on": []}
    newton_wall = []
    for turn in ("off", "on", "off", "on"):
        with tracing.recording() if turn == "on" else contextlib.nullcontext():
            eps, wall = run.window(sim, start, steps, prog.t_end, args.seconds, device)
        recs = [r for ep in eps for r in ep.records]
        rates[turn].append(sum(r["dt"] for r in recs) / wall)
        if turn == "off":
            newton_wall.append((sum(r["newton"] for r in recs), wall))
        log(f"plain window, recorder {turn}: {len(eps)} episodes, wall rate "
            f"{rates[turn][-1]} sim-s/s")

    with tracing.recording() as rec, run.profiled(device) as prof:
        episodes, window_s = run.window(sim, start, steps, prog.t_end, PROFILE_SECONDS, device)
    if not any(s.name == "assembly" for s in rec.spans) or not any(
            s.name == "newton.iter" for s in rec.spans):
        print("the profiled window recorded no assembly or no newton.iter span: the program "
              "no longer records the layers these figures read", file=sys.stderr)
        return 5
    figures, checks, breakdown = read_profile(rec, prof, episodes, device)
    figures["setup.first_assembly_s"] = (first.end_ns - first.start_ns) * 1e-9 if first else None
    log(f"profiled window: {len(episodes)} episodes in {window_s} s; {checks['device_ops']} "
        f"device operations, {checks['linked_ops']} linked to a launch, "
        f"{checks['linked_in_episode_pct']}% of those launched inside an episode span; "
        f"newton.iter spans {checks['newton_iter_spans']}, records' Newton iterations "
        f"{checks['records_newton_iters']}")
    log("idle s by innermost span: " + json.dumps(breakdown["idle_s_by_span"]))
    log("CUDA runtime calls by innermost span: " + json.dumps(breakdown["runtime_calls_by_span"]))
    log("device operations by innermost span: " + json.dumps(breakdown["ops_by_span"]))

    cost = off_cost()
    spans_made = sum(s.name != "wait" for s in rec.spans) / checks["newton_iter_spans"]
    reads = figures["host.reads_per_newton"]
    iters, wall = map(sum, zip(*newton_wall))
    per_newton_s = wall / iters
    off = {**cost, "spans_per_newton": spans_made, "reads_per_newton": reads,
           "host_s_per_newton": per_newton_s,
           "pct_of_newton": 100.0 * (spans_made * cost["span_s"] + reads * cost["read_s"])
           / per_newton_s}
    log(f"recorder off: {off}")
    log(f"plain windows' wall rates by recorder state: {rates}")

    if args.rehearse:
        figures = {k: v for k, v in figures.items() if not FIGURES[k][1]}
    result = {"workload": args.workload, "seed": args.seed,
              "figures": {k: {"value": v, "unit": FIGURES[k][0]}
                          for k, v in figures.items() if v is not None},
              "checks": checks, "setup": setup, "on_cost": rates, "off_cost": off,
              "breakdown": breakdown, "device": run.card_record(device)}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
