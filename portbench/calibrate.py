"""The readings the correctness limits are set from: for each field, in
one process, the cell's set-up and ``--episodes`` episodes at the cell's
own size, judged as a run judges them — the program's states (the lower
reading) and the same states rounded to bfloat16 (the control, the upper
reading) — with each field's step counts, walls and set-up time.

    python3 -m portbench.calibrate --workload <cell> [--fields 2020,11,12] [--episodes 2]

A field is the ``base_seed`` its recipe is drawn from; the configuration's
own is the default, and a run's ``--seed`` changes nothing, so fields other
than the configuration's are the way to show the reference more than one
input.  The benchmark's own runs do not run this.  It prints one line per
field and then, per number, the largest program reading and the smallest
control reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from portbench import check
from portbench.problem import build_program, make_inputs, resolved
from portbench.reference.residual import Reference
from portbench.run import ROOT, load_cell, run_episode, setup
from portbench.trace import sync

NUMBERS = ("res_rms", "res_max", "dt_gap", "failed")


def readings_for_field(cell: dict, base_seed: int | None, episodes: int, device,
                       rehearse: bool, root=ROOT) -> dict:
    """One field's readings; ``base_seed`` None keeps the configuration's."""
    cfg = resolved(cell["config"], rehearse)
    if base_seed is not None:
        cfg["fields"]["base_seed"] = base_seed
    t0 = time.perf_counter()
    inputs = make_inputs(cfg, device, root)
    prog = build_program(cfg, inputs, device)
    start = setup(prog.simulator, cell["traffic"], prog.t_end)
    sync(device)
    setup_s = time.perf_counter() - t0
    steps = int(cell["traffic"]["episode"]["steps"])
    eps, walls = [], []
    for _ in range(episodes):
        t = time.perf_counter()
        eps.append(run_episode(prog.simulator, start, steps, prog.t_end))
        sync(device)
        walls.append(time.perf_counter() - t)
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = Reference(inputs.model, inputs.shape, inputs.spacing, inputs.gravity, inputs.fields,
                    inputs.wells, inputs.heaters, inputs.physics, inputs.relperm, device)
    t_end = float(cell["config"]["t_end"])
    return {"base_seed": cfg["fields"]["base_seed"], "setup_s": setup_s, "episode_s": walls,
            "start": [start[1], start[2], start[3]],
            "steps": [[(r["dt"], r["newton"], r["ksp"], r["retries"]) for r in ep.records]
                      for ep in eps],
            "program": check.judge(ref, eps, cfg, t_end),
            "control": check.judge(ref, eps, cfg, t_end, lower_precision=True)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fields", default="",
                    help="comma-separated base seeds of the field (default: the configuration's)")
    ap.add_argument("--episodes", type=int, default=1)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    cell = load_cell(ROOT, args.workload)
    if args.rehearse:
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    else:
        device = torch.device("cuda", 0)
    rows = []
    fields = [int(f) for f in args.fields.split(",") if f] or [None]
    for base_seed in fields:
        row = readings_for_field(cell, base_seed, args.episodes, device, args.rehearse)
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "fields": [r["base_seed"] for r in rows],
               "lower": {k: max(r["program"][k] for r in rows) for k in NUMBERS},
               "upper": {k: min(r["control"][k] for r in rows) for k in NUMBERS}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
