"""How far rounding alone moves the flagship's first step, on one NVIDIA GPU.

    python3 decomp_sensitivity.py [--json PATH]
    python3 decomp_sensitivity.py --recycle

The decomposed run (``chip_smoke.py`` phase 15) changes only the rounding
of the global reductions.  This script measures what such a change does to
``tp_spe10_full``'s first 600 s step at 60x220x85 without any
decomposition: the undecomposed step from the initial state, and from the
initial state with one cell's pressure one ulp higher (two cells of the
injector's column, in turn), in f32 and in f64; then, in f64, the step on
four gloo ranks sharing the card (the flagship split 2x2) against the
undecomposed f64 step.  Prints (Newton, FGMRES) and the largest gap per
component (p [Pa], T [K], S_w) of each run to the unperturbed step.
About 3 minutes; exits nonzero without CUDA.

With ``--recycle`` (on the CPU, about 15 s): the same probe on the
undecomposed step of ``chip_smoke.py`` phase 15(e)'s "ksp_recycle=4"
option (the flagship configuration at 12x22x9, f64, under the flagship's
loose Krylov tolerances), from the initial state and with RECYCLE_CELL's
pressure one ulp higher: why (e) holds that option to the Newton test and
not to the reference's bands.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

#: the perturbed cells: (component, x, y, z), the injector's column
NUDGES = ((0, 30, 110, 40), (0, 30, 110, 42))
#: the perturbed cell of --recycle: (component, x, y, z)
RECYCLE_CELL = (0, 6, 11, 4)


def step(dev, dtype, nudge=None):
    """The undecomposed first step, optionally from a nudged state: (state
    as f64 numpy, (Newton, FGMRES), the planned level factors, wall)."""
    from thermalporous_torch.presets import get_case
    from thermalporous_torch.solve import make_step_fn

    case = get_case("tp_spe10_full", device=dev, dtype=dtype)
    pc = case.simulator(pc_cfg=cs.with_fuse(case.pc_cfg, cs.FLAGSHIP_FUSE_BELOW)).pc_cfg
    advance = make_step_fn(case.model, "cptr", case.newton_cfg, pc, device=dev)
    u0 = case.model.initial_state(case.data)
    if nudge is not None:
        u0 = u0.clone()
        u0[nudge] = torch.nextafter(u0[nudge], u0.new_tensor(float("inf")))
    t = time.perf_counter()
    u, st = advance(u0, cs.DECOMP_DT, case.data)
    torch.cuda.synchronize()
    return (u.cpu().numpy().astype(np.float64), (st.iters, st.ksp_iters),
            (pc.gmg.level_factors, pc.gmg_t.level_factors), time.perf_counter() - t)


def recycle_ulp() -> dict:
    """--recycle: the "ksp_recycle=4" option's CPU step from the initial
    state and from it with RECYCLE_CELL one ulp up: both (Newton, FGMRES)
    and the largest gap per component."""
    torch.set_num_threads(2)
    label = "ksp_recycle=4"
    case, pc, newton = cs._decomp_option_case(label, "cpu", factors=cs.decomp_option_factors())
    u0 = case.model.initial_state(case.data)
    nudged = u0.clone()
    nudged[RECYCLE_CELL] = torch.nextafter(nudged[RECYCLE_CELL], nudged.new_tensor(float("inf")))
    runs = [case.simulator(pc_cfg=pc, newton_cfg=newton).step(u, cs.DECOMP_DT)
            for u in (u0, nudged)]
    gaps = cs._gaps(runs[1][0].numpy(), runs[0][0].numpy())
    counts = [(st.iters, st.ksp_iters) for _, st in runs]
    print(f"{label} 12x22x9 f64 on the CPU: (newton, fgmres) {counts[0]}; p{list(RECYCLE_CELL[1:])} "
          f"one ulp up: {counts[1]}, gaps p {gaps[0]:.6e} Pa, T {gaps[1]:.6e} K, "
          f"S {gaps[2]:.6e}", flush=True)
    return {"counts": counts, "cell": RECYCLE_CELL, "gaps": gaps}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the record to this path")
    ap.add_argument("--recycle", action="store_true",
                    help="the ksp_recycle=4 probe on the CPU alone")
    args = ap.parse_args()
    if args.recycle:
        rec = recycle_ulp()
        if args.json:
            with open(args.json, "w") as fh:
                json.dump(rec, fh, indent=1)
        return 0
    if not torch.cuda.is_available():
        print("decomp_sensitivity: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from thermalporous_torch.dist.launch import run_ranks

    dev = torch.device("cuda")
    rec = {}
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).removeprefix("torch.")
        ref, counts, factors, wall = step(dev, dtype)
        print(f"{tag}: (newton, fgmres) {counts}, wall {wall:.3f} s", flush=True)
        rec[tag] = {"counts": counts, "nudged": []}
        for nudge in NUDGES:
            u, c, _, wall = step(dev, dtype, nudge)
            gaps = cs._gaps(u, ref)
            print(f"{tag}: p{list(nudge[1:])} one ulp up: (newton, fgmres) {c}, gaps p "
                  f"{gaps[0]:.6e} Pa, T {gaps[1]:.6e} K, S {gaps[2]:.6e}", flush=True)
            rec[tag]["nudged"].append({"cell": nudge, "counts": c, "gaps": gaps})
    outs, _ = run_ranks(cs._decomp_rank, cs.DECOMP_RANKS, factors, "float64",
                        backend="gloo", device="cuda:0")
    gaps = cs._gaps(outs[0]["u"], ref)
    print(f"float64 2x2 over {cs.DECOMP_RANKS} gloo ranks: (newton, fgmres) "
          f"({outs[0]['newton']}, {outs[0]['fgmres']}), gaps p {gaps[0]:.6e} Pa, T "
          f"{gaps[1]:.6e} K, S {gaps[2]:.6e}", flush=True)
    rec["float64_2x2"] = {"counts": (outs[0]["newton"], outs[0]["fgmres"]), "gaps": gaps}
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True,
                            text=True).stdout.strip())
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(rec, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
