"""Run a named simulation case from the command line (counterpart of
``examples/run_case.py``, with its flags and output lines).

    python -m thermalporous_torch.run_case --list
    python -m thermalporous_torch.run_case --case sp_hot_injection_2d --t-end-days 30
    python -m thermalporous_torch.run_case --case tp_thermal_2d --vtk out/ --balance
    python -m thermalporous_torch.run_case --case tp_thermal_2d --resume out/ckpt_0000010.npz
    python -m thermalporous_torch.run_case --case sp_hot_injection_2d --device cpu

Prints per-step telemetry and an end-of-run summary (Newton and FGMRES
totals, cell-updates/s), with ``--balance`` the material/energy balance
table, and the final well rates.  Runs on the card (``--device cuda``, the
default) unless ``--device cpu`` is given; f64 unless ``--f32``.

Not here: ``--fuse`` and ``--pallas-gmg`` chose the reference's Pallas
kernels on the TPU; on a CUDA device the port's hand-written kernels are
always the route.  ``--qualify`` (the TPU shape preflight) and ``--platform
tpu`` are TPU-only.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m thermalporous_torch.run_case",
        description=__doc__.splitlines()[0],
        epilog="Left out (TPU-only): --fuse and --pallas-gmg (on a CUDA device the "
               "hand-written kernels are the route), --qualify, --platform.")
    p.add_argument("--case", default="sp_hot_injection_2d")
    p.add_argument("--list", action="store_true", help="list available cases")
    p.add_argument("--t-end-days", type=float, default=None)
    p.add_argument("--max-steps", type=int, default=100000,
                   help="absolute step-index cap (a resumed run counts from its "
                        "checkpoint's step)")
    p.add_argument("--precond", default=None,
                   choices=[None, "none", "jacobi", "rbgs", "lu", "cpr", "cptr"])
    p.add_argument("--dt0", type=float, default=None, help="initial dt [s]")
    p.add_argument("--predictor", default=None, choices=[None, "none", "linear"],
                   help="Newton initial guess: linear = extrapolate from the "
                        "previous step (same converged answer, fewer iterations)")
    p.add_argument("--ds-max", type=float, default=None,
                   help="Appleyard saturation chop: per-Newton-iteration |dS| "
                        "clamp (two-phase models; 0 disables)")
    p.add_argument("--ls-mode", default=None, choices=[None, "armijo", "nonmonotone"],
                   help="line-search acceptance (nonmonotone pairs with --ds-max "
                        "on hard saturation fronts)")
    p.add_argument("--block-steps", type=int, default=None,
                   help="advance this many controller steps per block (callbacks "
                        "then fire per block)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the case runs (default: the CUDA device)")
    p.add_argument("--x64", action="store_true", default=True)
    p.add_argument("--f32", dest="x64", action="store_false")
    p.add_argument("--vtk", default=None, metavar="DIR", help="write .pvd/.vti series")
    p.add_argument("--vtk-every", type=int, default=5)
    p.add_argument("--metrics", default=None, metavar="FILE", help="JSONL telemetry")
    p.add_argument("--ckpt-dir", default=None, metavar="DIR")
    p.add_argument("--ckpt-every", type=int, default=10)
    p.add_argument("--resume", default=None, metavar="NPZ")
    p.add_argument("--fuse-below", type=int, default=None, metavar="CELLS",
                   help="run the whole multigrid subtree at/below this many cells "
                        "as one launch (0 disables; GMGConfig.fuse_below)")
    p.add_argument("--decoupling", default=None, choices=[None, "qimpes", "timpes", "abf"],
                   help="CPR/CPTR decoupling variant")
    p.add_argument("--cycle", default=None, choices=[None, "v", "w", "k"],
                   help="multigrid cycle type")
    p.add_argument("--balance", action="store_true",
                   help="end-of-run material/energy balance audit")
    p.add_argument("--quiet", action="store_true")
    return p


def build(args: argparse.Namespace):
    """The case of ``args`` on ``args.device`` and the keywords of its
    ``Simulator``: ``(case, dict(precond, pc_cfg, newton_cfg, time_cfg))``,
    each flag applied as the reference's ``main`` applies it."""
    from thermalporous_torch.precond import CPRConfig
    from thermalporous_torch.presets import get_case

    dtype = torch.float64 if args.x64 else torch.float32
    case = get_case(args.case, device=args.device, dtype=dtype)
    pc_cfg = case.pc_cfg
    if args.decoupling or args.cycle or args.fuse_below is not None:
        base = pc_cfg if pc_cfg is not None else CPRConfig()
        gmg = dataclasses.replace(
            base.gmg,
            cycle_type=args.cycle or base.gmg.cycle_type,
            fuse_below=(args.fuse_below if args.fuse_below is not None
                        else base.gmg.fuse_below),
        )
        gmg_t = base.gmg_t
        if gmg_t is not None and args.fuse_below is not None:
            gmg_t = dataclasses.replace(gmg_t, fuse_below=args.fuse_below)
        pc_cfg = dataclasses.replace(base, decoupling=args.decoupling or base.decoupling,
                                     gmg=gmg, gmg_t=gmg_t)
    newton_cfg = case.newton_cfg
    if args.ds_max is not None or args.ls_mode:
        over = {}
        if args.ds_max is not None:
            over["ds_max"] = args.ds_max if args.ds_max > 0 else None
        if args.ls_mode:
            over["ls_mode"] = args.ls_mode
        newton_cfg = dataclasses.replace(newton_cfg, **over)
    time_cfg = case.time_cfg
    if args.predictor or args.block_steps:
        over = {}
        if args.predictor:
            over["predictor"] = args.predictor
        if args.block_steps:
            over["block_steps"] = args.block_steps
        time_cfg = dataclasses.replace(time_cfg, **over)
    return case, dict(precond=args.precond or case.precond, pc_cfg=pc_cfg,
                      newton_cfg=newton_cfg, time_cfg=time_cfg)


def main(argv: list[str] | None = None) -> int:
    args = parser().parse_args(argv)

    from thermalporous_torch.io import (
        BalanceAuditor,
        CheckpointManager,
        MetricsLogger,
        PVDWriter,
        format_balance,
        load_checkpoint,
        state_fields,
    )
    from thermalporous_torch.physics import well_rates
    from thermalporous_torch.presets import CASE_DESCRIPTIONS
    from thermalporous_torch.solve import Simulator

    if args.list:
        for name, desc in sorted(CASE_DESCRIPTIONS.items()):
            print(f"{name:24s} {desc}")
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_case: --device cuda, but torch.cuda.is_available() is "
                         "False; pass --device cpu to run on the CPU")

    case, sim_kw = build(args)
    model = case.model
    print(f"# {case.name}: {case.description}")
    print(f"# grid {model.grid.shape} = {model.grid.ncells} cells, "
          f"{model.nc} unknowns/cell, precond={sim_kw['precond']}")
    sim = Simulator(model, case.data, device=args.device, **sim_kw)

    callbacks = []
    if args.vtk:
        writer = PVDWriter(args.vtk, case.name, model.grid)
        writer.write(0.0, state_fields(model, model.initial_state(case.data)))
        # block-mode intermediate records carry a later state than their
        # clock: frames only at consistent records, every vtk_every steps
        # since the last frame (retries shift block-final step numbers)
        vtk_last = [0]

        def vtk_cb(step, t, u, rec):
            if not getattr(rec, "state_consistent", True):
                return
            if step - vtk_last[0] < args.vtk_every:
                return
            vtk_last[0] = step
            writer.write(t, state_fields(model, u))

        callbacks.append(vtk_cb)
    metrics = None
    if args.metrics:
        metrics = MetricsLogger(args.metrics, ncells=model.grid.ncells,
                                extra={"case": case.name})
        callbacks.append(metrics)
    if args.ckpt_dir:
        callbacks.append(CheckpointManager(args.ckpt_dir, every=args.ckpt_every, name="ckpt"))

    u0, dt0, t0, step0, dt_cap0 = None, args.dt0, 0.0, 0, None
    if args.resume:
        u0, t0, dt_saved, step0, meta = load_checkpoint(
            args.resume, device=args.device, dtype=case.data.fields.dtype)
        dt0 = dt0 or dt_saved
        dt_cap0 = meta.get("dt_cap")  # the failure-memory cap, when active
        print(f"# resuming from {args.resume}: t={t0:.4e}s step={step0}")

    auditor = None
    if args.balance:
        if u0 is None:
            u0 = model.initial_state(case.data)
        # on --resume the audit window starts at the checkpoint's state
        auditor = BalanceAuditor(model, case.data, u0)
        callbacks.append(auditor)

    def callback(step, t, u, rec):
        for cb in callbacks:
            cb(step, t, u, rec)

    t_end = (args.t_end_days * 86400.0) if args.t_end_days else case.t_end
    try:
        result = sim.run(t_end=t_end, u0=u0, dt0=dt0, t0=t0, step0=step0,
                         max_steps=args.max_steps,
                         callback=callback if callbacks else None,
                         verbose=not args.quiet, dt_cap0=dt_cap0)
    finally:
        if metrics is not None:
            metrics.close()

    n = max(result.total_newton, 1)
    print(f"# done: t={result.t:.4e}s in {result.steps} steps, wall {result.wall_s:.1f}s")
    print(f"# newton total {result.total_newton} "
          f"({result.total_newton / max(result.steps, 1):.1f}/step), "
          f"fgmres total {result.total_ksp} ({result.total_ksp / n:.1f}/newton)")
    print(f"# throughput {model.grid.ncells * result.total_newton / result.wall_s:.3e} "
          "cell-updates/s")
    if auditor is not None:
        print(format_balance(auditor.report()))
    if case.well_masks:
        print("# final well rates (positive = into reservoir):")
        for name, rec in well_rates(model, result.u, case.data, case.well_masks).items():
            vals = "  ".join(f"{k}={v:+.4g}" for k, v in rec.items())
            print(f"#   {name:10s} {vals}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
