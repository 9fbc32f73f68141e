"""The preconditioner iteration study, the experiment family of papers
arXiv:1812.11566 and arXiv:1907.04229 (counterpart of
``examples/iteration_study.py``, with its problems, columns and output
lines).

    python -m thermalporous_torch.iteration_study [--tp] [--steps N] [--device cpu]

The headline table: FGMRES iterations per Newton for the one-stage
preconditioners (block Jacobi and red-black block Gauss–Seidel, the ILU
analogues), CPR, CPTR and CPTR with three inner iterations (with ``--tp``
also CPTR-S, the saturation stage-1 leg), over 20², 40² and 80² homogeneous
grids, a synthetic SPE10 layer and (single-phase only) the heater-stiff 80²
case; CPTR's counts stay nearly flat.  Each cell is ``--steps`` fixed steps
from the initial state; "fail" marks a step that did not converge.  f64;
runs on the card (``--device cuda``, the default) unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m thermalporous_torch.iteration_study",
                                description=__doc__.splitlines()[0])
    p.add_argument("--tp", action="store_true", help="two-phase instead of single")
    p.add_argument("--steps", type=int, default=3, help="fixed steps per cell")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the study runs (default: the CUDA device)")
    return p


def problems(tp: bool, device: torch.device | str) -> list:
    """The table's rows: (name, model, data, Δt) on ``device``, f64."""
    from thermalporous_torch.core import Grid
    from thermalporous_torch.data import SPE10_SPACING_M, synthetic_spe10
    from thermalporous_torch.models import SinglePhaseModel, TwoPhaseModel, make_problem_data
    from thermalporous_torch.physics import Heater, PhysicalParams, Well

    pp = PhysicalParams()
    model_cls = TwoPhaseModel if tp else SinglePhaseModel
    mk = lambda g, **kw: make_problem_data(g, pp, dtype=torch.float64, device=device, **kw)

    def homo_case(n):
        g = Grid(shape=(n, n), spacing=(400.0 / n, 400.0 / n), thickness=10.0)
        rng = np.random.default_rng(0)
        k = 1e-13 * np.exp(0.5 * rng.standard_normal(g.shape))
        wells = [Well(cells=((0, 0),), control="bhp", p_bh=3.0e7, T_inj=420.0),
                 Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7)]
        return model_cls(g, pp), mk(g, kx=k, phi=0.2, wells=wells)

    def spe10_case(layer=0):
        f = synthetic_spe10(seed=2020).layer(layer)
        nx, ny = f.kx.shape
        dx, dy, dz = SPE10_SPACING_M
        g = Grid(shape=(nx, ny), spacing=(dx, dy), thickness=dz)
        wells = [Well(cells=((nx // 2, ny // 2),), control="bhp", p_bh=3.5e7, T_inj=420.0),
                 Well(cells=((2, 2),), control="bhp", p_bh=1.0e7)]
        return model_cls(g, pp), mk(g, kx=f.kx, ky=f.ky, phi=f.phi, wells=wells)

    def stiff_case(n=80):
        g = Grid(shape=(n, n), spacing=(5.0, 5.0), thickness=10.0)
        rng = np.random.default_rng(0)
        k = 1e-13 * np.exp(0.5 * rng.standard_normal(g.shape))
        wells = [Well(cells=((0, 0),), control="bhp", p_bh=3.5e7, T_inj=450.0),
                 Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7)]
        heaters = [Heater(cells=tuple((n // 2, j) for j in range(10, n - 10)), power=5e6)]
        return model_cls(g, pp), mk(g, kx=k, phi=0.2, wells=wells, heaters=heaters)

    rows = [(f"homog {n}x{n}", *homo_case(n), 2.0e4) for n in (20, 40, 80)]
    rows.append(("SPE10-layer 60x220", *spe10_case(), 2.0e4))
    if not tp:
        # a strong heat source and a large Δt separate CPTR from
        # pressure-only CPR
        rows.append(("heater-stiff 80x80", *stiff_case(), 1.0e5))
    return rows


def preconds(tp: bool) -> list:
    """The table's columns: (label, CPRConfig or None)."""
    from thermalporous_torch.precond import CPRConfig

    cols = [("jacobi", None), ("rbgs", None), ("cpr", None), ("cptr", None),
            ("cptr-in3", CPRConfig(variant="cptr", inner_iters=3))]
    if tp:
        # CPTR-S: the saturation stage-1 leg (two-phase only)
        cols.append(("cptr-s", CPRConfig(variant="cptr", stage2="rbgs", s_stage="rbgs",
                                         s_sweeps=2)))
    return cols


def row(model, data, dt: float, cols, steps: int, device) -> list:
    """One row: per column, (FGMRES total, Newton total) over ``steps`` fixed
    steps from the initial state, or None when a step does not converge."""
    from thermalporous_torch.solve import NewtonConfig, Simulator

    out = []
    for pc, pc_cfg in cols:
        sim = Simulator(model, data, precond="cptr" if pc.startswith("cptr") else pc,
                        pc_cfg=pc_cfg, newton_cfg=NewtonConfig(ksp_maxiter=300),
                        device=device)
        u = model.initial_state(data)
        tot_k = tot_n = 0
        for _ in range(steps):
            u2, st = sim.step(u, dt)
            if not st.converged:
                tot_k = None
                break
            u = u2
            tot_k += st.ksp_iters
            tot_n += st.iters
        out.append(None if tot_k is None else (tot_k, tot_n))
    return out


def format_row(name: str, counts: list) -> str:
    return f"{name:20s} " + "  ".join(
        "   fail " if c is None else f"{c[0] / max(c[1], 1):8.1f}" for c in counts)


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("iteration_study: --device cuda but torch.cuda.is_available() is False "
              "(pass --device cpu)", file=sys.stderr)
        return 1
    cols = preconds(args.tp)
    print(f"{'problem':20s} " + "  ".join(f"{p:>8s}" for p, _ in cols)
          + "   (FGMRES iters per Newton, lower+flatter = better)")
    for name, model, data, dt in problems(args.tp, args.device):
        print(format_row(name, row(model, data, dt, cols, args.steps, args.device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
