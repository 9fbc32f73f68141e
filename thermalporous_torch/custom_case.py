"""A case built from scratch through the library's API (counterpart of
``examples/custom_case.py``, with its case and output lines).

    python -m thermalporous_torch.custom_case [--days D] [--device cpu]

A five-spot-like pattern on a heterogeneous 48×48 grid (lognormal
permeability, seed 5): a rate-controlled hot injector at the centre, four BHP
producers near the corners and a heater; two-phase dead-oil physics with
Corey relative permeabilities; CPTR-preconditioned Newton–FGMRES under the
adaptive Δt controller.  It prints a line per step, the convergence summary
and each well's rates.  f64; runs on the card (``--device cuda``, the
default) unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m thermalporous_torch.custom_case",
                                description=__doc__.splitlines()[0])
    p.add_argument("--days", type=float, default=30.0, help="simulated days")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the case runs (default: the CUDA device)")
    return p


def build(device: torch.device | str):
    """The case: (model, data, wells, heaters, its Simulator) on ``device``, f64."""
    from thermalporous_torch import Grid, PhysicalParams
    from thermalporous_torch.models import TwoPhaseModel, make_problem_data
    from thermalporous_torch.physics import CoreyRelPerm, Heater, Well
    from thermalporous_torch.solve import NewtonConfig, Simulator, TimeConfig

    # geometry and petrophysics
    n = 48
    grid = Grid(shape=(n, n), spacing=(8.0, 8.0), thickness=6.0)
    rng = np.random.default_rng(5)
    kx = 3e-13 * np.exp(0.8 * rng.standard_normal(grid.shape))

    # a rate injector at the centre, BHP producers near the corners, a heater
    c = n // 2
    wells = [
        Well(cells=((c, c),), control="rate", rate=4.0, T_inj=430.0, name="INJ"),
        Well(cells=((1, 1),), control="bhp", p_bh=1.2e7, name="P_SW"),
        Well(cells=((1, n - 2),), control="bhp", p_bh=1.2e7, name="P_NW"),
        Well(cells=((n - 2, 1),), control="bhp", p_bh=1.2e7, name="P_SE"),
        Well(cells=((n - 2, n - 2),), control="bhp", p_bh=1.2e7, name="P_NE"),
    ]
    heaters = [Heater(cells=((c, c // 2),), power=2.0e5, name="HEAT")]

    pp = PhysicalParams()
    data = make_problem_data(grid, pp, kx=kx, phi=0.22, wells=wells, heaters=heaters,
                             dtype=torch.float64, device=device)
    relperm = CoreyRelPerm(s_wr=0.1, s_or=0.15, n_w=2.0, n_o=2.0)
    model = TwoPhaseModel(grid, pp, relperm=relperm, s_init=0.15)
    sim = Simulator(model, data, precond="cptr", newton_cfg=NewtonConfig(ksp_maxiter=80),
                    time_cfg=TimeConfig(dt_init=900.0, dt_max=3 * 86400.0), device=device)
    return model, data, wells, heaters, sim


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("custom_case: --device cuda but torch.cuda.is_available() is False "
              "(pass --device cpu)", file=sys.stderr)
        return 1

    from thermalporous_torch.physics import per_well_masks, well_rates
    from thermalporous_torch.utils import convergence_summary

    model, data, wells, heaters, sim = build(args.device)
    result = sim.run(t_end=args.days * 86400.0, verbose=True)

    print("\nconvergence:", convergence_summary(result.records))
    print("well rates (positive = into reservoir):")
    masks = per_well_masks(model.grid, wells, heaters)
    for name, rec in well_rates(model, result.u, data, masks).items():
        print(f"  {name:6s}", {k: round(v, 4) for k, v in rec.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
