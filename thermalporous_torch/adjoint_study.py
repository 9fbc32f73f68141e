"""Adjoint sensitivity study (counterpart of ``examples/adjoint_study.py``,
with its case and output lines): exact gradients of a heat-delivery
objective with respect to the transmissibility field, porosity and the
well fields, through the whole implicit simulation.

    python -m thermalporous_torch.adjoint_study [--device cpu] [--tp] [--ascent N]

The case: 24×20 cells of 10 m, lognormal permeability (seed 11), a hot
BHP injector and a BHP producer, the day-scale five-step schedule; J is the
mean temperature of the mid-field block on the injector→producer path.  It
prints J, the adjoint FGMRES total, the gradients' maxima and the most
sensitive x-face, one central-difference probe along a random
transmissibility direction against the adjoint's, and ``--ascent`` steps
of steepest ascent on log-transmissibility (J should increase).  f64; runs
on the card (``--device cuda``, the default) unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m thermalporous_torch.adjoint_study",
                                description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the study runs (default: the CUDA device)")
    p.add_argument("--tp", action="store_true", help="two-phase model")
    p.add_argument("--ascent", type=int, default=3,
                   help="steepest-ascent iterations on log-T (0 = skip)")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("adjoint_study: --device cuda but torch.cuda.is_available() is False "
              "(pass --device cpu)", file=sys.stderr)
        return 1

    from thermalporous_torch.core import Grid
    from thermalporous_torch.models import SinglePhaseModel, TwoPhaseModel, make_problem_data
    from thermalporous_torch.models.base import ProblemData
    from thermalporous_torch.physics import PhysicalParams, Well
    from thermalporous_torch.solve import (
        NewtonConfig,
        Simulator,
        adjoint_gradients,
        record_trajectory,
    )

    dev, f64 = torch.device(args.device), torch.float64
    pp = PhysicalParams()
    shape = (24, 20)
    g = Grid(shape=shape, spacing=(10.0, 10.0), thickness=5.0)
    rng = np.random.default_rng(11)
    k = 1e-13 * np.exp(1.0 * rng.standard_normal(shape))
    wells = [Well(cells=((2, 2),), control="bhp", p_bh=3.0e7, T_inj=420.0),
             Well(cells=((21, 17),), control="bhp", p_bh=1.0e7)]
    data = make_problem_data(g, pp, kx=k, phi=0.2, wells=wells, dtype=f64, device=dev)
    model = (TwoPhaseModel if args.tp else SinglePhaseModel)(g, pp)
    # day-scale schedule: the thermal front needs days to sweep mid-field on
    # 10 m cells (hour-scale runs leave J numerically flat)
    dts = [21600.0, 43200.0, 86400.0, 172800.0, 345600.0]

    def terminal(u, d):
        # heat swept into the mid-field block on the injector→producer path
        return torch.mean(u[1, 4:12, 3:10])

    ncfg = NewtonConfig(rtol=1e-11, ksp_rtol=1e-9, ksp_maxiter=120)

    def run(d):
        sim = Simulator(model, d, precond="cptr", newton_cfg=ncfg, device=dev)
        return record_trajectory(sim, model.initial_state(d), dts)

    def evaluate(d):
        return adjoint_gradients(model, d, run(d), dts, terminal=terminal, rtol=1e-10,
                                 maxiter=240)

    def with_tgeo0(d, t0):
        fields = d.fields.clone()
        fields[0] = t0
        return ProblemData(fields)

    res = evaluate(data)
    gt = res.grad_data.tgeo[0]
    print(f"# {model.__class__.__name__} {shape}, {len(dts)} steps, "
          f"J = mean T over the mid-field sweep region")
    print(f"J           = {float(res.value):.6f} K")
    print(f"adjoint KSP = {res.ksp_iters} iterations total (converged={res.converged})")
    print(f"|dJ/dT_geo| max {float(gt.abs().max()):.3e}, "
          f"|dJ/dphi| max {float(res.grad_data.phi.abs().max()):.3e}")
    iy, ix = np.unravel_index(int(torch.argmax(gt.abs())), shape)
    print(f"most sensitive x-face: cell ({iy},{ix}) — on the injector→producer path")

    # one finite-difference probe as a live correctness check (the initial
    # state does not depend on tgeo, so the probe is consistent with it)
    xi = torch.as_tensor(rng.standard_normal(shape), dtype=f64, device=dev)
    d_tg = data.tgeo[0] * xi
    eps = 1e-4

    def j_of(d):
        return float(terminal(run(d)[-1], d))

    fd = (j_of(with_tgeo0(data, data.tgeo[0] + eps * d_tg))
          - j_of(with_tgeo0(data, data.tgeo[0] - eps * d_tg))) / (2 * eps)
    ad = float(torch.sum(gt * d_tg))
    print(f"FD probe: adjoint {ad:.6e} vs central-difference {fd:.6e} "
          f"(rel err {abs(ad - fd) / max(abs(fd), 1e-300):.2e})")

    # close the loop: steepest ascent on log-transmissibility
    for it in range(args.ascent):
        g_log = res.grad_data.tgeo[0] * data.tgeo[0]      # chain rule to log-T
        step = 0.5 / float(g_log.abs().max())
        data = with_tgeo0(data, data.tgeo[0] * torch.exp(step * g_log))
        res = evaluate(data)
        print(f"ascent {it + 1}: J = {float(res.value):.6f} K")
    return 0


if __name__ == "__main__":
    sys.exit(main())
