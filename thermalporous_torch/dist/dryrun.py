"""The multi-rank dry run (counterpart of ``__graft_entry__.py``
``dryrun_multichip`` / ``_dryrun_impl``): the reference's production
configuration on a grid decomposition, held against the undecomposed run.

Scenario 1 runs a blocked adaptive simulation of a synthetic-SPE10 3D
two-phase case (4·mx × 4·my × 6, seed 7, gravity, two full-height BHP
wells) over an (mx, my) mesh: strength-adaptive coarsening, the K-cycle
degree-4 pressure and V-cycle degree-2 temperature hierarchies with
``replicate_below=64``, the rbgs stage 2, the Appleyard chop,
Eisenstat–Walker forcing, the failure-memory Δt policy and
``block_steps=3``.  It must take the undecomposed run's steps, Newton and
FGMRES counts, and land within 10 Pa, 1e-6 K and 1e-8 of its state.

Scenario 2 runs a two-segment well schedule decomposed (the step must land
on the control boundary), then the same run interrupted after two steps,
checkpointed (the state gathered on rank 0 and written, then read and
sharded on every rank) and resumed: the resumed state must be the
uninterrupted run's bit for bit.

``python -m thermalporous_torch.dist.dryrun --ranks 4 --backend gloo
[--device cpu]`` runs it from the shell and prints the summary as its last
line (JSON).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch
import torch.distributed as tdist

from thermalporous_torch.core.grid import Grid
from thermalporous_torch.data.spe10 import synthetic_spe10
from thermalporous_torch.dist.launch import run_ranks
from thermalporous_torch.dist.sharding import (
    gather_state,
    make_grid_mesh,
    mesh_shape,
    shard_problem_data,
    shard_state,
)
from thermalporous_torch.io.checkpoint import load_checkpoint, save_checkpoint
from thermalporous_torch.models.base import make_problem_data
from thermalporous_torch.models.twophase import TwoPhaseModel
from thermalporous_torch.physics.props import PhysicalParams
from thermalporous_torch.physics.wells import Well, build_well_fields
from thermalporous_torch.precond.cpr import CPRConfig
from thermalporous_torch.precond.gmg import GMGConfig
from thermalporous_torch.solve.newton import NewtonConfig
from thermalporous_torch.solve.timeloop import Simulator, TimeConfig

#: the reference's bands on the state against the undecomposed run: p [Pa],
#: T [K], S_w
BANDS = (10.0, 1e-6, 1e-8)


def _case(shape, dtype, device):
    nx, ny, nz = shape
    pp = PhysicalParams()
    grid = Grid(shape=shape, spacing=(10.0, 10.0, 2.0), gravity=9.81)
    fields = synthetic_spe10(shape=shape, seed=7)
    wells = [
        Well(cells=tuple((0, 0, iz) for iz in range(nz)), control="bhp",
             p_bh=4.0e7, T_inj=420.0),
        Well(cells=tuple((nx - 1, ny - 1, iz) for iz in range(nz)), control="bhp",
             p_bh=1.5e7),
    ]
    data = make_problem_data(grid, pp, kx=fields.kx, kz=fields.kz, phi=fields.phi,
                             wells=wells, dtype=dtype, device=device)
    return grid, fields, TwoPhaseModel(grid, pp), data


def _pc(mesh) -> CPRConfig:
    return CPRConfig(
        gmg=GMGConfig(cycle_type="k", coarsen="adaptive", degree=4, max_coarse_cells=32,
                      mesh=mesh, replicate_below=64),
        gmg_t=GMGConfig(cycle_type="v", coarsen="adaptive", degree=2, max_coarse_cells=32,
                        mesh=mesh, replicate_below=64),
        stage2="rbgs", stage2_sweeps=1)


NEWTON = NewtonConfig(rtol=1e-8, ksp_rtol=1e-6, ksp_maxiter=60, ds_max=0.2, ksp_ew=True)


def _setup(mesh_shape_, dtype, device):
    mx, my = mesh_shape_
    shape = (4 * mx, 4 * my, 6)
    grid, fields, model, data = _case(shape, dtype, device)
    return shape, grid, fields, model, data, model.initial_state(data)


def _run(model, data, u0, mesh, device):
    sim = Simulator(model, data, precond="cptr", newton_cfg=NEWTON, pc_cfg=_pc(mesh),
                    time_cfg=TimeConfig(dt_init=600.0, block_steps=3, fail_frac=0.6,
                                        fail_relax=1.05), device=device)
    # the adaptive schedule must have been baked host-side
    assert sim.pc_cfg.gmg.level_factors is not None
    return sim.run(t_end=3600.0, u0=u0)


def _reference(mesh_shape_, dtype_name: str, device) -> dict:
    """Scenario 1 undecomposed: the steps, counts and final state."""
    _, _, _, model, data, u0 = _setup(mesh_shape_, getattr(torch, dtype_name), device)
    ref = _run(model, data, u0, None, device)
    return dict(steps=ref.steps, newton=ref.total_newton, ksp=ref.total_ksp,
                u=ref.u.cpu().numpy())


def _check(out: dict, ref: dict, mesh_shape_) -> dict:
    """Scenario 1's assertions; its summary line."""
    assert out["steps"] == ref["steps"], f"decomposed steps {out['steps']} != {ref['steps']}"
    assert out["newton"] == ref["newton"], (out["newton"], ref["newton"])
    assert out["ksp"] == ref["ksp"], (out["ksp"], ref["ksp"])
    gaps = [float(abs(out["u"][c] - ref["u"][c]).max()) for c in range(3)]
    for c, (gap, band) in enumerate(zip(gaps, BANDS)):
        assert gap <= band, f"component {c}: gap {gap} > {band}"
    mx, my = mesh_shape_
    print(f"dryrun_multichip: mesh {mx}x{my} over {mx * my} ranks, synthetic-SPE10 3D grid "
          f"{4 * mx}x{4 * my}x6, production config, {out['steps']} adaptive steps, "
          f"newton={out['newton']}, ksp={out['ksp']}, state gaps p/T/S "
          f"{gaps[0]:.3e}/{gaps[1]:.3e}/{gaps[2]:.3e} against the undecomposed run",
          flush=True)
    return dict(steps=out["steps"], newton=out["newton"], ksp=out["ksp"], gaps=gaps)


def _dryrun_impl(mesh, dtype_name: str = "float64") -> dict:
    """Both scenarios decomposed on this rank of ``mesh`` (scenario 2
    asserts here); returns scenario 1's steps, counts and gathered state."""
    dtype = getattr(torch, dtype_name)
    device = mesh.device
    shape, grid, fields, model, data, u0 = _setup(mesh.shape, dtype, device)
    nx, ny, nz = shape
    out = _run(model, shard_problem_data(data, mesh), shard_state(u0, mesh), mesh, device)
    summary = dict(steps=out.steps, newton=out.total_newton, ksp=out.total_ksp,
                   u=gather_state(out.u, mesh).cpu().numpy())

    # ---- scenario 2: a control schedule and a checkpoint/resume, decomposed
    wf0 = data.wells
    wf1 = build_well_fields(
        grid, [Well(cells=tuple((nx - 1, ny - 1, iz) for iz in range(nz)), control="bhp",
                    p_bh=1.2e7)],
        kx=fields.kx, ky=fields.kx, dtype=dtype, device=device)
    t_mid, t_fin = 1800.0, 3600.0
    schedule = [(0.0, wf0), (t_mid, wf1)]
    sim2 = Simulator(model, shard_problem_data(data, mesh), precond="cptr", newton_cfg=NEWTON,
                     pc_cfg=_pc(mesh), device=device,
                     time_cfg=TimeConfig(dt_init=600.0, fail_frac=0.6, fail_relax=1.05))
    su0 = shard_state(u0, mesh)
    full = sim2.run_schedule(schedule, t_end=t_fin, u0=su0)
    assert full.t >= t_fin - 1e-6
    assert any(r.t <= t_mid + 1e-6 < r.t + r.dt + 1e-6 or abs(r.t - t_mid) < 1e-6
               for r in full.records), "no step landed on the control boundary"
    part = sim2.run_schedule(schedule, t_end=t_fin, u0=su0, max_steps=2)
    last = part.records[-1]
    whole = gather_state(part.u, mesh)
    box = [None]
    if mesh.rank == 0:
        box[0] = tempfile.mkdtemp()
        save_checkpoint(os.path.join(box[0], "ck.npz"), whole, part.t,
                        last.next_dt or last.dt, part.steps,
                        meta={"dt_cap": last.dt_cap} if last.dt_cap else None)
    if mesh.size > 1:
        tdist.broadcast_object_list(box, src=0)
    u_ck, t_ck, dt_ck, step_ck, meta_ck = load_checkpoint(os.path.join(box[0], "ck.npz"),
                                                          device=device)
    mesh.barrier()
    if mesh.rank == 0:
        os.remove(os.path.join(box[0], "ck.npz"))
        os.rmdir(box[0])
    resumed = sim2.run_schedule(schedule, t_end=t_fin, u0=shard_state(u_ck, mesh), t0=t_ck,
                                dt0=dt_ck, step0=step_ck, dt_cap0=meta_ck.get("dt_cap"))
    assert part.steps + resumed.steps == full.steps, (part.steps, resumed.steps, full.steps)
    assert torch.equal(resumed.u, full.u), "resumed state differs from the uninterrupted run"
    summary["schedule"] = dict(steps=full.steps, resumed_at=part.steps)
    if mesh.rank == 0:
        print(f"dryrun_multichip: decomposed run_schedule (2 control segments, boundary-"
              f"exact switch) + mid-run checkpoint resume at step {part.steps}: resumed "
              f"state bit-identical to the uninterrupted run ({full.steps} steps total)",
              flush=True)
    return summary


def dryrun_multichip(n_ranks: int, device: str = "cuda", backend: str | None = None,
                     dtype: torch.dtype = torch.float64) -> dict:
    """Both scenarios over ``n_ranks`` ranks (one process each, over
    ``backend``: "gloo", or "nccl" with a card per rank), each rank's
    tensors on ``device``, while this process runs the undecomposed
    reference of scenario 1; one rank runs in this process with no process
    group.  Returns the summary; a failed assertion on any rank raises."""
    dtype_name = str(dtype).removeprefix("torch.")
    shape = mesh_shape(n_ranks)
    if n_ranks == 1:
        out = _dryrun_impl(make_grid_mesh(1, backend=backend, device=device), dtype_name)
        ref = _reference(shape, dtype_name, device)
    else:
        if backend is None:
            raise ValueError("dryrun_multichip: name the backend (\"gloo\" or \"nccl\")")
        outs, ref = run_ranks(_dryrun_impl, n_ranks, dtype_name, backend=backend,
                              device=device,
                              meanwhile=lambda: _reference(shape, dtype_name, device))
        out = outs[0]
    return dict(run=_check(out, ref, shape), schedule=out["schedule"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    out = dryrun_multichip(a.ranks, a.device, a.backend)
    print(json.dumps({"mesh": mesh_shape(a.ranks), **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
