"""The ensemble axis: a parameter study as a batch of independent members
(counterpart of ``thermalporous_tpu/dist/ensemble.py``).

Members share the grid, the model and the solver configuration and differ in
their problem data (permeability, well controls …), their state and their
Δt.  The reference vmaps its jitted step over a leading member axis, and the
vmapped ``while_loop``s mask the members that have converged, so each member's
result and counts are those of its solo run.  Here the step is a loop over the
members through one :func:`~thermalporous_torch.solve.timeloop.make_step_fn`
``advance``: each member's state, stats and kernel launches are exactly its
solo run's, because the step keeps no state between calls (the recycle space
lives inside one Newton solve, and the residual kernel's parameter cache is
keyed by the model).

Stacked problem data is an
:class:`~thermalporous_torch.solve.ensemble_data.EnsembleData`, never a
``ProblemData``: ``ProblemData`` reads its dimension from its tensor's rank,
which a leading member axis would change.

:func:`shard_ensemble` places contiguous blocks of members on a sequence of
devices, members whole on their device (the reference's ``PartitionSpec("e")``
on a mesh axis); there are no collectives, and :func:`make_ensemble_step_fn`'s
step runs each member on the device its tensors are on.

The multigrid's coarsening schedule is shared by all members, so an adaptive
schedule must be planned beforehand from a representative member
(:func:`~thermalporous_torch.precond.cpr.resolve_adaptive_coarsening` on its
first stencil, as the ``Simulator`` does once before its first step).
"""

from __future__ import annotations

from typing import Sequence

import torch

from thermalporous_torch._device import require_cuda
from thermalporous_torch.dist.sharding import GridMesh, NotDecomposedError, refuse_decomposed
from thermalporous_torch.models.base import ProblemData, ThermalModelBase
from thermalporous_torch.precond.cpr import CPRConfig
from thermalporous_torch.solve.ensemble_data import (
    Blocks,
    EnsembleData,
    members,
    refuse_adaptive,
    restack,
)
from thermalporous_torch.solve.newton import NewtonConfig, NewtonStats
from thermalporous_torch.solve.timeloop import make_step_fn


def stack_ensemble(datas: Sequence[ProblemData]) -> EnsembleData:
    """Stack per-member problem data along a new leading ensemble axis
    (whole grids: a member decomposed over ranks raises
    ``NotDecomposedError``)."""
    for d in datas:
        refuse_decomposed(d, "stack_ensemble of a decomposed member")
    return EnsembleData(torch.stack([d.fields for d in datas]))


def make_ensemble_step_fn(
    model: ThermalModelBase,
    precond: str = "cptr",
    newton_cfg: NewtonConfig = NewtonConfig(),
    pc_cfg: CPRConfig | None = None,
    device: torch.device | str = "cuda",
):
    """Build ``advance_e(u_e, dt_e, data_e) -> (u_e, stats_e)``: the implicit
    step of every member.

    ``u_e`` is (E, nc, *grid) (or its :class:`Blocks`), ``dt_e`` an (E,)
    tensor (members may run different Δt; member i steps by
    ``float(dt_e[i])``, so an f32 ``dt_e`` rounds Δt as the reference's f32
    members do), ``data_e`` an :class:`EnsembleData`.  ``u_e`` comes back in
    the layout it was given, ``stats_e`` is a ``NewtonStats`` of (E,) CPU
    tensors.  Tensors live on ``device`` (or, sharded, on devices of its
    type)."""
    refuse_adaptive(pc_cfg, "steps")
    advance = make_step_fn(model, precond, newton_cfg, pc_cfg, device=device)

    def advance_e(u_e, dt_e, data_e: EnsembleData) -> tuple[torch.Tensor | Blocks, NewtonStats]:
        us = members(u_e)
        if len(us) != len(data_e) or len(dt_e) != len(us):
            raise ValueError(f"ensemble sizes differ: u_e {len(us)}, dt_e {len(dt_e)}, "
                             f"data_e {len(data_e)}")
        outs, stats = [], []
        for i, u in enumerate(us):
            u_i, st = advance(u.clone(), float(dt_e[i]), data_e.member(i))
            outs.append(u_i)
            stats.append(st)
        col = lambda name, dtype: torch.tensor([getattr(s, name) for s in stats], dtype=dtype)
        state = us[0].dtype
        return restack(u_e, outs), NewtonStats(
            iters=col("iters", torch.int32), ksp_iters=col("ksp_iters", torch.int32),
            norm0=col("norm0", state), norm=col("norm", state),
            converged=col("converged", torch.bool), failed=col("failed", torch.bool))

    return advance_e


def shard_ensemble(tree, devices: Sequence[torch.device | str]):
    """Place the leading ensemble axis of every tensor in ``tree`` (a tensor,
    an :class:`EnsembleData`, or a list, tuple or dict of them) on
    ``devices``: E/len(devices) whole members per device, in order, as
    :class:`Blocks`.  E must be a multiple of the number of devices."""
    if isinstance(devices, GridMesh):
        raise NotDecomposedError("shard_ensemble over the ranks of a grid mesh: not "
                                 "decomposed over ranks")
    devs = [require_cuda(d) for d in devices]
    if not devs:
        raise ValueError("shard_ensemble needs at least one device")

    def put(x):
        if isinstance(x, EnsembleData):
            return EnsembleData(put(x.fields))
        if isinstance(x, (torch.Tensor, Blocks)):
            full = torch.cat([b.to(devs[0]) for b in x]) if isinstance(x, Blocks) else x
            e = full.shape[0]
            if e % len(devs):
                raise ValueError(f"{e} members do not split evenly over {len(devs)} devices")
            size = e // len(devs)
            return Blocks(full[d * size:(d + 1) * size].to(dev) for d, dev in enumerate(devs))
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        raise TypeError(f"shard_ensemble: cannot place {type(x).__name__}")

    return put(tree)
