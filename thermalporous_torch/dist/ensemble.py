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
step runs each member on the device its tensors are on.  Over the ranks of a
:class:`~thermalporous_torch.dist.sharding.GridMesh` it gives each rank its
E/R whole members (:func:`gather_ensemble` puts them back together).

Members may instead each be decomposed over a grid mesh
(:func:`stack_ensemble` of ``shard_problem_data``'s blocks): every rank then
stacks its blocks of every member, and the step and the ensemble adjoint run
member by member through the decomposed step and sweep, each member bitwise
its solo decomposed run.

The multigrid's coarsening schedule is shared by all members, so an adaptive
schedule must be planned beforehand from a representative member
(:func:`~thermalporous_torch.precond.cpr.resolve_adaptive_coarsening` on its
first stencil, as the ``Simulator`` does once before its first step).
"""

from __future__ import annotations

from typing import Sequence

import torch

from thermalporous_torch._device import require_cuda
from thermalporous_torch.dist.sharding import GridMesh
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
    """Stack per-member problem data along a new leading ensemble axis:
    whole grids, or this rank's blocks of members decomposed the same way
    (the result carries their ``block``)."""
    blocks = [getattr(d, "block", None) for d in datas]
    blk = blocks[0]
    for b in blocks[1:]:
        if (b is None) != (blk is None) or (blk is not None and (
                b.mesh is not blk.mesh or b.shape != blk.shape or b.bounds != blk.bounds)):
            raise ValueError("stack_ensemble: the members are not decomposed alike")
    return EnsembleData(torch.stack([d.fields for d in datas]), blk)


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


def shard_ensemble(tree, devices: Sequence[torch.device | str] | GridMesh):
    """Place the leading ensemble axis of every tensor in ``tree`` (a tensor,
    an :class:`EnsembleData`, or a list, tuple or dict of them) on
    ``devices``: E/len(devices) whole members per device, in order, as
    :class:`Blocks`.  E must be a multiple of the number of devices.  Over
    the R ranks of a :class:`GridMesh`: this rank's E/R whole members, in
    order (members ``rank·E/R`` on), on the mesh's device, as plain stacked
    tensors; no collective, and no member's solve takes one."""
    if isinstance(devices, GridMesh):
        mesh = devices
        return _map_tree(tree, lambda x: _split(_whole(x, mesh.device), mesh.size)[mesh.rank]
                         .to(mesh.device).contiguous())
    devs = [require_cuda(d) for d in devices]
    if not devs:
        raise ValueError("shard_ensemble needs at least one device")
    return _map_tree(tree, lambda x: Blocks(
        part.to(dev) for part, dev in zip(_split(_whole(x, devs[0]), len(devs)), devs)))


def _whole(x, device) -> torch.Tensor:
    """A stacked tensor, or its :class:`Blocks` put together on ``device``."""
    return torch.cat([b.to(device) for b in x]) if isinstance(x, Blocks) else x


def _split(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """``x``'s members in ``n`` contiguous blocks of E/n."""
    e = x.shape[0]
    if e % n:
        raise ValueError(f"{e} members do not split evenly over {n} devices or ranks")
    return list(x.split(e // n))


def _map_tree(tree, fn):
    """``fn`` of every tensor (or :class:`Blocks`) of ``tree``: a tensor, an
    :class:`EnsembleData`, or a list, tuple or dict of them."""
    if isinstance(tree, EnsembleData):
        return EnsembleData(_map_tree(tree.fields, fn))
    if isinstance(tree, (torch.Tensor, Blocks)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn) for v in tree)
    raise TypeError(f"shard_ensemble: cannot place {type(tree).__name__}")


def gather_ensemble(tree, mesh: GridMesh):
    """Every rank's members of :func:`shard_ensemble` over ``mesh`` put back
    together, on every rank, in order (a collective: every rank calls)."""
    return _map_tree(tree, lambda x: torch.cat(mesh.all_gather(x)))
