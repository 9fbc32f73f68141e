"""Stacked member data of an ensemble, shared by the ensemble step
(``dist/ensemble.py``) and the ensemble adjoint (``solve/adjoint.py``).

Stacked problem data is an :class:`EnsembleData`, never a ``ProblemData``:
``ProblemData`` reads its dimension from its tensor's rank, which a leading
member axis would change.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from thermalporous_torch.models.base import ProblemData
from thermalporous_torch.precond.cpr import CPRConfig


class Blocks(tuple):
    """An ensemble tensor split over devices: contiguous blocks of whole
    members along the leading axis, block d on the d-th device
    (``dist.shard_ensemble``)."""


def members(x) -> list[torch.Tensor]:
    """The members of a stacked tensor or of its :class:`Blocks`, in order
    (views, each on its block's device)."""
    return [m for block in (x if isinstance(x, Blocks) else (x,)) for m in block]


def restack(like, parts: Sequence[torch.Tensor]):
    """``parts`` (one tensor per member) stacked in the layout of ``like``: one
    tensor, or :class:`Blocks` of the same sizes on the same devices."""
    if not isinstance(like, Blocks):
        return torch.stack(list(parts))
    out, at = [], 0
    for block in like:
        out.append(torch.stack(list(parts[at:at + len(block)])).to(block.device))
        at += len(block)
    return Blocks(out)


@dataclasses.dataclass
class EnsembleData:
    """The problem data of E members: ``fields`` is the members'
    ``ProblemData.fields`` stacked, shape ``(E, 2·dim+7, *grid)`` (or its
    :class:`Blocks`).  Members decomposed over a grid mesh share ``block``
    (``dist.sharding.Block``): ``fields`` then stacks this rank's extended
    blocks of them."""

    fields: torch.Tensor | Blocks
    block: object = None

    def __len__(self) -> int:
        return len(members(self.fields))

    def member(self, i: int) -> ProblemData:
        """Member ``i``'s ``ProblemData`` (a decomposed member's
        ``ShardedProblemData``), on its device, in a tensor of its own."""
        fields = members(self.fields)[i].clone()
        if self.block is None:
            return ProblemData(fields)
        from thermalporous_torch.dist.sharding import ShardedProblemData

        return ShardedProblemData(fields, self.block)


def refuse_adaptive(pc_cfg: CPRConfig | None, what: str) -> None:
    """The reference's refusal of a per-member (adaptive) coarsening schedule:
    the members share one multigrid, so its ``level_factors`` must be planned
    beforehand."""
    if pc_cfg is None:
        return
    for g in (pc_cfg.gmg, pc_cfg.gmg_t):
        if g is not None and g.coarsen == "adaptive" and g.level_factors is None:
            raise ValueError(
                f"ensemble {what} need a shared multigrid schedule: plan "
                "level_factors from a representative member (plan_coarsening) "
                "or use geometric coarsening"
            )
