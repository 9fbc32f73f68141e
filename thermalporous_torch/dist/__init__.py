"""Parallel layouts of the simulator (counterpart of ``thermalporous_tpu/dist``):
the ensemble axis.  Grid decomposition over several devices is not ported."""

from thermalporous_torch.dist.ensemble import (
    make_ensemble_step_fn,
    shard_ensemble,
    stack_ensemble,
)

__all__ = ["make_ensemble_step_fn", "shard_ensemble", "stack_ensemble"]
