"""Parallel layouts of the simulator (counterpart of ``thermalporous_tpu/dist``):
the grid decomposition over the ranks of a ``torch.distributed`` group
(``sharding.py``, ``halo.py``; the multi-rank dry run in ``dryrun.py``) and
the ensemble axis (``ensemble.py``)."""

from thermalporous_torch.dist.ensemble import (
    gather_ensemble,
    make_ensemble_step_fn,
    shard_ensemble,
    stack_ensemble,
)
from thermalporous_torch.dist.sharding import (
    field_spec,
    gather_state,
    make_grid_mesh,
    replicated,
    shard_problem_data,
    shard_state,
    state_spec,
)

__all__ = ["make_grid_mesh", "state_spec", "field_spec", "shard_state",
           "shard_problem_data", "replicated", "gather_state",
           "make_ensemble_step_fn", "shard_ensemble", "stack_ensemble", "gather_ensemble"]
