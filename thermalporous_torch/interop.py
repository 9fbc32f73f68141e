"""Carry problem data and states across from plain numpy arrays.

Used to feed the port and the JAX package identical inputs: a caller takes
the JAX ``ProblemData`` fields and states as numpy arrays
(``np.asarray(...)``) and builds the torch counterparts here.  This module
needs no JAX.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from thermalporous_torch.models.base import ProblemData


def problem_data_from_numpy(
    tgeo: Sequence[np.ndarray],
    tcond: Sequence[np.ndarray],
    phi: np.ndarray,
    wi: np.ndarray,
    pbh: np.ndarray,
    tinj: np.ndarray,
    has_tinj: np.ndarray,
    qrate: np.ndarray,
    qheat: np.ndarray,
    *,
    dtype: torch.dtype,
    device: torch.device | str,
) -> ProblemData:
    """The torch :class:`ProblemData` of the given per-axis face
    transmissibilities, porosity and the six well fields (each of the grid's
    shape, in the reference's full-shape face layout)."""
    parts = [*tgeo, *tcond, phi, wi, pbh, tinj, has_tinj, qrate, qheat]
    stacked = np.stack([np.asarray(p, dtype=np.float64) for p in parts])
    return ProblemData(torch.as_tensor(stacked, dtype=dtype, device=device))


def state_from_numpy(u: np.ndarray, *, dtype: torch.dtype,
                     device: torch.device | str) -> torch.Tensor:
    """A state (nc, *grid) as a contiguous tensor."""
    return torch.as_tensor(np.array(u), dtype=dtype,
                           device=device).contiguous()


def state_to_numpy(u: torch.Tensor) -> np.ndarray:
    return u.detach().cpu().numpy()
