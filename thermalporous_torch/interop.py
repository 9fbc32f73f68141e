"""Carry problem data, states, configurations and whole cases across from
plain numpy arrays and dicts.

Used to feed the port and the JAX package identical inputs: a caller takes
the JAX ``ProblemData`` fields and states as numpy arrays
(``np.asarray(...)``) and its configuration dataclasses as dicts
(``dataclasses.asdict``), and builds the torch counterparts here.  A field
that the port lacks is accepted only at the reference's default.  This
module needs no JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from thermalporous_torch.core.grid import Grid
from thermalporous_torch.models.base import ProblemData
from thermalporous_torch.models.singlephase import SinglePhaseModel
from thermalporous_torch.models.twophase import TwoPhaseModel
from thermalporous_torch.physics.props import PhysicalParams
from thermalporous_torch.physics.relperm import CoreyRelPerm
from thermalporous_torch.precond.cpr import CPRConfig
from thermalporous_torch.precond.gmg import GMGConfig
from thermalporous_torch.solve.newton import NewtonConfig
from thermalporous_torch.solve.timeloop import TimeConfig

#: the reference's configuration fields that the port lacks, at the
#: reference's defaults (a dict may carry them only at these values)
UNPORTED_DEFAULTS = {
    GMGConfig: dict(use_pallas=False),
    CPRConfig: dict(stage2_pallas=False),
    NewtonConfig: {},
    TimeConfig: {},
}


def _tuples(v):
    """Lists (as dicts of the reference may carry them) back to tuples."""
    if isinstance(v, (list, tuple)):
        return tuple(_tuples(x) for x in v)
    return v


def config_from_dict(cls, d: dict | None):
    """The port's configuration ``cls`` (GMGConfig, CPRConfig, NewtonConfig
    or TimeConfig) from ``dataclasses.asdict`` of the reference's; None
    stays None.  Raises ``ValueError`` on a field the port lacks that is
    set away from the reference's default."""
    if d is None:
        return None
    own = {f.name for f in dataclasses.fields(cls)}
    unported = UNPORTED_DEFAULTS[cls]
    kw = {}
    for key, val in d.items():
        if key in own:
            if key in ("gmg", "gmg_t"):
                val = config_from_dict(GMGConfig, val)
            kw[key] = _tuples(val)
        elif key in unported and val == unported[key]:
            continue
        else:
            raise ValueError(f"{cls.__name__}.{key}={val!r}: not ported")
    return cls(**kw)


def case_from_numpy(
    *,
    model: str = "TwoPhaseModel",
    grid: dict,
    params: dict,
    relperm: dict | None = None,
    s_init: float | None = None,
    data: dict,
    newton: dict,
    pc: dict | None,
    time: dict,
    t_end: float,
    dtype: torch.dtype,
    device: torch.device | str,
    name: str = "case",
    precond: str = "cptr",
):
    """A port :class:`~thermalporous_torch.presets.Case` of a case given as
    plain inputs: ``model``, the class name of the reference's model
    (``"TwoPhaseModel"`` or ``"SinglePhaseModel"``); ``dataclasses.asdict``
    of the reference's ``Grid``, ``PhysicalParams``, ``CoreyRelPerm`` (two
    phases only), ``NewtonConfig``, ``CPRConfig`` and ``TimeConfig``;
    ``s_init`` (two phases only); and ``data`` with the reference's
    ``ProblemData`` fields as numpy arrays (keys ``tgeo``, ``tcond``
    (sequences), ``phi``, ``wi``, ``pbh``, ``tinj``, ``has_tinj``,
    ``qrate``, ``qheat``)."""
    from thermalporous_torch.presets import Case

    g = Grid(**grid)
    pp = PhysicalParams(**params)
    if model == "TwoPhaseModel":
        tmodel = TwoPhaseModel(g, pp, CoreyRelPerm(**relperm), s_init=s_init)
    elif model == "SinglePhaseModel":
        tmodel = SinglePhaseModel(g, pp)
    else:
        raise ValueError(f"unknown model {model!r}")
    pdata = problem_data_from_numpy(
        data["tgeo"], data["tcond"], data["phi"], data["wi"], data["pbh"],
        data["tinj"], data["has_tinj"], data["qrate"], data["qheat"],
        dtype=dtype, device=device)
    return Case(name=name, description=f"{name} (carried across)", model=tmodel,
                data=pdata, time_cfg=config_from_dict(TimeConfig, time),
                newton_cfg=config_from_dict(NewtonConfig, newton), t_end=float(t_end),
                precond=precond, pc_cfg=config_from_dict(CPRConfig, pc))


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


def problem_data_to_numpy(data: ProblemData) -> dict:
    """The fields of a :class:`ProblemData` (or of a gradient of one, such as
    ``AdjointResult.grad_data``) as numpy arrays under the reference's
    names: ``tgeo`` and ``tcond`` (tuples, one per axis), ``phi`` and the six
    well fields (``wi``, ``pbh``, ``tinj``, ``has_tinj``, ``qrate``,
    ``qheat``)."""
    w = data.wells
    a = lambda x: x.detach().cpu().numpy()
    return dict(tgeo=tuple(a(x) for x in data.tgeo), tcond=tuple(a(x) for x in data.tcond),
                phi=a(data.phi), wi=a(w.wi), pbh=a(w.pbh), tinj=a(w.tinj),
                has_tinj=a(w.has_tinj), qrate=a(w.qrate), qheat=a(w.qheat))


def ensemble_data_to_numpy(data_e) -> dict:
    """The stacked fields of an ``EnsembleData`` (or of its gradient, such as
    ``ensemble_adjoint_gradients``'s ``grad_data``) as numpy arrays under the
    reference's names, each with the leading member axis, as the reference's
    ``stack_ensemble`` stacks its leaves."""
    parts = [problem_data_to_numpy(data_e.member(i)) for i in range(len(data_e))]
    out = {}
    for name, leaf in parts[0].items():
        if isinstance(leaf, tuple):
            out[name] = tuple(np.stack([p[name][a] for p in parts]) for a in range(len(leaf)))
        else:
            out[name] = np.stack([p[name] for p in parts])
    return out


def state_from_numpy(u: np.ndarray, *, dtype: torch.dtype,
                     device: torch.device | str) -> torch.Tensor:
    """A state (nc, *grid) as a contiguous tensor."""
    return torch.as_tensor(np.array(u), dtype=dtype,
                           device=device).contiguous()


def state_to_numpy(u: torch.Tensor) -> np.ndarray:
    return u.detach().cpu().numpy()
