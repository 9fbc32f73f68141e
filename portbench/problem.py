"""A configuration as it is run: the inputs the benchmark makes from the
seed, and the program's objects built from them through the port's public
API.

The inputs (grid, fields, wells, heaters, physical constants) are made here
and handed to both sides: to the program, which derives its
transmissibilities, well indices and scales from them, and to the plain
reference, which derives them again.  A configuration's field is drawn
from its own ``fields.base_seed``: the steps' Newton and Krylov counts
swing with any change of the field, so a field drawn from the run's seed
would make the work the seed's.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
import pathlib

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def resolved(config: dict, rehearse: bool) -> dict:
    """``config`` with its ``rehearsal`` block applied (a small grid for the
    CPU rehearsal) when ``rehearse`` is set."""
    cfg = copy.deepcopy(config)
    if rehearse:
        for key, value in cfg.get("rehearsal", {}).items():
            if isinstance(value, dict) and isinstance(cfg.get(key), dict):
                cfg[key].update(value)
            else:
                cfg[key] = value
    return cfg


@dataclasses.dataclass
class Inputs:
    """What the benchmark hands to both sides (the fields in the state's
    dtype, on the run's device)."""

    model: str
    shape: tuple[int, ...]
    spacing: tuple[float, ...]
    gravity: float
    depth_top: float
    fields: dict            # kx, ky, kz, phi
    wells: list             # dicts with cells resolved
    heaters: list
    physics: dict
    relperm: dict
    s_init: float


def _load_recipe(root: pathlib.Path, name: str):
    path = root / "portbench" / "fields" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_field_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cells(entry: dict) -> list[tuple[int, ...]]:
    """A well's or heater's cells: ``cells`` as listed, or a vertical
    ``column`` [i, j] over ``k`` = [k0, k1)."""
    if "cells" in entry:
        return [tuple(c) for c in entry["cells"]]
    i, j = entry["column"]
    return [(i, j, k) for k in range(*entry["k"])]


def make_inputs(cfg: dict, device: torch.device, root: pathlib.Path) -> Inputs:
    shape = tuple(cfg["grid"]["shape"])
    spec = cfg["fields"]
    fields = _load_recipe(root, spec["recipe"]).make(spec, shape, device)
    dtype = DTYPES[cfg["dtype"]]
    fields = {k: v.to(dtype).contiguous() for k, v in fields.items()}

    def place(entry):
        return dict(entry, cells=_cells(entry))

    return Inputs(model=cfg["model"], shape=shape, spacing=tuple(cfg["grid"]["spacing"]),
                  gravity=float(cfg["grid"]["gravity"]),
                  depth_top=float(cfg["grid"]["depth_top"]), fields=fields,
                  wells=[place(w) for w in cfg["wells"]],
                  heaters=[place(h) for h in cfg.get("heaters", [])],
                  physics=dict(cfg["physics"]), relperm=dict(cfg.get("relperm", {})),
                  s_init=float(cfg.get("s_init", 0.0)))


@dataclasses.dataclass
class Program:
    """The program's objects for one run."""

    simulator: object
    model: object
    data: object
    time_cfg: object
    t_end: float
    settings: dict          # the resolved solver settings, for the record


def solver_configs(cfg: dict):
    """(NewtonConfig, CPRConfig) of the named preset with the configuration's
    accuracy (Newton rtol, atol, max_iters) pinned and its multigrid
    overrides applied.  The preset is built at its small probe size on the
    CPU only to read its solver settings."""
    from thermalporous_torch.presets import get_case

    s = cfg["solver"]
    case = get_case(s["preset"], device="cpu", **s.get("probe_kwargs", {}))
    newton = dataclasses.replace(case.newton_cfg, **cfg["newton"])
    pc = case.pc_cfg
    if pc is None:
        from thermalporous_torch.precond.cpr import CPRConfig

        pc = CPRConfig()
    gmg = dataclasses.replace(pc.gmg, **s.get("gmg", {}))
    gmg_t = None if pc.gmg_t is None else dataclasses.replace(pc.gmg_t, **s.get("gmg_t", {}))
    return newton, dataclasses.replace(pc, gmg=gmg, gmg_t=gmg_t), case.precond


def build_program(cfg: dict, inp: Inputs, device: torch.device) -> Program:
    from thermalporous_torch.core.grid import Grid
    from thermalporous_torch.models.base import make_problem_data
    from thermalporous_torch.models.singlephase import SinglePhaseModel
    from thermalporous_torch.models.twophase import TwoPhaseModel
    from thermalporous_torch.physics.props import PhysicalParams
    from thermalporous_torch.physics.relperm import CoreyRelPerm
    from thermalporous_torch.physics.wells import Heater, Well
    from thermalporous_torch.solve.timeloop import Simulator, TimeConfig

    grid = Grid(shape=inp.shape, spacing=inp.spacing, gravity=inp.gravity,
                depth_top=inp.depth_top)
    pp = PhysicalParams(**inp.physics)
    if inp.model == "two_phase":
        model = TwoPhaseModel(grid, pp, CoreyRelPerm(**inp.relperm), s_init=inp.s_init)
    elif inp.model == "single_phase":
        model = SinglePhaseModel(grid, pp)
    else:
        raise ValueError(f"unknown model {inp.model!r}")
    wells = [Well(cells=tuple(w["cells"]), control=w["control"], p_bh=w.get("p_bh", 0.0),
                  rate=w.get("rate", 0.0), T_inj=w.get("T_inj"), radius=w["radius"],
                  name=w["name"]) for w in inp.wells]
    heaters = [Heater(cells=tuple(h["cells"]), power=h["power"], name=h["name"])
               for h in inp.heaters]
    f = inp.fields
    dtype = f["kx"].dtype
    data = make_problem_data(grid, pp, kx=f["kx"], ky=f["ky"], kz=f["kz"], phi=f["phi"],
                             wells=wells, heaters=heaters, dtype=dtype, device=device)
    newton, pc, precond = solver_configs(cfg)
    time_cfg = TimeConfig(**cfg["time"])
    sim = Simulator(model, data, precond=precond, pc_cfg=pc, newton_cfg=newton,
                    time_cfg=time_cfg, device=device)
    settings = {"precond": precond, "newton": repr(newton), "pc": repr(sim.pc_cfg),
                "time": repr(time_cfg)}
    return Program(simulator=sim, model=model, data=data, time_cfg=time_cfg,
                   t_end=float(cfg["t_end"]), settings=settings)


def load_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())
