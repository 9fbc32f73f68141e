"""Wells and heaters: Peaceman model, source-term fields (counterpart of
``thermalporous_tpu/physics/wells.py``).

Source terms are positive INTO the reservoir.  BHP-controlled wells
contribute ``q = WI·λ·(p_bh − p)``; rate-controlled wells a fixed mass rate;
heaters a fixed power.  Each well writes into dense per-cell fields that the
residual consumes directly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from thermalporous_torch.core.grid import Grid


@dataclasses.dataclass(frozen=True)
class Well:
    """One vertical well perforating one or more cells.

    ``control`` is "bhp" (bottom-hole pressure ``p_bh`` [Pa]) or "rate"
    (total mass rate ``rate`` [kg/s], positive = injection).  ``T_inj`` [K]
    marks an injector; None a pure producer.
    """

    cells: tuple[tuple[int, ...], ...]
    control: str = "bhp"
    p_bh: float = 0.0
    rate: float = 0.0
    T_inj: float | None = None
    radius: float = 0.1
    name: str = "well"


@dataclasses.dataclass(frozen=True)
class Heater:
    """A pure energy source over a set of cells."""

    cells: tuple[tuple[int, ...], ...]
    power: float = 0.0  # total [W], split evenly over cells
    name: str = "heater"


def peaceman_well_index(
    kx: float, ky: float, dx: float, dy: float, dz: float, r_w: float
) -> float:
    """Anisotropic Peaceman well index 2π·√(kx·ky)·Δz / ln(r_e / r_w) of a
    vertical well through one cell."""
    a = math.sqrt(ky / kx)
    b = math.sqrt(kx / ky)
    r_e = 0.28 * math.sqrt(a * dx * dx + b * dy * dy) / (a**0.5 + b**0.5)
    if r_e <= r_w:
        raise ValueError(
            f"Peaceman equivalent radius r_e={r_e:.4g} m <= wellbore radius "
            f"r_w={r_w:.4g} m; WI would be negative/singular"
        )
    return 2.0 * math.pi * math.sqrt(kx * ky) * dz / math.log(r_e / r_w)


#: order of the well fields in ``WellFields.packed`` and in the residual
#: kernel's field channels
WELL_FIELDS = ("wi", "pbh", "tinj", "has_tinj", "qrate", "qheat")


@dataclasses.dataclass
class WellFields:
    """Dense per-cell source fields, each of shape ``grid.shape``."""

    wi: torch.Tensor        # Peaceman well index [m³]; 0 = no well
    pbh: torch.Tensor       # bottom-hole pressure [Pa]
    tinj: torch.Tensor      # injection temperature [K]
    has_tinj: torch.Tensor  # 1.0 where T_inj specified, else 0.0
    qrate: torch.Tensor     # fixed mass rate [kg/s per cell]
    qheat: torch.Tensor     # heater power [W per cell]


def well_fields_numpy(
    grid: Grid,
    wells: Sequence[Well] = (),
    heaters: Sequence[Heater] = (),
    kx: np.ndarray | None = None,
    ky: np.ndarray | None = None,
) -> dict[str, np.ndarray]:
    """The six well/heater fields as float64 numpy arrays (keys
    :data:`WELL_FIELDS`).  ``kx``/``ky`` [m²] feed the Peaceman index."""
    shape = grid.shape
    wi = np.zeros(shape)
    wipbh = np.zeros(shape)  # Σ WI_i·p_bh,i, folded to a WI-weighted BHP below
    tinj = np.zeros(shape)
    has_tinj = np.zeros(shape)
    qrate = np.zeros(shape)
    qheat = np.zeros(shape)
    dx, dy = grid.spacing[0], grid.spacing[1]
    dz = grid.dz_well
    for w in wells:
        for cell in w.cells:
            idx = tuple(int(i) for i in cell)
            if w.control == "bhp":
                if kx is None:
                    raise ValueError("BHP wells need permeability fields for WI")
                kx_c = float(np.asarray(kx)[idx])
                ky_c = float(np.asarray(ky)[idx]) if ky is not None else kx_c
                wi_c = peaceman_well_index(kx_c, ky_c, dx, dy, dz, w.radius)
                wi[idx] += wi_c
                wipbh[idx] += wi_c * w.p_bh
            elif w.control == "rate":
                qrate[idx] += w.rate / len(w.cells)
            else:
                raise ValueError(f"unknown well control {w.control!r}")
            if w.T_inj is not None:
                tinj[idx] = w.T_inj
                has_tinj[idx] = 1.0
    for h in heaters:
        for cell in h.cells:
            idx = tuple(int(i) for i in cell)
            qheat[idx] += h.power / len(h.cells)
    pbh = np.divide(wipbh, wi, out=np.zeros_like(wipbh), where=wi > 0)
    return dict(wi=wi, pbh=pbh, tinj=tinj, has_tinj=has_tinj, qrate=qrate,
                qheat=qheat)


def per_well_masks(grid: Grid, wells: Sequence[Well] = (),
                   heaters: Sequence[Heater] = ()) -> dict[str, np.ndarray]:
    """Boolean cell masks per named well/heater (diagnostics only)."""
    masks: dict[str, np.ndarray] = {}
    for w in list(wells) + list(heaters):
        m = masks.setdefault(w.name, np.zeros(grid.shape, dtype=bool))
        for cell in w.cells:
            m[tuple(int(i) for i in cell)] = True
    return masks


def well_rates(model, u: torch.Tensor, data, masks: dict[str, np.ndarray]) -> dict[str, dict]:
    """Per-well report: mass [kg/s] and energy [W] rates at state ``u``,
    positive into the reservoir (injectors +, producers −), summed over each
    well's cells from the model's source fields.  Over a grid decomposition
    (``data.block``; ``u`` the rank's block, ``masks`` whole-grid) each
    well's owned cells are summed and the sums added over the ranks, the
    same report on every rank."""
    q = model.well_sources(u, data.wells).detach()
    block = getattr(data, "block", None)
    if block is None:
        qn = q.cpu().numpy()
        tots = [[qn[c][mask].sum() for c in range(model.nc)] for mask in masks.values()]
    else:
        q = block.owned(q, lead=1)
        sl = tuple(slice(*block.owned_range(a)) for a in range(len(block.shape)))
        part = torch.stack([torch.stack([q[c][torch.as_tensor(m[sl], device=q.device)].sum()
                                         for c in range(model.nc)])
                            for m in masks.values()]) if masks else q.new_zeros((0, model.nc))
        tots = block.mesh.allreduce_sum(part).cpu().numpy()
    out: dict[str, dict] = {}
    for name, t in zip(masks, tots):
        if model.nc == 2:
            out[name] = {"mass_kg_s": float(t[0]), "energy_W": float(t[1])}
        else:
            out[name] = {"water_kg_s": float(t[0]), "oil_kg_s": float(t[2]),
                         "energy_W": float(t[1])}
    return out


def empty_well_fields(grid: Grid, *, dtype: torch.dtype,
                      device: torch.device | str) -> WellFields:
    """Six zero source fields: a problem with no wells or heaters."""
    z = torch.zeros(grid.shape, dtype=dtype, device=device)
    return WellFields(wi=z, pbh=z, tinj=z, has_tinj=z, qrate=z, qheat=z)


def build_well_fields(
    grid: Grid,
    wells: Sequence[Well] = (),
    heaters: Sequence[Heater] = (),
    kx: np.ndarray | None = None,
    ky: np.ndarray | None = None,
    *,
    dtype: torch.dtype,
    device: torch.device | str,
) -> WellFields:
    """Assemble the dense source fields of ``wells`` and ``heaters``."""
    f = well_fields_numpy(grid, wells, heaters, kx=kx, ky=ky)
    return WellFields(**{k: torch.as_tensor(v, dtype=dtype, device=device)
                         for k, v in f.items()})
