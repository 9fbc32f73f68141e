"""Structured grids and TPFA geometry (counterpart of ``thermalporous_tpu/core/grid.py``).

Arrays are indexed ``[ix, iy]`` in 2D and ``[ix, iy, iz]`` in 3D; gravity acts
along the last axis of a 3D grid.  The state is one tensor ``u`` of shape
``(nc, *grid.shape)``: component 0 = pressure [Pa], 1 = temperature [K],
2 = water saturation [-] (two-phase).

Face arrays use the FULL-shape layout: entry i along an axis holds the face
between cells i and i+1, and the last slice is zero (no-flow boundary).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Grid:
    """Static description of a structured grid.

    Attributes:
      shape: cells per axis — ``(nx, ny)`` or ``(nx, ny, nz)``.
      spacing: cell size per axis in metres.
      thickness: out-of-plane thickness for 2D grids [m].
      gravity: gravitational acceleration [m/s²] along the last axis of a 3D
        grid (0 disables gravity; 2D grids ignore it).
      depth_top: depth of the top face of the grid [m] (3D only).
    """

    shape: tuple[int, ...]
    spacing: tuple[float, ...]
    thickness: float = 1.0
    gravity: float = 0.0
    depth_top: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(n) for n in self.shape))
        object.__setattr__(self, "spacing", tuple(float(s) for s in self.spacing))
        if len(self.shape) not in (2, 3):
            raise ValueError(f"Grid must be 2D or 3D, got shape {self.shape}")
        if len(self.spacing) != len(self.shape):
            raise ValueError("spacing must have one entry per axis")

    @property
    def dim(self) -> int:
        return len(self.shape)

    @property
    def ncells(self) -> int:
        return math.prod(self.shape)

    @property
    def cell_volume(self) -> float:
        v = math.prod(self.spacing)
        if self.dim == 2:
            v *= self.thickness
        return v

    def face_area(self, axis: int) -> float:
        """Area of a cell face normal to ``axis``."""
        sizes = list(self.spacing)
        if self.dim == 2:
            sizes.append(self.thickness)
        del sizes[axis]
        return math.prod(sizes)

    @property
    def dz_well(self) -> float:
        """Perforation length of a vertical well through one cell."""
        return self.spacing[2] if self.dim == 3 else self.thickness

    def cell_depths(self, dtype: torch.dtype, device: torch.device | str) -> torch.Tensor | None:
        """Depth of each cell centre, shape ``grid.shape`` (None in 2D)."""
        if self.dim == 2 or self.gravity == 0.0:
            return None
        nz = self.shape[2]
        dz = self.spacing[2]
        z = self.depth_top + (torch.arange(nz, dtype=dtype, device=device) + 0.5) * dz
        return z.expand(self.shape)

    def cell_centers(self, dtype: torch.dtype = torch.float64,
                     device: torch.device | str = "cuda") -> tuple[torch.Tensor, ...]:
        """Per-axis cell-centre coordinates [m], one 1D tensor per axis."""
        return tuple((torch.arange(n, dtype=dtype, device=device) + 0.5) * d
                     for n, d in zip(self.shape, self.spacing))


def _narrow(x: torch.Tensor, axis: int, start: int, stop: int) -> torch.Tensor:
    return x.narrow(axis, start, stop - start)


def harmonic_face_transmissibility(
    grid: Grid, coeff_per_axis: Sequence[torch.Tensor]
) -> tuple[torch.Tensor, ...]:
    """TPFA face transmissibilities T_f = A·2·k_L·k_R / ((k_L + k_R)·Δ).

    Returns one full-shape tensor per axis (zero on the last slice, and zero
    on faces between two impermeable cells).
    """
    out = []
    for axis in range(grid.dim):
        k = coeff_per_axis[axis]
        n = grid.shape[axis]
        kl = _narrow(k, axis, 0, n - 1)
        kr = _narrow(k, axis, 1, n)
        area = grid.face_area(axis)
        delta = grid.spacing[axis]
        denom = (kl + kr) * delta
        pos = denom > 0.0
        tf = torch.where(pos, area * 2.0 * kl * kr / torch.where(pos, denom, 1.0), 0.0)
        pad = torch.zeros_like(_narrow(k, axis, 0, 1))
        out.append(torch.cat([tf, pad], dim=axis))
    return tuple(out)


def shift_minus(v: torch.Tensor, spatial_axis: int, lead: int = 1) -> torch.Tensor:
    """``out[i] = v[i+1]`` along the spatial axis, zero at the last slice."""
    axis = lead + spatial_axis
    n = v.shape[axis]
    zero = torch.zeros_like(_narrow(v, axis, 0, 1))
    return torch.cat([_narrow(v, axis, 1, n), zero], dim=axis)


def shift_plus(v: torch.Tensor, spatial_axis: int, lead: int = 1) -> torch.Tensor:
    """``out[i] = v[i-1]`` along the spatial axis, zero at the first slice."""
    axis = lead + spatial_axis
    n = v.shape[axis]
    zero = torch.zeros_like(_narrow(v, axis, 0, 1))
    return torch.cat([zero, _narrow(v, axis, 0, n - 1)], dim=axis)


def neighbor_plus(u: torch.Tensor, spatial_axis: int, lead: int = 1) -> torch.Tensor:
    """``out[i] = u[i+1]``, EDGE-padded at the last slice (the phantom
    neighbour of the last cell is the cell itself, so property correlations
    stay finite; its face transmissibility is zero)."""
    axis = lead + spatial_axis
    n = u.shape[axis]
    return torch.cat([_narrow(u, axis, 1, n), _narrow(u, axis, n - 1, n)], dim=axis)


def divergence_add(
    res: torch.Tensor, flux: torch.Tensor, spatial_axis: int, lead: int = 1
) -> torch.Tensor:
    """Add +flux[i] to cell i and −flux[i] to cell i+1."""
    return res + flux - shift_plus(flux, spatial_axis, lead=lead)
