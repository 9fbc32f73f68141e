"""Independent lognormal permeability per cell, ``k_mean·exp(sigma·N(0,1))``,
``kz = kz_frac·k``, uniform porosity: the recipe of
``presets.sp_geothermal_3d``, drawn with torch's generator."""

from __future__ import annotations

import torch


def make(spec: dict, shape: tuple[int, ...], device: torch.device) -> dict:
    gen = torch.Generator(device=device).manual_seed(int(spec["base_seed"]))
    z = torch.randn(shape, generator=gen, device=device, dtype=torch.float64)
    k = float(spec["k_mean"]) * torch.exp(float(spec["sigma"]) * z)
    return dict(kx=k, ky=k.clone(), kz=float(spec["kz_frac"]) * k,
                phi=torch.full(shape, float(spec["phi"]), dtype=torch.float64, device=device))
