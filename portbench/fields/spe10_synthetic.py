"""SPE10-like fields (the recipe of ``thermalporous_torch/data/spe10.py:
synthetic_spe10``, drawn on the card with torch's generator): a smooth
lognormal upper section (σ(log10 k) = 1 about 1.5 log10 mD), a channelized
lower section (sinuous sand channels about 4 orders more permeable than a
−2 log10 mD background), ``kz = kz_frac·kx``, porosity linear in
log-permeability, clipped to [0.01, 0.35].  The channels of every layer
are drawn in one call, the Gaussian fields by one FFT each."""

from __future__ import annotations

import math

import torch

MD_TO_M2 = 9.869233e-16


def smooth_gaussian(shape, corr, gen, device) -> torch.Tensor:
    """Stationary Gaussian field with per-axis correlation lengths (cells):
    FFT-filtered white noise, centred, scaled to unit variance."""
    noise = torch.randn(shape, generator=gen, device=device, dtype=torch.float64)
    filt = torch.ones((), dtype=torch.float64, device=device)
    for axis, (n, lc) in enumerate(zip(shape, corr)):
        k = torch.fft.fftfreq(n, dtype=torch.float64, device=device)
        view = [1] * len(shape)
        view[axis] = n
        filt = filt * torch.exp(-0.5 * (k * lc * 2 * math.pi) ** 2).reshape(view)
    field = torch.fft.ifftn(torch.fft.fftn(noise) * filt).real
    field = field - field.mean()
    return field / (field.std(correction=0) + 1e-30)


def channel_masks(nx, ny, layers, n_ch, width, amplitude, wavelength, gen, device):
    """(nx, ny, layers) masks of ``n_ch`` sinuous channels a layer running
    along y."""
    u = torch.rand((4, layers, n_ch), generator=gen, device=device, dtype=torch.float64)
    x0 = u[0] * nx
    phase = u[1] * 2 * math.pi
    wl = wavelength * (0.7 + 0.7 * u[2])
    w = width * (0.7 + 0.6 * u[3])
    y = torch.arange(ny, dtype=torch.float64, device=device)
    path = x0[..., None] + amplitude * torch.sin(2 * math.pi * y / wl[..., None] + phase[..., None])
    xs = torch.arange(nx, dtype=torch.float64, device=device)
    inside = (xs[None, None, :, None] - path[:, :, None, :]).abs() <= (w / 2)[..., None, None]
    return inside.any(dim=1).permute(1, 2, 0)


def make(spec: dict, shape: tuple[int, ...], device: torch.device) -> dict:
    nx, ny, nz = shape
    gen = torch.Generator(device=device).manual_seed(int(spec["base_seed"]))
    n_top = int(round(spec["upper_frac"] * nz))
    logk = torch.empty(shape, dtype=torch.float64, device=device)
    if n_top > 0:
        g = smooth_gaussian((nx, ny, n_top), (8.0, 12.0, 2.0), gen, device)
        logk[:, :, :n_top] = 1.5 + g
    nun = nz - n_top
    if nun > 0:
        g = smooth_gaussian((nx, ny, nun), (4.0, 8.0, 1.0), gen, device)
        mask = channel_masks(nx, ny, nun, max(2, nx // 15), max(3.0, nx / 12.0), nx / 6.0,
                             max(ny / 2.5, 20.0), gen, device)
        logk[:, :, n_top:] = torch.where(mask, 2.5 + 0.6 * g, -2.0 + 0.8 * g)
    kx = 10.0 ** logk * MD_TO_M2
    lo, hi = logk.min(), logk.max()
    phi = torch.clamp(0.05 + 0.30 * (logk - lo) / torch.clamp(hi - lo, min=1e-9), 0.01, 0.35)
    return dict(kx=kx, ky=kx.clone(), kz=float(spec["kz_frac"]) * kx, phi=phi)
