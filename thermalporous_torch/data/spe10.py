"""SPE10 model-2 permeability/porosity: loader and synthetic generator
(counterpart of ``thermalporous_tpu/data/spe10.py``, numpy only).

The SPE10 model-2 dataset has 60×220×85 cells (dx = 20 ft, dy = 10 ft,
dz = 2 ft): smooth Tarbert layers on top of a channelized Upper Ness, with
a permeability contrast of 10⁶–10⁸.  The dataset is not redistributable, so
beside the standard-format parser there is a deterministic synthetic
generator of the same statistical character.  For the same ``shape`` and
``seed`` it gives the reference's arrays bit for bit.

Arrays are ``(nx, ny, nz)``, the port's ``[ix, iy, iz]`` layout; z increases
downward.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MD_TO_M2 = 9.869233e-16  # millidarcy → m²

SPE10_SHAPE = (60, 220, 85)
SPE10_SPACING_M = (6.096, 3.048, 0.6096)  # 20 ft, 10 ft, 2 ft
SPE10_TARBERT_LAYERS = 35  # layers 0..34 Tarbert, 35..84 Upper Ness


@dataclasses.dataclass
class SPE10Fields:
    kx: np.ndarray  # [m²], (nx, ny, nz)
    ky: np.ndarray
    kz: np.ndarray
    phi: np.ndarray

    def layer(self, iz: int) -> "SPE10Fields":
        """A single horizontal layer as 2D fields (nx, ny)."""
        return SPE10Fields(kx=self.kx[:, :, iz], ky=self.ky[:, :, iz],
                           kz=self.kz[:, :, iz], phi=self.phi[:, :, iz])

    def subbox(self, sl_x: slice, sl_y: slice, sl_z: slice) -> "SPE10Fields":
        return SPE10Fields(kx=self.kx[sl_x, sl_y, sl_z], ky=self.ky[sl_x, sl_y, sl_z],
                           kz=self.kz[sl_x, sl_y, sl_z], phi=self.phi[sl_x, sl_y, sl_z])


def _read_floats(path: str, nmax: int) -> np.ndarray:
    """Whitespace-separated floats of a text file, at most ``nmax`` (the
    caller checks the count): through the native parser when its library
    builds, else numpy."""
    from thermalporous_torch.io import native

    vals = native.parse_floats(path, nmax)
    if vals is None:
        vals = np.fromfile(path, sep=" ")
    return vals


def load_spe10(perm_path: str, phi_path: str) -> SPE10Fields:
    """Parse the standard SPE10 text files (``spe_perm.dat``/``spe_phi.dat``):
    kx, ky, kz then porosity, each 60·220·85 values in Fortran order (x
    fastest), permeabilities in millidarcy."""
    nx, ny, nz = SPE10_SHAPE
    n = nx * ny * nz
    vals = _read_floats(perm_path, 3 * n + 1)
    if vals.size != 3 * n:
        raise ValueError(f"expected {3*n} perm values, got {vals.size}")

    def unflatten(flat):
        return flat.reshape(nz, ny, nx).transpose(2, 1, 0)

    kx = unflatten(vals[:n]) * MD_TO_M2
    ky = unflatten(vals[n: 2 * n]) * MD_TO_M2
    kz = unflatten(vals[2 * n:]) * MD_TO_M2
    phiv = _read_floats(phi_path, n + 1)
    if phiv.size != n:
        raise ValueError(f"expected {n} phi values, got {phiv.size}")
    return SPE10Fields(kx=kx, ky=ky, kz=kz, phi=unflatten(phiv))


def _smooth_gaussian_field(shape, corr, rng) -> np.ndarray:
    """Stationary Gaussian field with per-axis correlation lengths (cells):
    FFT-filtered white noise, centred, then scaled to unit variance."""
    noise = rng.standard_normal(shape)
    f = np.fft.fftn(noise)
    filt = np.ones(shape)
    for axis, (n, lc) in enumerate(zip(shape, corr)):
        k = np.fft.fftfreq(n)
        gauss = np.exp(-0.5 * (k * lc * 2 * np.pi) ** 2)
        view = [1] * len(shape)
        view[axis] = n
        filt = filt * gauss.reshape(view)
    field = np.real(np.fft.ifftn(f * filt))
    field = field - field.mean()
    return field / (field.std() + 1e-30)


def _channel_mask(nx, ny, n_channels, width, amplitude, wavelength, rng) -> np.ndarray:
    """Sinuous channels running along the long (y) axis of an (nx, ny) slab."""
    mask = np.zeros((nx, ny), dtype=bool)
    y = np.arange(ny)
    for _ in range(n_channels):
        x0 = rng.uniform(0, nx)
        phase = rng.uniform(0, 2 * np.pi)
        wl = wavelength * rng.uniform(0.7, 1.4)
        path = x0 + amplitude * np.sin(2 * np.pi * y / wl + phase)
        w = width * rng.uniform(0.7, 1.3)
        xs = np.arange(nx)[:, None]
        mask |= np.abs(xs - path[None, :]) <= w / 2
    return mask


def synthetic_spe10(
    shape: tuple[int, int, int] = SPE10_SHAPE,
    seed: int = 2020,
    tarbert_frac: float = SPE10_TARBERT_LAYERS / SPE10_SHAPE[2],
) -> SPE10Fields:
    """Deterministic SPE10-like fields at any shape: a smooth lognormal upper
    section (σ(log10 k) ≈ 1), a channelized lower section (sand channels ~4
    orders more permeable than the background), kz = 0.3·kx, porosity
    linear in log-permeability, clipped to [0.01, 0.35]."""
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    n_tarbert = int(round(tarbert_frac * nz))

    logk = np.empty(shape)
    if n_tarbert > 0:
        g = _smooth_gaussian_field((nx, ny, n_tarbert), corr=(8.0, 12.0, 2.0), rng=rng)
        logk[:, :, :n_tarbert] = 1.5 + 1.0 * g  # log10 mD
    nun = nz - n_tarbert
    if nun > 0:
        g = _smooth_gaussian_field((nx, ny, nun), corr=(4.0, 8.0, 1.0), rng=rng)
        background = -2.0 + 0.8 * g
        for iz in range(nun):
            mask = _channel_mask(
                nx, ny,
                n_channels=max(2, nx // 15),
                width=max(3.0, nx / 12.0),
                amplitude=nx / 6.0,
                wavelength=max(ny / 2.5, 20.0),
                rng=rng,
            )
            slab = background[:, :, iz]
            slab[mask] = 2.5 + 0.6 * g[:, :, iz][mask]
            logk[:, :, n_tarbert + iz] = slab

    kx = (10.0**logk) * MD_TO_M2
    ky = kx.copy()
    kz = 0.3 * kx

    lo, hi = logk.min(), logk.max()
    phi = 0.05 + 0.30 * (logk - lo) / max(hi - lo, 1e-9)
    phi = np.clip(phi, 0.01, 0.35)
    return SPE10Fields(kx=kx, ky=ky, kz=kz, phi=phi)
