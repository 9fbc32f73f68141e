"""Stencil kernels: block matvec, scalar matvec, the whole Chebyshev smooth
and the zero-start red-black block Gauss–Seidel sweep.

Each public function is a wrapper around one CUDA kernel of
``csrc/stencil.cu`` (the sweep: ``csrc/rbgs.cu``) and has its plain PyTorch
version beside it (``*_plain``).  A wrapper checks its arguments, then:

- for tensors on the CPU, returns the plain version;
- for CUDA tensors, launches the kernel (or raises), and adds one to its
  ``launches`` counter.

Layouts (the reference's ``pack_block_stencil`` / ``pack_stencil``):

- block stencil ``coef``: ``(2·dim+1, nc, nc, *grid)`` — offsets
  ``[diag, up_0, lo_0, up_1, lo_1, ...]``, each an nc×nc block per cell;
  ``up_a`` couples cell i to i+e_a, ``lo_a`` to i−e_a;
- scalar stencil ``packed``: ``(2·dim+1, *grid)`` in the same offset order.

Values beyond the boundary are zero.
"""

from __future__ import annotations

import torch

from thermalporous_torch.core.grid import shift_minus, shift_plus
from thermalporous_torch.kernels import _lib

_FLOATS = (torch.float32, torch.float64)


def _check(name: str, *tensors: torch.Tensor) -> torch.device:
    """Same device and float dtype, contiguous; returns the device."""
    dev, dt = tensors[0].device, tensors[0].dtype
    if dt not in _FLOATS:
        raise TypeError(f"{name}: dtype {dt} not in {_FLOATS}")
    for t in tensors:
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name}: mixed devices/dtypes "
                             f"({t.device}/{t.dtype} vs {dev}/{dt})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


# ------------------------------------------------------------ block matvec

def apply_block_cols(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-cell blocks ``w`` (nc, nc, *grid) applied over their first
    ``v.shape[0]`` columns to ``v`` (k, *grid), as explicit small-index sums
    (row i: Σ_c w[i,c]·v[c], left to right) — all nc rows out."""
    nc, k = w.shape[0], v.shape[0]
    rows = []
    for i in range(nc):
        acc = w[i, 0] * v[0]
        for c in range(1, k):
            acc = acc + w[i, c] * v[c]
        rows.append(acc)
    return torch.stack(rows)


def block_matvec_plain(coef: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y = A·[v; 0]: block columns 0:k of the stencil, k = v.shape[0]."""
    dim = coef.dim() - 3
    y = apply_block_cols(coef[0], v)
    for a in range(dim):
        y = y + apply_block_cols(coef[1 + 2 * a], shift_minus(v, a, lead=1))
        y = y + apply_block_cols(coef[2 + 2 * a], shift_plus(v, a, lead=1))
    return y


def block_matvec(coef: torch.Tensor, v: torch.Tensor, k: int) -> torch.Tensor:
    """y = A·[v; 0] for a block stencil over block columns 0:k.

    ``v`` has shape (k, *grid); with k < nc the result equals A applied to v
    padded with nc−k zero components, while the kernel reads only k/nc of
    the coefficients.
    """
    dev = _check("block_matvec", coef, v)
    nco, nc = coef.shape[0], coef.shape[1]
    grid = tuple(coef.shape[3:])
    dim = len(grid)
    if (dim not in (2, 3) or nco != 2 * dim + 1 or coef.shape[2] != nc
            or not 1 <= k <= nc or tuple(v.shape) != (k,) + grid):
        raise ValueError(f"block_matvec: coef {tuple(coef.shape)}, v "
                         f"{tuple(v.shape)}, k={k}")
    if dev.type == "cpu":
        return block_matvec_plain(coef, v)
    if nc > 3:
        raise NotImplementedError("block_matvec kernel: nc <= 3")
    y = torch.empty((nc,) + grid, dtype=v.dtype, device=dev)
    _lib.launch("tp_block_matvec", _lib.dtype_code(v), coef.data_ptr(),
                v.data_ptr(), y.data_ptr(), nc, k, dim, *_lib.dims3(grid),
                _lib.stream_of(v))
    block_matvec.launches += 1
    return y


block_matvec.launches = 0


# ----------------------------------------------------------- scalar matvec

def matvec_plain(packed: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    dim = packed.dim() - 1
    y = packed[0] * v
    for a in range(dim):
        y = y + packed[1 + 2 * a] * shift_minus(v, a, lead=0)
        y = y + packed[2 + 2 * a] * shift_plus(v, a, lead=0)
    return y


def _check_scalar(name: str, packed: torch.Tensor, *vecs: torch.Tensor) -> tuple:
    grid = tuple(packed.shape[1:])
    dim = len(grid)
    if dim not in (2, 3) or packed.shape[0] != 2 * dim + 1:
        raise ValueError(f"{name}: packed stencil shape {tuple(packed.shape)}")
    for t in vecs:
        if tuple(t.shape) != grid:
            raise ValueError(f"{name}: vector shape {tuple(t.shape)} != {grid}")
    return grid


def matvec(packed: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y = A·v for a scalar stencil ``packed`` (2·dim+1, *grid)."""
    dev = _check("matvec", packed, v)
    grid = _check_scalar("matvec", packed, v)
    if dev.type == "cpu":
        return matvec_plain(packed, v)
    y = torch.empty_like(v)
    _lib.launch("tp_scalar_matvec", _lib.dtype_code(v), packed.data_ptr(),
                v.data_ptr(), y.data_ptr(), len(grid), *_lib.dims3(grid),
                _lib.stream_of(v))
    matvec.launches += 1
    return y


matvec.launches = 0


# -------------------------------------------------------- Chebyshev smooth

def chebyshev_smooth_plain(
    packed: torch.Tensor,
    b: torch.Tensor,
    x: torch.Tensor | None,
    lam_max: torch.Tensor,
    degree: int,
    lam_min_frac: float,
    safety: float = 1.05,
) -> torch.Tensor:
    """``degree`` Chebyshev iterations on D⁻¹A x = D⁻¹b over
    [lam_min_frac·λ, safety·λ], from ``x`` (None = zero start, which skips
    the first matvec: b − A·0 = b exactly)."""
    lmax = lam_max * safety
    lmin = lam_max * lam_min_frac
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    inv_diag = 1.0 / packed[0]
    if x is None:
        x = torch.zeros_like(b)
        z = inv_diag * b
    else:
        z = inv_diag * (b - matvec_plain(packed, x))
    d = z / theta
    rho = 1.0 / sigma1
    for _ in range(degree - 1):
        x = x + d
        z = inv_diag * (b - matvec_plain(packed, x))
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * z
        rho = rho_new
    return x + d


def chebyshev_smooth(
    packed: torch.Tensor,
    b: torch.Tensor,
    x: torch.Tensor | None,
    lam_max: torch.Tensor,
    degree: int,
    lam_min_frac: float,
    safety: float = 1.05,
) -> torch.Tensor:
    """A whole degree-``degree`` Chebyshev smooth of D⁻¹A (see the plain
    version).  ``lam_max`` is a 0-dim tensor on the device of ``b``; the
    kernel reads it there, so the call never waits on the host.  On the
    card it is ``degree`` launches, counted as one smooth."""
    if lam_max.dim() != 0:
        raise ValueError("chebyshev_smooth: lam_max must be a 0-dim tensor")
    if degree < 1:
        raise ValueError(f"chebyshev_smooth: degree {degree} < 1")
    tensors = (packed, b, lam_max) + (() if x is None else (x,))
    dev = _check("chebyshev_smooth", *tensors)
    grid = _check_scalar("chebyshev_smooth", packed, b,
                         *(() if x is None else (x,)))
    if dev.type == "cpu":
        return chebyshev_smooth_plain(packed, b, x, lam_max, degree,
                                      lam_min_frac, safety)
    out = torch.empty_like(b)
    scratch = torch.empty((4,) + grid, dtype=b.dtype, device=dev)
    _lib.launch("tp_chebyshev_smooth", _lib.dtype_code(b), packed.data_ptr(),
                b.data_ptr(), None if x is None else x.data_ptr(),
                lam_max.data_ptr(), out.data_ptr(),
                *(scratch[i].data_ptr() for i in range(4)),
                int(degree), float(lam_min_frac), float(safety), len(grid),
                *_lib.dims3(grid), _lib.stream_of(b))
    chebyshev_smooth.launches += 1
    return out


chebyshev_smooth.launches = 0


# ----------------------------------------- red-black block Gauss–Seidel

def checkerboard(shape: tuple[int, ...], dtype: torch.dtype,
                 device: torch.device | str) -> torch.Tensor:
    """Parity mask: 1.0 on 'red' cells (even index sum), 0.0 on black."""
    parity = torch.zeros((), dtype=torch.int64, device=device)
    for a, m in enumerate(shape):
        view = [1] * len(shape)
        view[a] = m
        parity = parity + torch.arange(m, device=device).reshape(view)
    return (parity % 2 == 0).to(dtype)


def fused_block_rbgs_plain(coef: torch.Tensor, dinv: torch.Tensor,
                          b: torch.Tensor) -> torch.Tensor:
    """One red-black block Gauss–Seidel sweep from x = 0:
    x_r = red⊙D⁻¹b, out = x_r + black⊙D⁻¹(b − A·x_r) (the looped form's
    first half-sweep, b − A·0 = b exactly)."""
    red = checkerboard(tuple(b.shape[1:]), b.dtype, b.device)
    black = 1.0 - red
    xr = red * apply_block_cols(dinv, b)
    return xr + black * apply_block_cols(dinv, b - block_matvec_plain(coef, xr))


def fused_block_rbgs(coef: torch.Tensor, dinv: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """One zero-start red-black block Gauss–Seidel sweep (see the plain
    version) for a block stencil ``coef`` (2·dim+1, nc, nc, *grid), the
    per-cell inverse diagonal blocks ``dinv`` (nc, nc, *grid) and ``b``
    (nc, *grid): the CPTR stage 2 of the flagship, in one launch."""
    dev = _check("fused_block_rbgs", coef, dinv, b)
    nco, nc = coef.shape[0], coef.shape[1]
    grid = tuple(coef.shape[3:])
    dim = len(grid)
    if (dim not in (2, 3) or nco != 2 * dim + 1 or coef.shape[2] != nc
            or tuple(dinv.shape) != (nc, nc) + grid
            or tuple(b.shape) != (nc,) + grid):
        raise ValueError(f"fused_block_rbgs: coef {tuple(coef.shape)}, dinv "
                         f"{tuple(dinv.shape)}, b {tuple(b.shape)}")
    if dev.type == "cpu":
        return fused_block_rbgs_plain(coef, dinv, b)
    if nc > 3:
        raise NotImplementedError("fused_block_rbgs kernel: nc <= 3")
    out = torch.empty_like(b)
    _lib.launch("tp_block_rbgs_zero", _lib.dtype_code(b), coef.data_ptr(),
                dinv.data_ptr(), b.data_ptr(), out.data_ptr(), nc, dim,
                *_lib.dims3(grid), _lib.stream_of(b))
    fused_block_rbgs.launches += 1
    return out


fused_block_rbgs.launches = 0
