"""Flexible GMRES, right-preconditioned (counterpart of
``thermalporous_tpu/solve/fgmres.py``).

One cycle of at most ``maxiter`` Arnoldi steps with early exit, as the
reference runs it on the step's main path.  Vectors keep their state shape;
the Arnoldi basis V may be stored in bf16 (``basis_dtype``) with projections
computed in the compute dtype, the flexible basis Z and the solution stay in
the compute dtype, and the scalar-producing reductions (β, ‖b‖, h_{j+1,j},
the Gram seed) accumulate in f64 for an f32 state.

The vector work stays on the device.  The small Hessenberg/Givens algebra
runs on the host in the compute dtype (numpy f32/f64 scalars round like the
device scalars of the reference); each iteration fetches its new
Hessenberg column once, which is also where the loop decides to stop.

Orthogonalization: ``orth_gram=0`` is CGS2 (two classical passes);
``orth_gram=3`` is the low-synchronization CGS2 of the reference's
``cgs2g`` (the second projection from the carried Gram matrix of the stored
basis, whose new column comes from real dots).  Warm starts, restarts,
single-pass CGS, selective reorthogonalization and the algebraic-Gram
variant are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from thermalporous_torch._device import reduce_dtype

_NP = {torch.float32: np.float32, torch.float64: np.float64}


@dataclasses.dataclass
class FGMRESResult:
    x: torch.Tensor
    iters: int                # inner iterations performed
    res_norm: float           # final (estimated) residual norm
    converged: bool
    breakdown: bool           # Arnoldi breakdown before convergence


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Global dot product (f64 accumulation for f32), in a's dtype."""
    rd = reduce_dtype(a.dtype)
    return torch.dot(a.reshape(-1).to(rd), b.reshape(-1).to(rd)).to(a.dtype)


def _norm(a: torch.Tensor) -> torch.Tensor:
    rd = reduce_dtype(a.dtype)
    q = a.reshape(-1).to(rd)
    return torch.sqrt(torch.dot(q, q)).to(a.dtype)


def fgmres(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
    rtol: float = 1e-5,
    atol: float = 0.0,
    maxiter: int = 60,
    basis_dtype: torch.dtype | None = None,
    orth_gram: int = 0,
) -> FGMRESResult:
    """Solve A x = b from x₀ = 0; stop when the Givens residual estimate is
    ≤ max(rtol·‖b‖, atol) or after ``maxiter`` iterations."""
    if orth_gram not in (0, 3):
        raise NotImplementedError(f"fgmres: orth_gram={orth_gram} is not ported")
    if precond is None:
        precond = lambda r: r

    m = int(maxiter)
    dtype, shape, dev = b.dtype, tuple(b.shape), b.device
    npt = _NP[dtype]
    bd = basis_dtype or dtype
    rd = reduce_dtype(dtype)
    n = b.numel()

    # cold start: r0 = b, no matvec
    beta = npt(_norm(b).item())
    tol = np.maximum(npt(rtol) * beta, npt(atol))

    V = torch.zeros((m + 1, n), dtype=bd, device=dev)
    Z = torch.empty((m,) + shape, dtype=dtype, device=dev)
    H = np.zeros((m + 1, m), dtype=npt)
    cs = np.zeros(m, dtype=npt)
    sn = np.zeros(m, dtype=npt)
    g = np.zeros(m + 1, dtype=npt)
    V[0] = (b / float(beta if beta > 0 else 1.0)).reshape(-1).to(bd)
    g[0] = beta
    G = None
    if orth_gram:
        G = torch.zeros((m + 1, m + 1), dtype=rd, device=dev)
        v0 = V[0].to(dtype)
        G[0, 0] = _dot(v0, v0).to(rd)

    def proj(Vs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """One read of the active basis: the dots <V_i, x>."""
        return torch.mv(Vs.to(dtype), x)

    def recon(Vs: torch.Tensor, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """One read of the active basis: x − Σ_i h_i V_i."""
        return x - torch.mv(Vs.to(dtype).T, h)

    tiny = torch.tensor(1e-300, dtype=dtype, device=dev)   # 0 in f32, as in the reference
    j, res, done = 0, beta, bool(beta <= tol)
    breakdown = False
    while j < m and not done:
        z = precond(V[j].to(dtype).reshape(shape))
        Z[j] = z
        w = matvec(z).reshape(-1)
        Vs = V[: j + 1]
        if orth_gram:
            c1r = proj(Vs, w).to(rd)
            hr = c1r + (c1r - G[: j + 1, : j + 1] @ c1r)
            h = hr.to(dtype)
            w = recon(Vs, h, w)
        else:
            h = proj(Vs, w)
            w = recon(Vs, h, w)
            h2 = proj(Vs, w)
            w = recon(Vs, h2, w)
            h = h + h2
        h_next = _norm(w)
        brk = h_next <= tiny
        V[j + 1] = torch.where(brk, 0.0, w / torch.where(brk, 1.0, h_next)).to(bd)
        if orth_gram:
            gcol = proj(V[: j + 2], V[j + 1].to(dtype)).to(rd)
            G[j + 1, : j + 2] = gcol
            G[: j + 2, j + 1] = gcol
        col = torch.cat([h, h_next.reshape(1)]).cpu().numpy()
        H[: j + 2, j] = col
        breakdown = bool(col[-1] <= npt(1e-300))

        for i in range(j):           # previous Givens rotations
            h1 = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
            h2_ = -sn[i] * H[i, j] + cs[i] * H[i + 1, j]
            H[i, j], H[i + 1, j] = h1, h2_
        a, bb = H[j, j], H[j + 1, j]
        r_ = np.sqrt(a * a + bb * bb)
        c_new = a / r_ if r_ > 0 else npt(1.0)
        s_new = bb / r_ if r_ > 0 else npt(0.0)
        cs[j], sn[j] = c_new, s_new
        H[j, j] = c_new * a + s_new * bb
        H[j + 1, j] = 0.0
        g[j + 1] = -s_new * g[j]
        g[j] = c_new * g[j]
        res = np.abs(g[j + 1])
        done = bool(res <= tol) or breakdown
        j += 1

    # back substitution on the leading j×j triangle
    y = np.zeros(j, dtype=npt)
    for i in range(j - 1, -1, -1):
        acc = g[i]
        for k in range(i + 1, j):
            acc = acc - H[i, k] * y[k]
        y[i] = acc / H[i, i]
    if j > 0:
        x = torch.tensordot(torch.as_tensor(y, device=dev), Z[:j], dims=1)
    else:
        x = torch.zeros_like(b)
    converged = bool(res <= tol)
    return FGMRESResult(x=x, iters=j, res_norm=float(res), converged=converged,
                        breakdown=done and not converged)
