"""Flexible GMRES, right-preconditioned (counterpart of
``thermalporous_tpu/solve/fgmres.py``).

One cycle of at most ``maxiter`` Arnoldi steps with early exit, from zero
or from a warm start ``x0``, or FGMRES(r) restart cycles up to ``maxiter``
iterations in total (``restart``).  Vectors keep their state shape;
the Arnoldi basis V may be stored in bf16 (``basis_dtype``) with projections
computed in the compute dtype, the flexible basis Z and the solution stay in
the compute dtype, and the scalar-producing reductions (β, ‖b‖, h_{j+1,j},
the Gram seed) accumulate in f64 for an f32 state.

The vector work stays on the device.  The small Hessenberg/Givens algebra
runs on the host in the compute dtype (numpy f32/f64 scalars round like the
device scalars of the reference); each iteration fetches its new
Hessenberg column once, which is also where the loop decides to stop.

Orthogonalization (``orth_gram=0``): CGS2 (two classical passes,
``orth_passes=2``), one pass (``orth_passes=1``, ``cgs1``), or the second
pass only where the first cancelled most of the vector
(``orth_selective``, ``cgs2s``: Rutishauser's test from scalars in hand,
decided on the host).  ``orth_gram=3`` and ``2`` are the low-synchronization
CGS2 of the reference's ``cgs2g`` and ``cgs2g2``: the second projection
from the carried Gram matrix of the stored basis, whose new column comes
from real dots (3) or algebraically (2).

Over a grid decomposition (``mesh``) the vectors are owned blocks and
every dot product, norm and projection is the rank's partial summed by
``mesh.allreduce_sum``: every rank then holds the same Hessenberg column
and stops at the same iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from thermalporous_torch._device import reduce_dtype
from thermalporous_torch.tracing import host_read

_NP = {torch.float32: np.float32, torch.float64: np.float64}


@dataclasses.dataclass
class FGMRESResult:
    x: torch.Tensor
    iters: int                # inner iterations performed
    res_norm: float           # final (estimated) residual norm
    converged: bool
    breakdown: bool           # Arnoldi breakdown before convergence


def _allsum(mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``mesh`` (``t`` itself without)."""
    return t if mesh is None else mesh.allreduce_sum(t)


def _dot(a: torch.Tensor, b: torch.Tensor, mesh=None) -> torch.Tensor:
    """Global dot product (f64 accumulation for f32), in a's dtype."""
    rd = reduce_dtype(a.dtype)
    return _allsum(mesh, torch.dot(a.reshape(-1).to(rd), b.reshape(-1).to(rd))).to(a.dtype)


def _norm(a: torch.Tensor, mesh=None) -> torch.Tensor:
    rd = reduce_dtype(a.dtype)
    q = a.reshape(-1).to(rd)
    return torch.sqrt(_allsum(mesh, torch.dot(q, q))).to(a.dtype)


def fgmres(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
    x0: torch.Tensor | None = None,
    rtol: float = 1e-5,
    atol: float = 0.0,
    maxiter: int = 60,
    restart: int | None = None,
    iter_cap: int | None = None,
    basis_dtype: torch.dtype | None = None,
    orth_passes: int = 2,
    orth_selective: bool = False,
    orth_gram: int = 0,
    mesh=None,
) -> FGMRESResult:
    """Solve A x = b from ``x0`` (None = zero, and no matvec); stop when the
    Givens residual estimate is ≤ max(rtol·‖b‖, atol) or after ``maxiter``
    iterations (``iter_cap`` lowers that bound for this call; the restart
    driver's).  ``restart=r < maxiter`` runs FGMRES(r) cycles, each warm
    started from the last, up to ``maxiter`` iterations in total."""
    if orth_gram not in (0, 2, 3):
        raise ValueError(f"orth_gram must be 0, 2 or 3, got {orth_gram}")
    if precond is None:
        precond = lambda r: r
    orth = dict(basis_dtype=basis_dtype, orth_passes=orth_passes,
                orth_selective=orth_selective, orth_gram=orth_gram, mesh=mesh)
    if restart is not None and int(restart) < int(maxiter):
        if iter_cap is not None:
            raise ValueError("iter_cap cannot be combined with restart")
        return _fgmres_restarted(matvec, b, precond, x0, rtol, atol, int(maxiter),
                                 int(restart), **orth)

    m = int(maxiter)
    dtype, shape, dev = b.dtype, tuple(b.shape), b.device
    npt = _NP[dtype]
    bd = basis_dtype or dtype
    rd = reduce_dtype(dtype)
    n = b.numel()

    if x0 is None:
        # cold start: r0 = b, no matvec
        r0 = b
        beta = b_norm = npt(host_read(_norm(b, mesh)))
    else:
        r0 = b - matvec(x0)
        beta, b_norm = (npt(v) for v in
                        host_read(torch.stack([_norm(r0, mesh), _norm(b, mesh)])).numpy())
    tol = np.maximum(npt(rtol) * b_norm, npt(atol))
    jmax = m if iter_cap is None else min(m, int(iter_cap))

    V = torch.zeros((m + 1, n), dtype=bd, device=dev)
    Z = torch.empty((m,) + shape, dtype=dtype, device=dev)
    H = np.zeros((m + 1, m), dtype=npt)
    cs = np.zeros(m, dtype=npt)
    sn = np.zeros(m, dtype=npt)
    g = np.zeros(m + 1, dtype=npt)
    V[0] = (r0 / float(beta if beta > 0 else 1.0)).reshape(-1).to(bd)
    g[0] = beta
    G = None
    if orth_gram:
        G = torch.zeros((m + 1, m + 1), dtype=rd, device=dev)
        v0 = V[0].to(dtype)
        G[0, 0] = _dot(v0, v0, mesh).to(rd)

    def proj(Vs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """One read of the active basis: the dots <V_i, x>."""
        return _allsum(mesh, torch.mv(Vs.to(dtype), x))

    def recon(Vs: torch.Tensor, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """One read of the active basis: x − Σ_i h_i V_i."""
        return x - torch.mv(Vs.to(dtype).T, h)

    tiny = torch.tensor(1e-300, dtype=dtype, device=dev)   # 0 in f32, as in the reference
    j, res, done = 0, beta, bool(beta <= tol)
    breakdown = False
    while j < jmax and not done:
        z = precond(V[j].to(dtype).reshape(shape))
        Z[j] = z
        w = matvec(z).reshape(-1)
        Vs = V[: j + 1]
        if orth_gram:
            c1r = proj(Vs, w).to(rd)
            hr = c1r + (c1r - G[: j + 1, : j + 1] @ c1r)
            h = hr.to(dtype)
            w = recon(Vs, h, w)
            h_next = _norm(w, mesh)
        else:
            h = proj(Vs, w)
            w = recon(Vs, h, w)
            if orth_passes >= 2 and orth_selective:
                # reorthogonalize only when the first pass cancelled more
                # than 1 − 1/√2 of w: ‖w_pre‖² = ‖h‖² + ‖w₁‖²
                h1n = _norm(w, mesh)
                hh = torch.sum((h * h).to(rd)).to(dtype)
                if host_read(h1n * h1n < 0.5 * (hh + h1n * h1n)):
                    h2 = proj(Vs, w)
                    w = recon(Vs, h2, w)
                    h = h + h2
                    h_next = _norm(w, mesh)
                else:
                    h_next = h1n
            else:
                if orth_passes >= 2:
                    h2 = proj(Vs, w)
                    w = recon(Vs, h2, w)
                    h = h + h2
                h_next = _norm(w, mesh)
        brk = h_next <= tiny
        V[j + 1] = torch.where(brk, 0.0, w / torch.where(brk, 1.0, h_next)).to(bd)
        if orth_gram == 3:
            # real dots against the stored basis, the new vector included
            gcol = proj(V[: j + 2], V[j + 1].to(dtype)).to(rd)
        elif orth_gram == 2:
            # algebraic column: Vᵀv_{j+1} = (c₁ − G(c₁ + c₂)) / h_{j+1,j}
            denom = torch.where(brk, 1.0, h_next).to(rd)
            gcol = torch.where(brk, 0.0, (c1r - G[: j + 1, : j + 1] @ hr) / denom)
            gcol = torch.cat([gcol, torch.where(brk, 0.0, 1.0).to(rd).reshape(1)])
        if orth_gram:
            G[j + 1, : j + 2] = gcol
            G[: j + 2, j + 1] = gcol
        col = host_read(torch.cat([h, h_next.reshape(1)])).numpy()
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
        if x0 is not None:
            x = x0 + x
    else:
        x = torch.zeros_like(b) if x0 is None else x0.clone()
    converged = bool(res <= tol)
    return FGMRESResult(x=x, iters=j, res_norm=float(res), converged=converged,
                        breakdown=done and not converged)


def _fgmres_restarted(matvec, b, precond, x0, rtol, atol, maxiter: int, r: int,
                      **orth) -> FGMRESResult:
    """FGMRES(r): single cycles of at most r iterations, each warm started
    from the last cycle's iterate (one matvec for its true residual), until
    one converges or breaks down or ``maxiter`` iterations are spent (the
    last cycle is capped so the total never exceeds it)."""
    x, tot = x0, 0
    for _ in range(-(-maxiter // r)):
        # a cold first cycle starts from zero with r0 = b, which is the
        # reference's warm start at zero exactly (b − A·0 = b); every cycle
        # stops at the same tolerance max(rtol·‖b‖, atol)
        out = fgmres(matvec, b, precond=precond, x0=x, rtol=rtol, atol=atol,
                     maxiter=r, iter_cap=min(r, maxiter - tot), **orth)
        tot += out.iters
        x = out.x
        if out.converged or out.breakdown or tot >= maxiter:
            break
    return dataclasses.replace(out, iters=tot)
