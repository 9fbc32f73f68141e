"""Krylov-subspace recycling: deflated FGMRES in the FGCRO-DR style
(counterpart of ``thermalporous_tpu/solve/deflate.py``).

- A recycle space U of k solution-space columns is carried from one linear
  solve to the next (``NewtonConfig.ksp_recycle``: across the Newton
  iterations of one step; the adjoint's ``recycle``: across its backward
  steps).  At each solve W = A·U, orthonormalized into C with A·(U R⁻¹) = C
  (:func:`prepare_recycle`).
- Initial deflation: x₀ = U Cᵀb, r₀ = b − C Cᵀb.
- Arnoldi on (I − C Cᵀ) A M⁻¹, with B = Cᵀ A Z kept column by column; the
  solution x = x₀ + Z y − U (B y) annihilates the C component exactly, so
  the Givens estimate stays the true residual norm.
- Harvest for the next solve: with A [U, Z] = [C, V] G, G = [[I, B], [0,
  H̄]], the k smallest singular directions of G, the eigenvectors of the
  small symmetric GᵀG (``torch.linalg.eigh``, ascending; inactive slots
  pushed to the top by a large diagonal shift).

Validity is kept per column (``u_mask``, a host bool tensor): with no
valid column the solve is plain FGMRES plus the harvest.  ``iters`` counts
Arnoldi iterations only; each solve also pays the matvecs of the valid
recycle columns.

As in ``solve/fgmres.py`` the vectors stay on the device, the scalars that
produce norms accumulate in f64 for an f32 state, and the small algebra
(the Hessenberg and Givens work, R⁻¹, the harvest's GᵀG and its
eigenvectors) runs on the host in the compute dtype; each Arnoldi step
fetches its new columns once.  C is formed by the reference's classic
CGS2 over the k columns, with its per-column dependence cut.

Over a grid decomposition (``mesh``) U, C, V and Z are owned blocks and
every dot, projection and norm is the ranks' partials summed by
``mesh.allreduce_sum``: R, B and H̄ are then the same on every rank, so the
host's triangular solve and ``eigh`` see the same input and give every
rank the same recycle space.
"""

from __future__ import annotations

import numpy as np
import torch

from thermalporous_torch.solve.fgmres import _NP, FGMRESResult, _allsum, _norm
from thermalporous_torch.tracing import host_read


def empty_recycle(shape, k: int, dtype: torch.dtype,
                  device: torch.device | str = "cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """A fresh (all-invalid) recycle space for a state of ``shape``: U on
    ``device`` and its validity mask, a host bool tensor."""
    return (torch.zeros((k,) + tuple(shape), dtype=dtype, device=device),
            torch.zeros(k, dtype=torch.bool))


def _flat(Vs: torch.Tensor) -> torch.Tensor:
    return Vs.reshape(Vs.shape[0], -1)


def _batched_dot(Vs: torch.Tensor, w: torch.Tensor, mask: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """(k,) masked projections ⟨Vs_i, w⟩ in the compute dtype (one read of
    Vs; summed over the ranks of ``mesh``)."""
    h = _allsum(mesh, torch.mv(_flat(Vs), w.reshape(-1)))
    return h * mask.to(device=h.device, dtype=h.dtype)


def _combine(coef: torch.Tensor, Vs: torch.Tensor) -> torch.Tensor:
    """Σ_i coef_i · Vs_i (state-shaped)."""
    return torch.tensordot(coef, Vs, dims=1)


def prepare_recycle(matvec, U: torch.Tensor, mask: torch.Tensor, mesh=None):
    """C = QR(A·U) by CGS2 over the k columns: returns ``(U', C, mask')``
    with A·U' = C and CᵀC = I on the valid columns (invalid columns exactly
    zero).  A column whose image lies in the span of earlier ones (norm
    after CGS2 ≤ 100·eps of its norm before) is invalidated.  Only the
    valid columns take a matvec (an invalid one is zero, and A·0·0 = 0).
    Every rank of ``mesh`` invalidates the same columns: the test reads
    reduced norms."""
    k = U.shape[0]
    dtype, dev = U.dtype, U.device
    npt = _NP[dtype]
    W = torch.zeros_like(U)
    for i in range(k):
        if bool(mask[i]):
            W[i] = matvec(U[i])
    C = torch.zeros_like(W)
    R = np.zeros((k, k), dtype=npt)
    cmask = torch.zeros(k, dtype=torch.bool)
    eps = float(torch.finfo(dtype).eps)
    for i in range(k):
        w = W[i]
        w_in = _norm(w, mesh)
        h = _batched_dot(C, w, cmask, mesh)
        w = w - _combine(h, C)
        h2 = _batched_dot(C, w, cmask, mesh)
        w = w - _combine(h2, C)
        h = h + h2
        nrm = _norm(w, mesh)
        vals = host_read(torch.cat([h, nrm.reshape(1), w_in.reshape(1)])).numpy()
        h_host, nrm_h, w_in_h = vals[:k], vals[k], vals[k + 1]
        ok = bool(mask[i]) and bool(nrm_h > npt(100.0 * eps) * w_in_h)
        if ok:
            C[i] = w / (nrm if nrm_h > 0 else 1.0)
        R[:, i] = h_host
        R[i, i] = nrm_h if ok else npt(1.0)
        cmask[i] = ok
    # U ← U R⁻¹, so that A·U = C; R is upper triangular with a unit
    # diagonal on invalid slots
    Rinv = torch.linalg.solve_triangular(torch.from_numpy(R), torch.eye(k, dtype=dtype),
                                         upper=True)
    Uo = torch.tensordot(Rinv.T.to(dev), U, dims=1)
    Uo = Uo * cmask.to(device=dev, dtype=dtype).reshape((k,) + (1,) * (U.dim() - 1))
    return Uo, C, cmask


def fgmres_dr(
    matvec,
    b: torch.Tensor,
    precond=None,
    U: torch.Tensor | None = None,
    u_mask: torch.Tensor | None = None,
    rtol: float = 1e-5,
    atol: float = 0.0,
    maxiter: int = 60,
    basis_dtype: torch.dtype | None = None,
    orth_passes: int = 2,
    mesh=None,
) -> tuple[FGMRESResult, torch.Tensor, torch.Tensor]:
    """Deflated FGMRES with recycling, from x = 0.  Returns ``(result,
    U_next, mask_next)``, the harvested recycle space for the next solve.
    The Arnoldi step is :func:`~thermalporous_torch.solve.fgmres.fgmres`'s
    (CGS2 or one pass, an optional bf16 basis) after the deflation of
    range(C).  Over ``mesh`` the vectors are owned blocks (see the module's
    docstring)."""
    if precond is None:
        precond = lambda r: r
    if U is None or u_mask is None:
        raise ValueError("fgmres_dr needs a recycle space U and its mask (empty_recycle)")
    m = int(maxiter)
    dtype, shape, dev = b.dtype, tuple(b.shape), b.device
    npt = _NP[dtype]
    bd = basis_dtype or dtype
    n = b.numel()
    k = U.shape[0]

    U, C, u_mask = prepare_recycle(matvec, U, u_mask, mesh)

    cu = _batched_dot(C, b, u_mask, mesh)
    x0 = _combine(cu, U)
    r0 = b - _combine(cu, C)
    b_norm, beta = (npt(v) for v in
                    host_read(torch.stack([_norm(b, mesh), _norm(r0, mesh)])).numpy())
    tol = np.maximum(npt(rtol) * b_norm, npt(atol))

    V = torch.zeros((m + 1, n), dtype=bd, device=dev)
    Z = torch.zeros((m,) + shape, dtype=dtype, device=dev)
    H = np.zeros((m + 1, m), dtype=npt)
    B = np.zeros((k, m), dtype=npt)
    cs = np.zeros(m, dtype=npt)
    sn = np.zeros(m, dtype=npt)
    g = np.zeros(m + 1, dtype=npt)
    V[0] = (r0 / float(beta if beta > 0 else 1.0)).reshape(-1).to(bd)
    g[0] = beta

    tiny = torch.tensor(1e-300, dtype=dtype, device=dev)   # 0 in f32, as in the reference
    j, res, done, breakdown = 0, beta, bool(beta <= tol), False
    while j < m and not done:
        z = precond(V[j].to(dtype).reshape(shape))
        w = matvec(z)
        Z[j] = z
        # deflate: remove the range(C) component (C orthonormal: one pass)
        bcol = _batched_dot(C, w, u_mask, mesh)
        w = (w - _combine(bcol, C)).reshape(-1)
        Vs = V[: j + 1].to(dtype)
        h = _allsum(mesh, torch.mv(Vs, w))
        w = w - torch.mv(Vs.T, h)
        if orth_passes >= 2:
            h2 = _allsum(mesh, torch.mv(Vs, w))
            w = w - torch.mv(Vs.T, h2)
            h = h + h2
        h_next = _norm(w, mesh)
        brk = h_next <= tiny
        V[j + 1] = torch.where(brk, 0.0, w / torch.where(brk, 1.0, h_next)).to(bd)
        col = host_read(torch.cat([bcol, h, h_next.reshape(1)])).numpy()
        B[:, j] = col[:k]
        H[: j + 2, j] = col[k:]
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

    y = np.zeros(j, dtype=npt)
    for i in range(j - 1, -1, -1):
        acc = g[i]
        for c in range(i + 1, j):
            acc = acc - H[i, c] * y[c]
        y[i] = acc / H[i, i]
    # x = x0 + Z y − U (B y): −B y cancels the C-residual component exactly
    alpha = -(B[:, :j] @ y) if j else np.zeros(k, dtype=npt)
    x = x0
    if j:
        x = x + torch.tensordot(torch.as_tensor(y, device=dev), Z[:j], dims=1)
    x = x + _combine(torch.as_tensor(alpha.astype(npt), device=dev), U)
    converged = bool(res <= tol)

    U_next, mask_next = harvest(B, H, u_mask, j, U, Z)
    result = FGMRESResult(x=x, iters=j, res_norm=float(res), converged=converged,
                          breakdown=done and not converged)
    return result, U_next, mask_next


def harvest(B: np.ndarray, H: np.ndarray, u_mask: torch.Tensor, j: int, U: torch.Tensor,
            Z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The recycle space for the next solve: the k smallest singular
    directions of G over [U, Z], from the eigenvectors of GᵀG = [[diag(mask),
    B], [Bᵀ, BᵀB + H̄ᵀH̄]] over the active slots (``j`` Arnoldi steps; H̄ as
    the Givens rotations left it, RᵀR = H̄ᵀH̄), the inactive ones shifted to
    the top of the spectrum.  ``B`` (k, m) and ``H`` (m+1, m) are the host
    arrays of :func:`fgmres_dr`."""
    k, m = B.shape
    npt = B.dtype.type
    act = np.arange(m) < j
    mask = u_mask.numpy().astype(npt)
    col_act = np.concatenate([mask, act.astype(npt)])
    Bm = B * act[None, :].astype(npt)
    Hbar = H * act[None, :].astype(npt)
    top = np.concatenate([np.diag(mask), Bm], axis=1)
    bot = np.concatenate([Bm.T, Bm.T @ Bm + Hbar.T @ Hbar], axis=1)
    M = np.concatenate([top, bot], axis=0)
    M = M + np.diag((npt(1.0) - col_act) * npt(1e30))
    M = npt(0.5) * (M + M.T)
    _, Q = torch.linalg.eigh(torch.from_numpy(M))    # ascending
    P = Q[:, :k].to(U.device)
    U_next = torch.tensordot(P[:k].T, U, dims=1)
    if j:
        U_next = U_next + torch.tensordot(P[k:k + j].T, Z[:j], dims=1)
    return U_next, torch.arange(k) < int(u_mask.sum()) + j
