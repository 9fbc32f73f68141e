"""The fused multigrid coarse-subtree correction (``csrc/deep_cycle.cu``).

Counterpart of ``thermalporous_tpu/kernels/deep_cycle.py``: the whole
coarse-grid correction below a level — the V- or K-cycle recursion,
Chebyshev smoothing, constant-transfer restriction and prolongation and the
dense coarsest-level solve — in one launch, instead of a few hundred small
launches per visit of the subtree.

``deep_correction`` is the wrapper: on CPU tensors it returns its plain
version, ``deep_correction_plain`` (the counterpart of the reference's
``_correction_math``, which is ``precond.gmg._coarse_correction`` unrolled);
on CUDA tensors it launches the kernel and adds one to
``deep_correction.launches``.

Sizing (:func:`subtree_bytes`) counts the subtree at the dtype the
correction computes in — the right-hand side's — which is also the dtype the
kernel reads the stencils in.  The W-cycle is not ported.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from thermalporous_torch.kernels import _lib
from thermalporous_torch.kernels import stencil as kst

#: vectors per level the kernel keeps in its scratch buffer (csrc/deep_cycle.cu:
#: b, out, e1, v1, r1, e2, v2, x, d, r)
VECS_PER_LEVEL = 10


def subtree_bytes(shapes: Sequence[tuple[int, ...]], inv_numel: int,
                  dtype: torch.dtype) -> int:
    """Bytes a fused subtree touches at ``dtype``: the packed stencils, the
    kernel's per-level vectors and the dense coarsest inverse."""
    item = torch.empty((), dtype=dtype).element_size()
    total = inv_numel * item
    for shape in shapes:
        total += (2 * len(shape) + 1 + VECS_PER_LEVEL) * math.prod(shape) * item
    return total


def _factors(shapes: Sequence[tuple[int, ...]]) -> list[tuple[int, ...]]:
    return [tuple(2 if c < f else 1 for f, c in zip(fine, coarse))
            for fine, coarse in zip(shapes[:-1], shapes[1:])]


def deep_correction_plain(
    packed: Sequence[torch.Tensor],
    lam_max: Sequence[torch.Tensor],
    coarse_inv: torch.Tensor,
    rc: torch.Tensor,
    *,
    degree: int,
    lam_min_frac: float,
    cycle_type: str,
    kcycle_min_cells: int,
    safety: float = 1.05,
) -> torch.Tensor:
    """Approximate A₀⁻¹ rc over the subtree ``packed`` (entry level first,
    scalar stencils (2·dim+1, *grid)); ``lam_max`` has one 0-dim tensor per
    level but the coarsest.  The recursion of ``precond.gmg``: one cycle per
    level, or the K-cycle (flexible CG(2) over two cycles) on levels with
    at least ``kcycle_min_cells`` cells."""
    from thermalporous_torch.precond.gmg import _blocksum, _prolong

    shapes = [tuple(p.shape[1:]) for p in packed]
    factors = _factors(shapes)
    last = len(packed) - 1

    def smooth(ell, b, x):
        return kst.chebyshev_smooth_plain(packed[ell], b, x, lam_max[ell], degree,
                                          lam_min_frac, safety)

    def v_cycle(ell, b):
        if ell == last:
            return torch.mv(coarse_inv, b.reshape(-1)).reshape(shapes[ell])
        x = smooth(ell, b, None)
        r = b - kst.matvec_plain(packed[ell], x)
        ec = correction(ell + 1, _blocksum(r, shapes[ell], factors[ell]))
        x = x + _prolong(ec, shapes[ell], factors[ell])
        return smooth(ell, b, x)

    def dot(a, b):
        return torch.dot(a.reshape(-1), b.reshape(-1))

    def correction(ell, b):
        e1 = v_cycle(ell, b)
        if (cycle_type == "v" or ell == last
                or math.prod(shapes[ell]) < kcycle_min_cells):
            return e1
        v1 = kst.matvec_plain(packed[ell], e1)
        rho1, alpha1 = dot(v1, e1), dot(b, e1)
        safe = torch.where(torch.abs(rho1) > 0, rho1, 1.0)
        x = (alpha1 / safe) * e1
        r1 = b - (alpha1 / safe) * v1
        e2 = v_cycle(ell, r1)
        v2 = kst.matvec_plain(packed[ell], e2)
        gamma, beta, alpha2 = dot(v1, e2), dot(v2, e2), dot(r1, e2)
        rho2 = beta - gamma * gamma / safe
        safe2 = torch.where(torch.abs(rho2) > 0, rho2, 1.0)
        return x + (alpha2 / safe2) * (e2 - (gamma / safe) * e1)

    return correction(0, rc)


def deep_correction(
    packed: Sequence[torch.Tensor],
    lam_max: Sequence[torch.Tensor],
    coarse_inv: torch.Tensor,
    rc: torch.Tensor,
    *,
    degree: int,
    lam_min_frac: float,
    cycle_type: str,
    kcycle_min_cells: int,
    safety: float = 1.05,
) -> torch.Tensor:
    """The whole coarse correction below the entry level ``packed[0]`` (see
    the plain version) in one launch of one 1024-thread block."""
    n_lev = len(packed)
    if cycle_type not in ("v", "k"):
        raise NotImplementedError(f"deep_correction: cycle_type {cycle_type!r}")
    if n_lev < 1 or len(lam_max) < n_lev - 1 or degree < 1:
        raise ValueError(f"deep_correction: {n_lev} levels, {len(lam_max)} "
                         f"lambda estimates, degree {degree}")
    lams = list(lam_max[: n_lev - 1])
    dev = kst._check("deep_correction", rc, coarse_inv, *packed, *lams)
    shapes = [tuple(p.shape[1:]) for p in packed]
    n_last = math.prod(shapes[-1])
    if (tuple(rc.shape) != shapes[0] or tuple(coarse_inv.shape) != (n_last, n_last)
            or any(p.shape[0] != 2 * len(s) + 1 or len(s) not in (2, 3)
                   for p, s in zip(packed, shapes))
            or any(lam.dim() != 0 for lam in lams)):
        raise ValueError(f"deep_correction: rc {tuple(rc.shape)}, levels {shapes}, "
                         f"inverse {tuple(coarse_inv.shape)}")
    if dev.type == "cpu":
        return deep_correction_plain(packed, lams, coarse_inv, rc, degree=degree,
                                     lam_min_frac=lam_min_frac, cycle_type=cycle_type,
                                     kcycle_min_cells=kcycle_min_cells, safety=safety)
    if n_lev > _lib.DEEP_MAX_LEVELS:
        raise NotImplementedError(f"deep_correction kernel: {n_lev} levels > "
                                  f"{_lib.DEEP_MAX_LEVELS}")
    sizes = [math.prod(s) for s in shapes]
    scratch = torch.empty(VECS_PER_LEVEL * sum(sizes), dtype=rc.dtype, device=dev)
    out = torch.empty_like(rc)
    factors = _factors(shapes) + [(1, 1, 1)]
    per = _lib.DEEP_DESC_PER_LEVEL
    desc = (ctypes.c_longlong * (per * n_lev))()
    base = scratch.data_ptr()
    item = rc.element_size()
    off = 0
    for ell, (p, shape) in enumerate(zip(packed, shapes)):
        vecs = [base + (off + k * sizes[ell]) * item for k in range(VECS_PER_LEVEL)]
        off += VECS_PER_LEVEL * sizes[ell]
        if ell == 0:
            vecs[0], vecs[1] = rc.data_ptr(), out.data_ptr()   # b in, out
        kcycle = (cycle_type == "k" and ell < n_lev - 1
                  and sizes[ell] >= kcycle_min_cells)
        fac = tuple(factors[ell]) + (1,) * (3 - len(factors[ell]))
        row = [p.data_ptr(), lams[ell].data_ptr() if ell < n_lev - 1 else 0,
               *vecs, len(shape), *_lib.dims3(shape), *fac, int(kcycle)]
        assert len(row) == per
        desc[ell * per:(ell + 1) * per] = row
    _lib.launch("tp_deep_correction", _lib.dtype_code(rc),
                ctypes.cast(desc, ctypes.c_void_p), n_lev, coarse_inv.data_ptr(),
                int(degree), float(lam_min_frac), float(safety), _lib.stream_of(rc))
    deep_correction.launches += 1
    return out


deep_correction.launches = 0
