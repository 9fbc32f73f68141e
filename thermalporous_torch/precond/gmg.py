"""Geometric multigrid on scalar stencils (counterpart of
``thermalporous_tpu/precond/gmg.py``).

Cell-centred geometric multigrid with piecewise-constant prolongation,
summation restriction, Galerkin coarse operators (which stay 5/7-point and
reduce to masked block sums of the fine coefficients), Chebyshev smoothing
and a dense inverse on the coarsest level.  Cycles: V and the K-cycle (two
recursive cycles combined by a flexible-CG(2) update; its dot products stay
on the device).

Ported: geometric full coarsening and the adaptive schedule (a baked
``level_factors`` from :func:`plan_coarsening`), constant transfer,
Chebyshev smoothing, one cycle per apply, and the fused coarse subtree
(``fuse_below``: the whole correction below a small enough level in one
launch of the ``deep_correction`` kernel).  The W-cycle, the other
smoothers, semicoarsening, weighted/variational transfers, repeated cycles
and the multi-device options are not ported.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from thermalporous_torch.core.stencil import ScalarStencil
from thermalporous_torch.kernels import deep_cycle as kdeep
from thermalporous_torch.precond.chebyshev import chebyshev, gershgorin_lambda_max

#: Hopper eligibility of the fused coarse subtree: the bytes it touches
#: (:func:`kernels.deep_cycle.subtree_bytes`, at the apply dtype) must fit
#: in this share of the H100's 50 MB L2, so that its single thread block
#: walks the recursion from L2 instead of HBM.
FUSE_L2_BUDGET_BYTES = 32 * 2**20


@dataclasses.dataclass(frozen=True)
class GMGConfig:
    """Static multigrid configuration: the reference's fields for geometric
    coarsening, constant transfer and Chebyshev smoothing (see
    ``thermalporous_tpu/precond/gmg.py:GMGConfig``).  Its other options are
    not ported and have no field here."""

    degree: int = 2                   # Chebyshev steps pre and post
    lam_min_frac: float = 0.3         # Chebyshev interval lower end
    max_coarse_cells: int = 64        # stop coarsening at/below this size
    max_levels: int = 16
    cycle_type: str = "k"             # "v" | "k"
    kcycle_min_cells: int = 256       # smaller levels take a single cycle
    # fused coarse subtree: from a level with at most this many cells whose
    # subtree fits FUSE_L2_BUDGET_BYTES, the whole correction below is one
    # deep_correction launch (0 = off)
    fuse_below: int = 0
    # per-level coarsening factors from plan_coarsening (None = geometric)
    level_factors: tuple[tuple[int, ...], ...] | None = None
    # "geometric" = full coarsening; "adaptive" asks the caller (Simulator /
    # cpr.resolve_adaptive_coarsening) to bake ``level_factors`` from the
    # operator before the first step
    coarsen: str = "geometric"

    def __post_init__(self):
        if self.cycle_type == "w":
            raise NotImplementedError("the W-cycle is not ported")
        if self.cycle_type not in ("v", "k"):
            raise ValueError(f"unknown cycle_type {self.cycle_type!r}")
        if self.coarsen not in ("geometric", "adaptive"):
            raise ValueError(f"unknown coarsen {self.coarsen!r}")


@dataclasses.dataclass
class GMGState:
    """Per-Newton-iteration multigrid hierarchy."""

    stencils: tuple[ScalarStencil, ...]
    lam_max: tuple[torch.Tensor, ...]   # 0-dim device tensors, one per smoothed level
    coarse_inv: torch.Tensor            # dense inverse of the coarsest operator


def _blocksum(x: torch.Tensor, fine_shape: tuple[int, ...],
              factors: tuple[int, ...] | None = None) -> torch.Tensor:
    """Sum over 2-cell blocks on factor-2 axes (ragged tail zero-padded)."""
    for axis in range(len(fine_shape)):
        if factors is not None and factors[axis] == 1:
            continue
        if x.shape[axis] % 2 == 1:
            pad = torch.zeros_like(x.narrow(axis, 0, 1))
            x = torch.cat([x, pad], dim=axis)
        m = x.shape[axis] // 2
        x = x.reshape(x.shape[:axis] + (m, 2) + x.shape[axis + 1:]).sum(dim=axis + 1)
    return x


def _prolong(e: torch.Tensor, fine_shape: tuple[int, ...],
             factors: tuple[int, ...] | None = None) -> torch.Tensor:
    """Piecewise-constant injection back to the fine grid."""
    for axis in range(len(fine_shape)):
        if factors is not None and factors[axis] == 1:
            continue
        e = torch.repeat_interleave(e, 2, dim=axis)
        n = fine_shape[axis]
        if e.shape[axis] != n:
            e = e.narrow(axis, 0, n)
    return e.contiguous()


def galerkin_coarsen(st: ScalarStencil,
                     factors: tuple[int, ...] | None = None) -> ScalarStencil:
    """A_c = R·A·P with summation restriction and injection prolongation.

    A fine face along a factor-2 axis is interior to a coarse cell iff its
    lower cell has an even index: such couplings fold into the coarse
    diagonal, the rest into the coarse off-diagonals.
    """
    shape = st.grid_shape
    dim = len(shape)
    if factors is None:
        factors = (2,) * dim

    def axis_mask(axis: int, even: bool) -> torch.Tensor:
        idx = torch.arange(shape[axis], device=st.packed.device)
        m = (idx % 2 == 0) if even else (idx % 2 == 1)
        view = [1] * dim
        view[axis] = shape[axis]
        return m.to(st.packed.dtype).reshape(view)

    d = st.diag
    for a in range(dim):
        if factors[a] == 2:
            d = d + st.upper[a] * axis_mask(a, even=True)
            d = d + st.lower[a] * axis_mask(a, even=False)
    bs = lambda x: _blocksum(x, shape, factors)
    ups, los = [], []
    for a in range(dim):
        if factors[a] == 2:
            ups.append(bs(st.upper[a] * axis_mask(a, even=False)))
            los.append(bs(st.lower[a] * axis_mask(a, even=True)))
        else:
            ups.append(bs(st.upper[a]))
            los.append(bs(st.lower[a]))
    return ScalarStencil.from_parts(bs(d), ups, los)


def _level_factors(shape: tuple[int, ...], cfg: GMGConfig,
                   level: int | None = None) -> tuple[int, ...]:
    if (cfg.level_factors is not None and level is not None
            and level < len(cfg.level_factors)):
        return tuple(f if n > 1 else 1 for f, n in zip(cfg.level_factors[level], shape))
    return tuple(2 if n > 1 else 1 for n in shape)


def axis_strengths(st: ScalarStencil) -> tuple[float, ...]:
    """Mean |coupling| per axis (host floats, one device-to-host copy)."""
    vals = torch.stack([torch.mean(torch.abs(up)) + torch.mean(torch.abs(lo))
                        for up, lo in zip(st.upper, st.lower)])
    return tuple(float(v) for v in vals.cpu())


def plan_coarsening(st: ScalarStencil, cfg: GMGConfig = GMGConfig(),
                    theta: float = 0.25) -> tuple[tuple[int, ...], ...]:
    """Matrix-dependent per-level coarsening schedule: at each level coarsen
    only the axes whose mean coupling is ≥ theta × the strongest axis's."""
    schedule: list[tuple[int, ...]] = []
    level = st
    while (math.prod(level.grid_shape) > cfg.max_coarse_cells
           and len(schedule) < cfg.max_levels - 1
           and any(n > 1 for n in level.grid_shape)):
        s = axis_strengths(level)
        smax = max((v for v, n in zip(s, level.grid_shape) if n > 1), default=0.0)
        factors = tuple(
            2 if (n > 1 and (smax <= 0.0 or v >= theta * smax)) else 1
            for v, n in zip(s, level.grid_shape))
        if all(f == 1 for f in factors):
            a = max(range(len(s)), key=lambda i: (level.grid_shape[i] > 1, s[i]))
            factors = tuple(2 if i == a else 1 for i in range(len(s)))
        schedule.append(factors)
        level = galerkin_coarsen(level, factors)
    return tuple(schedule)


def dense_inv(a: torch.Tensor) -> torch.Tensor:
    """Dense inverse computed in f64 and stored in ``a``'s dtype, row-major.
    ``inv_ex`` skips the error check, which would wait on the device; a
    singular operator gives non-finite entries, as the reference's does."""
    return torch.linalg.inv_ex(a.to(torch.float64))[0].to(a.dtype).contiguous()


def gmg_setup(st: ScalarStencil, cfg: GMGConfig = GMGConfig()) -> GMGState:
    """Build the multigrid hierarchy of one stencil (per Newton iteration)."""
    stencils = [st]
    while (math.prod(stencils[-1].grid_shape) > cfg.max_coarse_cells
           and len(stencils) < cfg.max_levels
           and any(n > 1 for n in stencils[-1].grid_shape)):
        level = stencils[-1]
        factors = _level_factors(level.grid_shape, cfg, level=len(stencils) - 1)
        stencils.append(galerkin_coarsen(level, factors))
    lam_max = tuple(gershgorin_lambda_max(s) for s in stencils[:-1])
    return GMGState(stencils=tuple(stencils), lam_max=lam_max,
                    coarse_inv=dense_inv(stencils[-1].to_dense()))


def _smooth(st: ScalarStencil, lam, b, x, cfg: GMGConfig) -> torch.Tensor:
    return chebyshev(st, b, x, degree=cfg.degree, lam_max=lam,
                     lam_min_frac=cfg.lam_min_frac)


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _fusable(state: GMGState, level: int, cfg: GMGConfig,
             dtype: torch.dtype) -> bool:
    """Whether the correction at ``level`` runs as one fused subtree: the
    level has at most ``fuse_below`` cells and the subtree, sized at the
    apply dtype ``dtype``, fits FUSE_L2_BUDGET_BYTES."""
    if cfg.fuse_below <= 0:
        return False
    if math.prod(state.stencils[level].grid_shape) > cfg.fuse_below:
        return False
    shapes = [s.grid_shape for s in state.stencils[level:]]
    return (kdeep.subtree_bytes(shapes, state.coarse_inv.numel(), dtype)
            <= FUSE_L2_BUDGET_BYTES)


def _fused_correction(state: GMGState, level: int, rc: torch.Tensor,
                      cfg: GMGConfig) -> torch.Tensor:
    """The correction at ``level`` as one ``deep_correction`` launch."""
    return kdeep.deep_correction(
        [s.packed for s in state.stencils[level:]], state.lam_max[level:],
        state.coarse_inv, rc, degree=cfg.degree, lam_min_frac=cfg.lam_min_frac,
        cycle_type=cfg.cycle_type, kcycle_min_cells=cfg.kcycle_min_cells)


def _coarse_correction(state: GMGState, level: int, rc: torch.Tensor,
                       cfg: GMGConfig) -> torch.Tensor:
    """Approximate A_level⁻¹ rc: one cycle ("v") or the K-cycle ("k"), or
    the same math as one fused launch when the subtree is fusable."""
    if _fusable(state, level, cfg, rc.dtype):
        return _fused_correction(state, level, rc, cfg)
    e1 = _v_cycle(state, level, rc, cfg)
    if (cfg.cycle_type == "v" or level == len(state.stencils) - 1
            or math.prod(state.stencils[level].grid_shape) < cfg.kcycle_min_cells):
        return e1
    a_mat = state.stencils[level].matvec
    # K-cycle: flexible CG(2) on A_level preconditioned by one cycle
    v1 = a_mat(e1)
    rho1 = _vdot(v1, e1)
    alpha1 = _vdot(rc, e1)
    safe = torch.where(torch.abs(rho1) > 0, rho1, 1.0)
    x = (alpha1 / safe) * e1
    r1 = rc - (alpha1 / safe) * v1
    e2 = _v_cycle(state, level, r1, cfg)
    v2 = a_mat(e2)
    gamma = _vdot(v1, e2)
    beta = _vdot(v2, e2)
    alpha2 = _vdot(r1, e2)
    rho2 = beta - gamma * gamma / safe
    safe2 = torch.where(torch.abs(rho2) > 0, rho2, 1.0)
    return x + (alpha2 / safe2) * (e2 - (gamma / safe) * e1)


def _v_cycle(state: GMGState, level: int, b: torch.Tensor,
             cfg: GMGConfig) -> torch.Tensor:
    if level == len(state.stencils) - 1:
        shape = state.stencils[level].grid_shape
        return torch.mv(state.coarse_inv, b.reshape(-1)).reshape(shape)
    st = state.stencils[level]
    lam = state.lam_max[level]
    fine = st.grid_shape
    coarse = state.stencils[level + 1].grid_shape
    factors = tuple(2 if c < f else 1 for f, c in zip(fine, coarse))
    x = _smooth(st, lam, b, None, cfg)
    r = b - st.matvec(x)
    rc = _blocksum(r, fine, factors)
    ec = _coarse_correction(state, level + 1, rc, cfg)
    x = x + _prolong(ec, fine, factors)
    return _smooth(st, lam, b, x, cfg)


def gmg_apply(state: GMGState, b: torch.Tensor,
              cfg: GMGConfig = GMGConfig()) -> torch.Tensor:
    """Approximate A⁻¹b with one cycle."""
    return _v_cycle(state, 0, b, cfg)
