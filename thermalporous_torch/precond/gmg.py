"""Geometric multigrid on scalar stencils (counterpart of
``thermalporous_tpu/precond/gmg.py``).

Cell-centred geometric multigrid with piecewise-constant prolongation,
summation restriction, Galerkin coarse operators (which stay 5/7-point and
reduce to masked block sums of the fine coefficients), Chebyshev (or
damped Jacobi, red-black Gauss–Seidel, line Jacobi, zebra) smoothing and a
dense inverse on the coarsest level.  Cycles: V, W (two recursive cycles,
the second on the first's residual) and the K-cycle (two recursive cycles
combined by a flexible-CG(2) update; its dot products stay on the device);
``cycles`` of them per apply.

Ported: geometric full coarsening (optionally never along the last axis of
a 3D grid, ``semicoarsen_z``) and the adaptive schedule (a baked
``level_factors`` from :func:`plan_coarsening`), every smoother, the fused
coarse subtree (``fuse_below``: the whole correction below a small enough
level in one launch of the ``deep_correction`` kernel, Chebyshev smoothing
and constant transfer only), and the three transfers: "constant"
(injection P, summation R), "weighted" (operator-weighted P with the
summation R; coarse levels :class:`~thermalporous_torch.precond.transfer.WideStencil`)
and "variational" (the same P with R = Pᵀ; coarse levels
:class:`~thermalporous_torch.precond.transfer.BoxStencil`, their λ estimated
by power iteration).  The wide levels are routed by type to the plain
Chebyshev or Jacobi smoother and their own plain matvec: no kernel takes
them; the finest level stays a :class:`ScalarStencil` on the kernels.  The
TPU-only option ``use_pallas`` is not ported and has no field.

Over a grid decomposition (``gmg_setup(..., block=...)``, the rank's
:class:`~thermalporous_torch.dist.sharding.Block` of the stencil; ``mesh``
names its :class:`~thermalporous_torch.dist.sharding.GridMesh`) the
hierarchy's leading levels are **decomposed**: each rank holds its block of
the level's stencil with a ghost ring ``degree + 1`` deep, one exchange
before each smooth, and restricts and prolongs its own cells.  A level stays
decomposed while it has more than ``replicate_below`` cells, every rank's
block is at least as deep as the ring and (unless it is the coarsest, which
is always replicated) its block boundaries are even along the axes it
coarsens, so that no coarsening pair straddles two blocks.  From the first
level that fails, down to the coarsest, every level is **replicated**: each
rank holds the whole level, the restricted residual is all-gathered onto it
(where the reference's ``_replicated`` constraint sits) and each rank cuts
its own part back out of the correction.  The Gershgorin bounds and the
K-cycle's dots of decomposed levels go through the mesh's all-reduce; those
of replicated levels are local.  Under the weighted and variational
transfers a decomposed level computes its transfer weights and its owned
coarse rows on its block with a ring ``TRANSFER_SETUP_RING`` deep (in the
whole grid's colours and parity: the ring is even and the boundaries are),
holds its weights at ``TRANSFER_RING``, restricts (R = Pᵀ) from a residual
exchanged two cells deep and prolongs from a correction exchanged one
coarse cell deep; a decomposed wide or box level is held with a ring its
reach times ``degree + 1`` deep and its λ comes from a power iteration
through the mesh (``utils.power_iteration``).  The other smoothers of a
decomposed level smooth owned vectors through the level's
:class:`~thermalporous_torch.dist.halo.HaloStencil`, one exchange a product
(the line solves along x or y a pipeline through the ranks), and the
cycles after the first take their residual through the finest level's.  A
batch runs decomposed as it runs whole, its exchanges and its dots carrying
both members.  Decomposed hierarchies never take the fused subtree over more
than one rank (the reference's refusal under a mesh).  The coupled block
hierarchy of ``stage2="bgmg"`` (``precond/block_gmg.py``) follows the same
rule with the red-black block smoother: both take their levels from
:meth:`~thermalporous_torch.dist.sharding.Block.walk_levels`.

A :class:`GMGState` may hold a batch of congruent hierarchies stacked along
a leading axis of every leaf (:func:`stack_states`; ``CPRConfig.batch_pt``'s
p and T): :func:`gmg_apply` then takes and returns (batch, *grid) vectors,
the reference's ``jax.vmap`` written out.  The Chebyshev smooth and the
fused subtree run every member in one launch; the transfers are batched
tensor operations; the dot products, the dense coarsest solve and the
other smoothers run member by member, so that each member computes what it
computes alone.  A batch whose hierarchies have weighted or variational
transfers is applied member by member throughout.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from thermalporous_torch.core.stencil import ScalarStencil, map_stencil
from thermalporous_torch.kernels import deep_cycle as kdeep
from thermalporous_torch.precond.chebyshev import (
    chebyshev,
    gershgorin_lambda_max,
    line_jacobi,
    red_black_gauss_seidel,
    weighted_jacobi,
    zebra_line_gs,
)
from thermalporous_torch.precond.transfer import (
    AxisWeights,
    galerkin_variational,
    galerkin_wide,
    is_wide,
    prolong_weighted,
    restrict_weighted,
    transfer_weights,
)
from thermalporous_torch.tracing import host_read
from thermalporous_torch.utils import power_iteration

#: Hopper eligibility of the fused coarse subtree: the bytes it touches
#: (:func:`kernels.deep_cycle.subtree_bytes`, at the apply dtype) must fit
#: in this share of the H100's 50 MB L2, so that the passes of its
#: cooperative launch, a grid-wide barrier apart, read each other's vectors
#: from L2 instead of HBM.
FUSE_L2_BUDGET_BYTES = 32 * 2**20

SMOOTHERS = ("chebyshev", "jacobi", "rbgs", "line", "zebra")
TRANSFERS = ("constant", "weighted", "variational")
#: power iteration on a variational level: iterations, and the margin on
#: its estimate of D⁻¹A's largest |λ| (the reference's, gmg.py:363-378)
VARIATIONAL_POWER_ITERS = 12
VARIATIONAL_LAM_MARGIN = 1.15


@dataclasses.dataclass(frozen=True)
class GMGConfig:
    """Static multigrid configuration: the reference's fields (see
    ``thermalporous_tpu/precond/gmg.py:GMGConfig``) but its TPU-only
    ``use_pallas``, which has no field here."""

    smoother: str = "chebyshev"       # "chebyshev" | "jacobi" | "rbgs" |
                                      # "line" (line Jacobi) | "zebra"
    line_axis: int = -1               # line axis of the line smoothers
    degree: int = 2                   # smoothing steps pre and post
    lam_min_frac: float = 0.3         # Chebyshev interval lower end
    jacobi_omega: float = 0.8
    max_coarse_cells: int = 64        # stop coarsening at/below this size
    max_levels: int = 16
    cycles: int = 1                   # cycles per apply
    cycle_type: str = "k"             # "v" | "w" | "k"
    kcycle_min_cells: int = 256       # smaller levels take a single cycle
    # fused coarse subtree: from a level with at most this many cells whose
    # subtree fits FUSE_L2_BUDGET_BYTES, the whole correction below is one
    # deep_correction launch (0 = off)
    fuse_below: int = 0
    # never coarsen the last axis of a 3D grid while another axis can be
    semicoarsen_z: bool = False
    # per-level coarsening factors from plan_coarsening (None = geometric)
    level_factors: tuple[tuple[int, ...], ...] | None = None
    # "geometric" = full coarsening; "adaptive" asks the caller (Simulator /
    # cpr.resolve_adaptive_coarsening) to bake ``level_factors`` from the
    # operator before the first step
    coarsen: str = "geometric"
    # grid transfer: "constant" (injection P, summation R), "weighted"
    # (operator-weighted P, summation R; wide 9/27-point coarse levels) or
    # "variational" (the same P, R = Pᵀ, exact PᵀAP on per-axis-width boxes);
    # wide levels smooth with Chebyshev unless the smoother is "jacobi"
    transfer: str = "constant"
    transfer_floor: float = 0.75      # parent-weight floor of weighted P
    # grid decomposition: levels at or below this many cells are replicated
    # on every rank (one all-gather at the restriction that crosses it)
    replicate_below: int = 4096
    # the GridMesh of a decomposed hierarchy (None: the data's, if any); the
    # fused subtree is refused when it has more than one rank
    mesh: object | None = None

    def __post_init__(self):
        if self.cycle_type not in ("v", "w", "k"):
            raise ValueError(f"unknown cycle_type {self.cycle_type!r}")
        if self.smoother not in SMOOTHERS:
            raise ValueError(f"unknown smoother {self.smoother!r}")
        if self.cycles < 1:
            raise ValueError(f"cycles {self.cycles} < 1")
        if self.coarsen not in ("geometric", "adaptive"):
            raise ValueError(f"unknown coarsen {self.coarsen!r}")
        if self.transfer not in TRANSFERS:
            raise ValueError(f"unknown transfer {self.transfer!r}; one of {TRANSFERS}")


def _coef(st) -> torch.Tensor:
    """A level's one coefficient tensor (``packed`` of a scalar level,
    ``coef`` of a wide one)."""
    return st.packed if isinstance(st, ScalarStencil) else st.coef


@dataclasses.dataclass
class GMGState:
    """Per-Newton-iteration multigrid hierarchy, or with ``batch`` > 0 that
    many congruent hierarchies stacked along a leading axis of every leaf
    (each stencil's coefficients (batch, …, *grid), each λ estimate
    (batch,), the inverse (batch, m, m), each transfer weight (batch,
    *shape)).  ``transfers`` holds, per level above the coarsest, the
    per-axis :class:`AxisWeights` (None on factor-1 axes) of a weighted or
    variational hierarchy, and is empty for constant transfer."""

    stencils: tuple          # ScalarStencil level 0; Wide/BoxStencil below if weighted
    lam_max: tuple[torch.Tensor, ...]   # 0-dim device tensors, one per smoothed level
    coarse_inv: torch.Tensor            # dense inverse of the coarsest operator
    batch: int = 0
    transfers: tuple = ()
    # grid decomposition: the Block (at the smoothing ring) of each leading
    # decomposed level, whose stencil is held on the extended block; the
    # Block of gmg_apply's vectors (owned blocks of level 0), or None
    blocks: tuple = ()
    top: object | None = None

    def shape(self, level: int) -> tuple[int, ...]:
        """The grid of ``level`` as held (without the batch axis): a
        decomposed level's extended block."""
        st = self.stencils[level]
        b = 1 if self.batch else 0
        t = _coef(st)
        # a scalar level has one leading channel axis, a wide one dim axes
        k = 1 if isinstance(st, ScalarStencil) else (t.dim() - b) // 2
        return tuple(t.shape[b + k:])

    def gshape(self, level: int) -> tuple[int, ...]:
        """The whole grid of ``level``."""
        return self.blocks[level].shape if level < len(self.blocks) else self.shape(level)

    def member(self, m: int) -> "GMGState":
        """Member ``m`` of a batch as a hierarchy of its own (views)."""
        pick = lambda w: None if w is None else AxisWeights(w.w_self[m], w.w_out[m])
        return GMGState(tuple(type(s)(_coef(s)[m]) for s in self.stencils),
                        tuple(lam[m] for lam in self.lam_max), self.coarse_inv[m],
                        transfers=tuple(tuple(pick(w) for w in ws) for ws in self.transfers),
                        blocks=self.blocks, top=self.top)


def stack_states(states) -> GMGState:
    """Congruent hierarchies stacked member by member into one batched
    state (the reference's ``jax.tree.map(jnp.stack, ...)``), their
    transfer weights too; decomposed ones keep their blocks."""
    first = states[0]
    if any(len(s.stencils) != len(first.stencils) or len(s.blocks) != len(first.blocks)
           or (s.top is None) != (first.top is None)
           or any(type(a) is not type(b) or _coef(a).shape != _coef(b).shape
                  for a, b in zip(s.stencils, first.stencils))
           or [[w is None for w in ws] for ws in s.transfers]
           != [[w is None for w in ws] for ws in first.transfers] for s in states):
        raise ValueError("stack_states: the hierarchies are not congruent")

    def weights(l, a):
        if first.transfers[l][a] is None:
            return None
        return AxisWeights(torch.stack([s.transfers[l][a].w_self for s in states]),
                           torch.stack([s.transfers[l][a].w_out for s in states]))

    return GMGState(
        tuple(type(st)(torch.stack([_coef(s.stencils[l]) for s in states]))
              for l, st in enumerate(first.stencils)),
        tuple(torch.stack([s.lam_max[l] for s in states])
              for l in range(len(first.lam_max))),
        torch.stack([s.coarse_inv for s in states]), batch=len(states),
        transfers=tuple(tuple(weights(l, a) for a in range(len(ws)))
                        for l, ws in enumerate(first.transfers)),
        blocks=first.blocks, top=first.top)


def _blocksum(x: torch.Tensor, fine_shape: tuple[int, ...],
              factors: tuple[int, ...] | None = None, lead: int = 0) -> torch.Tensor:
    """Sum over 2-cell blocks on factor-2 axes (ragged tail zero-padded),
    after ``lead`` leading (batch) axes."""
    for ax in range(len(fine_shape)):
        if factors is not None and factors[ax] == 1:
            continue
        axis = ax + lead
        if x.shape[axis] % 2 == 1:
            pad = torch.zeros_like(x.narrow(axis, 0, 1))
            x = torch.cat([x, pad], dim=axis)
        m = x.shape[axis] // 2
        x = x.reshape(x.shape[:axis] + (m, 2) + x.shape[axis + 1:]).sum(dim=axis + 1)
    return x


def _prolong(e: torch.Tensor, fine_shape: tuple[int, ...],
             factors: tuple[int, ...] | None = None, lead: int = 0) -> torch.Tensor:
    """Piecewise-constant injection back to the fine grid, after ``lead``
    leading (batch) axes."""
    for ax in range(len(fine_shape)):
        if factors is not None and factors[ax] == 1:
            continue
        axis = ax + lead
        e = torch.repeat_interleave(e, 2, dim=axis)
        n = fine_shape[ax]
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
    factors = [2 if n > 1 else 1 for n in shape]
    if cfg.semicoarsen_z and len(shape) == 3 and any(n > 1 for n in shape[:2]):
        factors[2] = 1
    return tuple(factors)


def axis_strengths(st: ScalarStencil) -> tuple[float, ...]:
    """Mean |coupling| per axis (host floats, one device-to-host copy)."""
    vals = torch.stack([torch.mean(torch.abs(up)) + torch.mean(torch.abs(lo))
                        for up, lo in zip(st.upper, st.lower)])
    return tuple(float(v) for v in host_read(vals).numpy())


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


def _lam(s, cfg: GMGConfig, block=None) -> torch.Tensor:
    """λ estimate of D⁻¹A on a smoothed level: Gershgorin, but on a
    variational box level, where Gershgorin overestimates it many times,
    power iteration from the reference's start with a 15% margin.  With
    ``block`` (a decomposed level, ``s`` held on its extended block) every
    rank gets the whole level's estimate: the power iteration's norms and
    the Gershgorin bound's maximum go through the mesh."""
    from thermalporous_torch.dist.halo import HaloStencil

    if cfg.transfer == "variational" and is_wide(s):
        op = s if block is None else HaloStencil(s, block)
        dinv = 1.0 / op.diag
        lam = power_iteration(lambda v: dinv * op.matvec(v),
                              s.grid_shape if block is None else block.shape,
                              dtype=dinv.dtype, iters=VARIATIONAL_POWER_ITERS,
                              device=dinv.device, block=block)
        return VARIATIONAL_LAM_MARGIN * lam
    if block is None:
        return gershgorin_lambda_max(s)
    return block.mesh.allreduce_max(gershgorin_lambda_max(
        map_stencil(s, lambda c, lead: block.owned(c, lead=lead))))


def gmg_setup(st: ScalarStencil, cfg: GMGConfig = GMGConfig(),
              block=None) -> GMGState:
    """Build the multigrid hierarchy of one stencil (per Newton iteration).
    With ``block`` (a decomposed grid: ``st`` held on its extended block,
    right in the owned rows) the hierarchy of the decomposition (see the
    module's docstring)."""
    if block is not None:
        return _setup_blocks(st, cfg, block)
    stencils = [st]
    transfers = []
    while (math.prod(stencils[-1].grid_shape) > cfg.max_coarse_cells
           and len(stencils) < cfg.max_levels
           and any(n > 1 for n in stencils[-1].grid_shape)):
        level = stencils[-1]
        factors = _level_factors(level.grid_shape, cfg, level=len(stencils) - 1)
        if cfg.transfer == "constant":
            stencils.append(galerkin_coarsen(level, factors))
            continue
        w = transfer_weights(level, factors, floor=cfg.transfer_floor)
        coarse = tuple(-(-n // 2) if f == 2 else n
                       for n, f in zip(level.grid_shape, factors))
        transfers.append(w)
        galerkin = galerkin_variational if cfg.transfer == "variational" else galerkin_wide
        stencils.append(galerkin(level, w, coarse))
    lam_max = tuple(_lam(s, cfg) for s in stencils[:-1])
    return GMGState(stencils=tuple(stencils), lam_max=lam_max,
                    coarse_inv=dense_inv(stencils[-1].to_dense()),
                    transfers=tuple(transfers))


def _takes_chebyshev(st, cfg: GMGConfig) -> bool:
    """Whether level stencil ``st`` smooths with Chebyshev: the configured
    smoother, or any but Jacobi on a wide level (the colourings and line
    solves assume axis-aligned couplings)."""
    return cfg.smoother == "chebyshev" or (is_wide(st) and cfg.smoother != "jacobi")


def _smooth(st, lam, b, x, cfg: GMGConfig, second: str | None = None):
    """One smooth; with ``second`` also b − A·y ("residual") or A·y
    ("product") of its result y: for Chebyshev on a scalar level from the
    smooth's own launch, otherwise a matvec after it.  A wide level takes
    Chebyshev unless the smoother is Jacobi, both plain
    (:func:`_takes_chebyshev`)."""
    if _takes_chebyshev(st, cfg):
        return chebyshev(st, b, x, degree=cfg.degree, lam_max=lam,
                         lam_min_frac=cfg.lam_min_frac, second=second)
    if cfg.smoother == "rbgs":
        y = red_black_gauss_seidel(st, b, x, sweeps=cfg.degree)
    elif cfg.smoother == "line":
        y = line_jacobi(st, b, x, axis=cfg.line_axis, sweeps=cfg.degree)
    elif cfg.smoother == "zebra":
        y = zebra_line_gs(st, b, x, axis=cfg.line_axis, sweeps=cfg.degree)
    else:
        y = weighted_jacobi(st, b, x, sweeps=cfg.degree, omega=cfg.jacobi_omega)
    if second is None:
        return y
    ay = st.matvec(y)
    return y, (b - ay if second == "residual" else ay)


def _each(state: GMGState, fn, *vecs):
    """``fn(member state, member vectors...)`` of every member of a batched
    ``state``, stacked (a tuple result stacked item by item); None vectors
    stay None."""
    outs = [fn(state.member(m), *(None if v is None else v[m] for v in vecs))
            for m in range(state.batch)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*outs))
    return torch.stack(outs)


def _smooth_level(state: GMGState, level: int, b, x, cfg: GMGConfig,
                  second: str | None = None):
    """:func:`_smooth` on ``level``; a batch's Chebyshev smooth is one
    launch over every member, its other smoothers run member by member."""
    if state.batch and cfg.smoother != "chebyshev":
        return _each(state, lambda s, bb, xx: _smooth_level(s, level, bb, xx, cfg, second),
                     b, x)
    return _smooth(state.stencils[level], state.lam_max[level], b, x, cfg, second=second)


#: the fine ring of a decomposed level's transfer set-up: its weights and
#: the Galerkin product's owned coarse rows are exact from a ring this deep
#: (a weighted coarse row reads its children's neighbours; the variational
#: conjugation reads fine cells 2j − 3 … 2j + 4 through a box level's ±2)
TRANSFER_SETUP_RING = {"weighted": 2, "variational": 4}
#: the fine ring of a decomposed level's weighted prolongation and R = Pᵀ:
#: a fine cell's outer coarse neighbour, the fine cells 2j − 1 … 2j + 2
#: of coarse cell j (even, so that the held grid's parity is the whole's)
TRANSFER_RING = 2


def _level_rings(cfg: GMGConfig, n: int) -> list:
    """Each level's ghost ring in a decomposed hierarchy: the smooth's,
    ``degree + 1`` times the level's reach along x and y (2 on a variational
    box level, 1 elsewhere), and at least the transfer set-up's."""
    if cfg.transfer == "constant":
        return [cfg.degree + 1] * n
    reach = lambda level: 2 if cfg.transfer == "variational" and level > 0 else 1
    return [max(reach(level) * (cfg.degree + 1), TRANSFER_SETUP_RING[cfg.transfer])
            for level in range(n)]


def _transfer_blocks(cfg: GMGConfig, blk, factors):
    """A decomposed level's transfer set-up, its (fine, coarse) blocks at
    the set-up ring and at the apply's ring."""
    setup = blk.with_width(TRANSFER_SETUP_RING[cfg.transfer])
    apply = blk.with_width(TRANSFER_RING)
    return (setup, setup.coarse_ring(factors)), (apply, apply.coarse_ring(factors))


def _setup_blocks(st: ScalarStencil, cfg: GMGConfig, block) -> GMGState:
    """The hierarchy of a decomposed stencil: the levels' whole shapes and
    factors as :func:`gmg_setup` walks them, the leading levels decomposed
    while they may be (:meth:`Block.walk_levels`), the rest replicated.  A
    decomposed level of a weighted or variational hierarchy computes its
    weights and its owned coarse rows on its block at the set-up ring, in
    the whole grid's colours and parity, and keeps its weights at the
    apply's ring."""
    mesh = block.mesh
    if cfg.mesh is not None and cfg.mesh is not mesh:
        raise ValueError("GMGConfig.mesh is not the mesh the data is decomposed over")
    shapes, factors = [block.shape], []
    while (math.prod(shapes[-1]) > cfg.max_coarse_cells and len(shapes) < cfg.max_levels
           and any(n > 1 for n in shapes[-1])):
        f = _level_factors(shapes[-1], cfg, level=len(shapes) - 1)
        factors.append(f)
        shapes.append(tuple(-(-n // 2) if k == 2 else n for n, k in zip(shapes[-1], f)))
    galerkin = galerkin_variational if cfg.transfer == "variational" else galerkin_wide
    transfers = []

    def coarsen(cur, level, blk):
        f = factors[level]
        if cfg.transfer == "constant":
            return galerkin_coarsen(cur, f)
        if blk is None:
            w = transfer_weights(cur, f, floor=cfg.transfer_floor)
            transfers.append(w)
            return galerkin(cur, w, shapes[level + 1])
        (fine, coarse), (afine, _) = _transfer_blocks(cfg, blk, f)
        ext = map_stencil(cur, lambda c, lead: fine.extend(c, lead=lead))
        w = transfer_weights(ext, f, floor=cfg.transfer_floor)
        kw = {} if cfg.transfer == "variational" else dict(
            origin=tuple(coarse.ext_range(a)[0] for a in range(len(f))))
        held = galerkin(ext, w, coarse.ext_shape, **kw)
        # axis a's weights live on the grid coarsened along the axes after a
        mixed = lambda b, a: b.coarse_ring(tuple(k if i > a else 1 for i, k in enumerate(f)))
        transfers.append(tuple(
            None if wa is None else AxisWeights(*(mixed(fine, a).reframe(t, mixed(afine, a), 0)
                                                  for t in (wa.w_self, wa.w_out)))
            for a, wa in enumerate(w)))
        return map_stencil(held, lambda c, lead: coarse.owned(c, lead=lead))

    top = ScalarStencil(block.owned(st.packed, lead=1))
    blocks, levels = block.walk_levels(shapes, factors, cfg.replicate_below, top, coarsen,
                                       widths=_level_rings(cfg, len(shapes)))
    stencils, lam_max = [], []
    for level, cur in enumerate(levels):
        # a decomposed level is held on its extended block; the coarsest is
        # always replicated
        blk = blocks[level] if level < len(blocks) else None
        if blk is not None:
            cur = map_stencil(cur, lambda c, lead: blk.extend(c, lead=lead))
        stencils.append(cur)
        if level < len(levels) - 1:
            lam_max.append(_lam(cur, cfg, blk))
    return GMGState(stencils=tuple(stencils), lam_max=tuple(lam_max),
                    coarse_inv=dense_inv(stencils[-1].to_dense()), transfers=tuple(transfers),
                    blocks=tuple(blocks), top=block.with_width(0))


def _vdot(a: torch.Tensor, b: torch.Tensor, batch: int = 0) -> torch.Tensor:
    """⟨a, b⟩; with ``batch`` one per member, shaped to scale (batch, *grid)
    vectors member by member."""
    if not batch:
        return torch.dot(a.reshape(-1), b.reshape(-1))
    dots = torch.stack([torch.dot(a[m].reshape(-1), b[m].reshape(-1)) for m in range(batch)])
    return dots.reshape((batch,) + (1,) * (a.dim() - 1))


def _fusable(state: GMGState, level: int, cfg: GMGConfig,
             dtype: torch.dtype) -> bool:
    """Whether the correction at ``level`` runs as one fused subtree (one
    cooperative launch over up to one block per SM): the level has at most
    ``fuse_below`` cells and the subtree of every member, its stencils
    sized at their stored dtype and its vectors at the apply dtype
    ``dtype``, fits FUSE_L2_BUDGET_BYTES; the kernel smooths with
    Chebyshev only, on scalar levels with constant transfer."""
    if cfg.fuse_below <= 0 or cfg.smoother != "chebyshev" or state.transfers:
        return False
    if ((cfg.mesh is not None and cfg.mesh.size > 1)
            or (state.top is not None and state.top.mesh.size > 1)):
        return False
    if any(is_wide(s) for s in state.stencils[level:]):
        return False
    if math.prod(state.gshape(level)) > cfg.fuse_below:
        return False
    shapes = [state.shape(l) for l in range(level, len(state.stencils))]
    inv_numel = state.coarse_inv.numel() // max(state.batch, 1)
    return (kdeep.subtree_bytes(shapes, inv_numel, dtype,
                                coef_dtype=state.stencils[level].packed.dtype,
                                batch=max(state.batch, 1))
            <= FUSE_L2_BUDGET_BYTES)


def _fused_correction(state: GMGState, level: int, rc: torch.Tensor,
                      cfg: GMGConfig) -> torch.Tensor:
    """The correction at ``level`` as one ``deep_correction`` launch (every
    member of a batch in it)."""
    return kdeep.deep_correction(
        [s.packed for s in state.stencils[level:]], state.lam_max[level:],
        state.coarse_inv, rc, degree=cfg.degree, lam_min_frac=cfg.lam_min_frac,
        cycle_type=cfg.cycle_type, kcycle_min_cells=cfg.kcycle_min_cells)


def _coarse_correction(state: GMGState, level: int, rc: torch.Tensor,
                       cfg: GMGConfig) -> torch.Tensor:
    """Approximate A_level⁻¹ rc: one cycle ("v"), two cycles ("w": the
    second on the first's residual) or the K-cycle ("k"), or the same math
    as one fused launch when the subtree is fusable."""
    if _fusable(state, level, cfg, rc.dtype):
        return _fused_correction(state, level, rc, cfg)
    if (cfg.cycle_type == "v" or level == len(state.stencils) - 1
            or math.prod(state.gshape(level)) < cfg.kcycle_min_cells):
        return _v_cycle(state, level, rc, cfg)
    if cfg.cycle_type == "w":
        # r1 = rc − A·e1 comes out of e1's post-smooth, which ran against rc
        e1, r1 = _v_cycle(state, level, rc, cfg, second="residual")
        return e1 + _v_cycle(state, level, r1, cfg)
    # K-cycle: flexible CG(2) on A_level preconditioned by one cycle; each
    # product A·e comes out of the cycle's post-smooth.  A batch's scalars
    # are per member (the guards selects per member, as the reference's
    # vmapped jnp.where); a decomposed level's dots go through the mesh,
    # every member's in one all-reduce
    dot = lambda a, b: _vdot(a, b, state.batch)
    if level < len(state.blocks):
        mesh, local = state.blocks[level].mesh, dot
        dot = lambda a, b: mesh.allreduce_sum(local(a, b))
    e1, v1 = _v_cycle(state, level, rc, cfg, second="product")
    rho1 = dot(v1, e1)
    alpha1 = dot(rc, e1)
    safe = torch.where(torch.abs(rho1) > 0, rho1, 1.0)
    x = (alpha1 / safe) * e1
    r1 = rc - (alpha1 / safe) * v1
    e2, v2 = _v_cycle(state, level, r1, cfg, second="product")
    gamma = dot(v1, e2)
    beta = dot(v2, e2)
    alpha2 = dot(r1, e2)
    rho2 = beta - gamma * gamma / safe
    safe2 = torch.where(torch.abs(rho2) > 0, rho2, 1.0)
    return x + (alpha2 / safe2) * (e2 - (gamma / safe) * e1)


def _coarsest_solve(state: GMGState, b: torch.Tensor) -> torch.Tensor:
    """The dense coarsest solve (member by member in a batch)."""
    if state.batch:
        return _each(state, lambda s, bb: _coarsest_solve(s, bb), b)
    return torch.mv(state.coarse_inv, b.reshape(-1)).reshape(b.shape)


def _v_cycle(state: GMGState, level: int, b: torch.Tensor, cfg: GMGConfig,
             second: str | None = None):
    """One V-cycle from ``level`` down; with ``second`` (never on the
    coarsest level) the result e comes with b − A_level·e ("residual") or
    A_level·e ("product") from its post-smooth."""
    if level == len(state.stencils) - 1:
        return _coarsest_solve(state, b)
    if level < len(state.blocks):
        return _v_cycle_block(state, level, b, cfg, second)
    lead = 1 if state.batch else 0
    fine = state.shape(level)
    coarse = state.shape(level + 1)
    factors = tuple(2 if c < f else 1 for f, c in zip(fine, coarse))
    x, r = _smooth_level(state, level, b, None, cfg, second="residual")
    if state.transfers and cfg.transfer == "variational":
        rc = restrict_weighted(r, state.transfers[level])
    else:
        rc = _blocksum(r, fine, factors, lead)
    ec = _coarse_correction(state, level + 1, rc, cfg)
    if state.transfers:
        x = x + prolong_weighted(ec, fine, state.transfers[level])
    else:
        x = x + _prolong(ec, fine, factors, lead)
    return _smooth_level(state, level, b, x, cfg, second=second)


def _smooth_block(state: GMGState, level: int, b, b_ext, x, cfg: GMGConfig,
                  second: str | None = None):
    """:func:`_smooth` of decomposed ``level``: Chebyshev on the extended
    block (``b_ext``, ``b`` extended; ``x``, owned or None, extended here),
    the owned rows of its output(s); any other smoother on the owned
    vectors ``b`` and ``x`` through the level's HaloStencil (member by
    member in a batch)."""
    from thermalporous_torch.dist.halo import HaloStencil

    blk = state.blocks[level]
    if not _takes_chebyshev(state.stencils[level], cfg):
        smooth = lambda s, bb, xx: _smooth(HaloStencil(s.stencils[level], blk),
                                           s.lam_max[level], bb, xx, cfg, second=second)
        return _each(state, smooth, b, x) if state.batch else smooth(state, b, x)
    lead = 1 if state.batch else 0
    x_ext = None if x is None else blk.extend(x, lead=lead)
    out = _smooth(state.stencils[level], state.lam_max[level], b_ext, x_ext, cfg,
                  second=second)
    if second is None:
        return blk.owned(out, lead=lead)
    return blk.owned(out[0], lead=lead), blk.owned(out[1], lead=lead)


def _v_cycle_block(state: GMGState, level: int, b: torch.Tensor, cfg: GMGConfig,
                   second: str | None = None):
    """:func:`_v_cycle` from decomposed ``level``, on owned vectors: the
    restriction and prolongation block by block, the restricted residual
    all-gathered onto a replicated next level and the rank's part cut back
    out of its correction (every member of a batch in the same
    collectives)."""
    blk = state.blocks[level]
    lead = 1 if state.batch else 0
    fine = blk.owned_shape
    factors = tuple(2 if c < f else 1 for f, c in zip(state.gshape(level),
                                                      state.gshape(level + 1)))
    b_ext = (blk.extend(b, lead=lead) if _takes_chebyshev(state.stencils[level], cfg)
             else None)
    x, r = _smooth_block(state, level, b, b_ext, None, cfg, second="residual")
    solve = lambda rc: _coarse_correction(state, level + 1, rc, cfg)
    replicate = level + 1 == len(state.blocks)
    if not state.transfers:
        ec = blk.through_coarse(factors, _blocksum(r, fine, factors, lead), solve, replicate,
                                lead=lead)
        x = x + _prolong(ec, fine, factors, lead)
        return _smooth_block(state, level, b, b_ext, x, cfg, second=second)
    # weighted P (and R = Pᵀ) on the apply's ring: the coarse correction
    # comes back one coarse cell deep, the residual goes out two fine cells
    # (a batch with transfers runs member by member: gmg_apply)
    w = state.transfers[level]
    _, (afine, acoarse) = _transfer_blocks(cfg, blk, factors)
    if cfg.transfer == "variational":
        rc = acoarse.owned(restrict_weighted(afine.extend(r, lead=0), w), lead=0)
    else:
        rc = _blocksum(r, fine, factors)
    ec = blk.through_coarse(factors, rc, solve, replicate, lead=0, out=acoarse)
    x = x + afine.owned(prolong_weighted(ec, afine.ext_shape, w), lead=0)
    return _smooth_block(state, level, b, b_ext, x, cfg, second=second)


def _matvec(state: GMGState, level: int, v: torch.Tensor) -> torch.Tensor:
    """A_level·v (member by member in a batch; on a decomposed level of
    owned vectors, through its HaloStencil)."""
    from thermalporous_torch.dist.halo import HaloStencil

    if state.batch:
        return _each(state, lambda s, vv: _matvec(s, level, vv), v)
    st = state.stencils[level]
    if level < len(state.blocks):
        st = HaloStencil(st, state.blocks[level])
    return st.matvec(v)


def gmg_apply(state: GMGState, b: torch.Tensor,
              cfg: GMGConfig = GMGConfig()) -> torch.Tensor:
    """Approximate A⁻¹b with ``cfg.cycles`` cycles, each after the first on
    the residual of the sum so far (of every member of a batched
    ``state``, ``b`` then (batch, *grid); with transfers member by
    member).  A decomposed hierarchy takes and returns owned blocks; one
    replicated from level 0 gathers ``b`` and cuts the rank's part out."""
    if state.top is not None and not state.blocks:
        whole = dataclasses.replace(state, top=None)
        return state.top.on_whole(lambda bb: gmg_apply(whole, bb, cfg), b,
                                  lead=1 if state.batch else 0)
    if state.batch and state.transfers:
        return _each(state, lambda s, bb: gmg_apply(s, bb, cfg), b)
    x = _v_cycle(state, 0, b, cfg)
    for _ in range(cfg.cycles - 1):
        x = x + _v_cycle(state, 0, b - _matvec(state, 0, x), cfg)
    return x
