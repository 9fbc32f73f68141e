"""The CPR / CPTR two-stage preconditioners (counterpart of
``thermalporous_tpu/precond/cpr.py:46-212, 363-770``).

    M⁻¹ r = x₁ + M₂⁻¹ (r − A x₁),   x₁ = stage1(W · r)

- decoupling W: Quasi-IMPES (the last unknown's column eliminated from
  the other equations with the cell's diagonal block), True-IMPES (the
  same with the stencil's column sums) or ABF (the diagonal blocks'
  inverses);
- stage 1: CPR — multigrid on the decoupled pressure block; CPTR — the
  block-triangular (p, T) solve: multigrid on pressure, the T residual
  corrected through the T←p coupling (or not: ``triangular=False``),
  multigrid on temperature; optionally a few inner FGMRES or Richardson
  iterations on the decoupled (p, T) system around it (``inner_iters``),
  and a saturation leg (``s_stage``) that smooths the decoupled S block
  after correcting its residual through the S←(p, T) couplings;
- stage 2: none, block Jacobi with the exact per-cell inverses, two-step
  block Jacobi (``jacobi2``), ``stage2_sweeps`` red-black block
  Gauss–Seidel sweeps (optionally with a sparsified coupling,
  ``stage2_axes``, and the premasked zero-start sweep, ``stage2_fused``)
  or zebra block line Gauss–Seidel along ``stage2_axis``, or the coupled
  block multigrid (``bgmg``, ``precond/block_gmg.py``: ``bgmg_cycles``
  V-cycles of ``stage2_sweeps`` red-black block sweeps a level down to
  ``bgmg_coarse_cells`` cells).  Its residual
  r − A·x₁ reads only the block columns x₁ lives on (``stage2_cols``).
  One full-coupling rbgs sweep is the whole stage 2 in one
  ``fused_stage2_rbgs`` launch: the residual, the sweep and the add of x₁;
- ``pc_dtype``: bf16 storage of the preconditioner's coefficients (set up
  in full precision, then cast; every group as the reference casts it, see
  :func:`cast_coefficients`), read as bf16 by every stencil kernel with the
  arithmetic in the vectors' dtype;
- ``batch_pt``: the p and T hierarchies (block-diagonal stage 1) stacked and
  traversed together, each smooth and each fused subtree one launch for
  both.

Not ported, and without a field: ``stage2_pallas`` (the CUDA stage 2
already is the fused form) and the reference's TPU guards (among them its
refusal of ``batch_pt`` at 0.5M cells and more on its TPU backend).

Over a grid decomposition (``cpr_setup(..., block=...)``: the Jacobian held
on the rank's extended block, ``STATE_HALO`` deep) the apply takes and
returns owned blocks: W and the decoupled stage 1 on the owned cells, the
hierarchies decomposed as ``precond/gmg.py`` says, the T←p, S←p and S←T
couplings and the inner iterations' (p, T) operator
:class:`~thermalporous_torch.dist.halo.HaloStencil` s (the inner FGMRES's
dots through the mesh), the saturation leg's smoothers on the S-S
HaloStencil in the whole grid's colours.  The rbgs stage 2 is one launch
on the extended block with r and x₁ exchanged together and the colours of
the whole grid (the block's parity); each further sweep two half-sweep
launches there after one exchange of x.  Block Jacobi and "none" are
pointwise, jacobi2 takes a halo matvec, zebra its line solves on the owned
block (the factor formed there, along x or y as a pipeline through the
ranks: ``precond/chebyshev.py``) with an exchange before each line colour,
and bgmg the decomposed coupled hierarchy of ``precond/block_gmg.py``.
``stage2_axes`` sweeps owned vectors through the HaloStencil's sparsified
coupling in the block's colours (with ``stage2_fused`` from premasked
halves in those colours; further sweeps on the kernels, as above), the
saturation leg's line smoothers run along any axis, ``batch_pt`` stacks
the two decomposed hierarchies, and bf16 storage casts the groups as they
are held (:func:`cast_coefficients`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from thermalporous_torch.core.stencil import (
    BlockStencil,
    ScalarStencil,
    apply_blocks,
    map_stencil,
)
from thermalporous_torch.kernels import stencil as kst
from thermalporous_torch.precond.block_gmg import (
    BlockGMGState,
    block_gmg_apply,
    block_gmg_setup,
)
from thermalporous_torch.precond.chebyshev import (
    block_rbgs_fused_zero,
    block_red_black_gauss_seidel,
    block_tridiag_factor,
    block_zebra_line_gs,
    line_jacobi,
    red_black_gauss_seidel,
    weighted_jacobi,
    zebra_line_gs,
)
from thermalporous_torch.precond.gmg import (
    GMGConfig,
    GMGState,
    dense_inv,
    gmg_apply,
    gmg_setup,
    plan_coarsening,
    stack_states,
)
from thermalporous_torch.tracing import span

STAGE2 = ("none", "block_jacobi", "jacobi2", "rbgs", "zebra", "bgmg")
PC_DTYPES = ("f32", "bf16", "bf16_gmg", "bf16_s2")


@dataclasses.dataclass(frozen=True)
class CPRConfig:
    """Configuration of the two-stage preconditioner: the reference's fields
    that the port implements, with its defaults (see
    ``thermalporous_tpu/precond/cpr.py:CPRConfig`` for each option)."""

    variant: str = "cptr"            # "cpr" | "cptr"
    stage2: str = "block_jacobi"     # "none" | "block_jacobi" | "jacobi2" | "rbgs" |
                                     # "zebra" | "bgmg"
    stage2_sweeps: int = 1           # rbgs / zebra sweeps; bgmg sweeps a smooth
    stage2_cols: bool = True         # stage-2 residual over x₁'s columns only
    # rbgs: the first sweep from premasked D⁻¹ halves (the same function as
    # the plain first sweep with the full coupling); further sweeps in the
    # looped form over the FULL coupling, whatever ``stage2_axes`` says, as
    # the reference runs them
    stage2_fused: bool = False
    stage2_axes: tuple[int, ...] | None = None   # rbgs coupling axes (not exact)
    stage2_axis: int = 1             # zebra line axis
    stage2_omega: float = 1.0        # zebra and jacobi2 relaxation
    bgmg_coarse_cells: int = 256     # bgmg: coarsest-level size
    bgmg_cycles: int = 1             # bgmg: V-cycles per apply
    triangular: bool = True          # CPTR stage 1: triangular vs block-diagonal
    # the p and T hierarchies stacked and traversed together (CPTR with
    # triangular=False and gmg_t=None; checked in cpr_setup, as the reference
    # does, since variant="cpr" ignores it)
    batch_pt: bool = False
    decoupling: str = "qimpes"       # "qimpes" | "timpes" | "abf"
    inner_iters: int = 0             # inner iterations on the (p, T) system
    inner_rtol: float = 1e-2
    inner_method: str = "fgmres"     # "fgmres" | "richardson"
    s_stage: str = "none"            # "none" | "rbgs" | "jacobi" | "zebra" | "line"
    s_sweeps: int = 2
    s_axis: int = 0
    # storage of the preconditioner's coefficients: "f32" (the state's
    # dtype), or bf16 for every group ("bf16"), the stage-1 hierarchies and
    # T←p coupling only ("bf16_gmg") or the stage-2 stencil and D⁻¹ only
    # ("bf16_s2")
    pc_dtype: str = "f32"
    gmg: GMGConfig = GMGConfig()
    gmg_t: GMGConfig | None = None   # T hierarchy (None = ``gmg``)

    def __post_init__(self):
        checks = {"variant": ("cpr", "cptr"), "stage2": STAGE2,
                  "decoupling": ("qimpes", "timpes", "abf"),
                  "inner_method": ("fgmres", "richardson"),
                  "s_stage": ("none", "rbgs", "jacobi", "zebra", "line"),
                  "pc_dtype": PC_DTYPES}
        for field, allowed in checks.items():
            if getattr(self, field) not in allowed:
                raise ValueError(f"unknown {field} {getattr(self, field)!r}; "
                                 f"one of {allowed}")
        if self.stage2_sweeps < 1:
            raise ValueError(f"stage2_sweeps {self.stage2_sweeps} < 1")


@dataclasses.dataclass
class CPRState:
    """Per-Newton-iteration preconditioner state."""

    stencil: BlockStencil            # the Jacobian stencil A
    dinv: torch.Tensor               # per-cell inverse diagonal blocks (stage 2)
    w: torch.Tensor                  # per-cell decoupling blocks W
    gmg_p: GMGState                  # hierarchy of the decoupled pressure block
                                     # (batch_pt: the stacked (p, T) one, gmg_t None)
    gmg_t: GMGState | None           # hierarchy of the decoupled T block (CPTR)
    a_tp: ScalarStencil | None       # decoupled T-equation ← p-unknown coupling
    pt: BlockStencil | None = None   # decoupled (p, T) 2×2 stencil (inner iterations)
    a_sp: ScalarStencil | None = None   # S-equation ← p coupling (s_stage)
    a_st: ScalarStencil | None = None   # S-equation ← T coupling (s_stage)
    a_ss: ScalarStencil | None = None   # S-S transport operator (s_stage)
    zebra_fac: tuple | None = None      # block-Thomas factor (stage2="zebra")
    bgmg: BlockGMGState | None = None   # coupled block hierarchy (stage2="bgmg")
    # premasked D⁻¹ halves (red·D⁻¹, black·D⁻¹) for stage2_fused with axes
    dinv_red: torch.Tensor | None = None
    dinv_black: torch.Tensor | None = None


@dataclasses.dataclass
class BlockCPRState(CPRState):
    """The state of a decomposed apply: ``stencil``, ``dinv`` (the rbgs
    stage 2's) held on ``block``'s extended block, ``w`` (and block
    Jacobi's ``dinv``) on its owned cells, ``a_tp`` a HaloStencil."""

    block: object = None


def _impes_weights(d: torch.Tensor) -> torch.Tensor:
    """W eliminating the last-unknown column from all other equations, from
    per-cell blocks ``d`` (nc, nc, *grid)."""
    nc = d.shape[0]
    last = nc - 1
    grid = d.shape[2:]
    eye = torch.eye(nc, dtype=d.dtype, device=d.device)
    w = eye.reshape((nc, nc) + (1,) * len(grid)).expand(d.shape).clone()
    denom = d[last, last]
    safe = torch.where(torch.abs(denom) > 0, denom, 1.0)
    for i in range(nc - 1):
        w[i, last] = -d[i, last] / safe
    return w


def _decoupling_weights(stencil: BlockStencil, cfg: CPRConfig,
                        dinv: torch.Tensor | None = None) -> torch.Tensor:
    """The decoupling blocks W of ``cfg.decoupling``: Quasi-IMPES from the
    diagonal blocks, True-IMPES from the column sums, ABF the diagonal
    blocks' inverses (``dinv`` when given)."""
    if cfg.decoupling == "abf":
        return stencil.diag_inverse() if dinv is None else dinv
    if cfg.decoupling == "qimpes":
        return _impes_weights(stencil.diag)
    colsum = stencil.diag
    for up, lo in zip(stencil.upper, stencil.lower):
        colsum = colsum + up + lo
    return _impes_weights(colsum)


def resolve_adaptive_coarsening(stencil: BlockStencil, cfg: CPRConfig,
                                theta: float = 0.25, gather=None) -> CPRConfig:
    """Bake the matrix-dependent coarsening schedules into ``cfg`` (once,
    before the first step): for each hierarchy with ``coarsen="adaptive"``
    and no ``level_factors`` yet, :func:`plan_coarsening` of its decoupled
    block of ``stencil`` (pressure for ``gmg``, temperature for ``gmg_t``).
    Returns ``cfg`` unchanged otherwise.  Over a grid decomposition
    ``stencil`` is the owned block and ``gather`` puts a scalar stencil
    together whole on every rank, so that every rank plans what the
    undecomposed run plans."""
    gather = gather or (lambda s: s)
    gmg_todo = cfg.gmg.coarsen == "adaptive" and cfg.gmg.level_factors is None
    gmg_t_todo = (cfg.gmg_t is not None and cfg.gmg_t.coarsen == "adaptive"
                  and cfg.gmg_t.level_factors is None)
    if not (gmg_todo or gmg_t_todo):
        return cfg
    dec = stencil.scale_rows(_decoupling_weights(stencil, cfg))
    if gmg_todo:
        schedule = plan_coarsening(gather(dec.scalar(0, 0)), cfg.gmg, theta=theta)
        cfg = dataclasses.replace(
            cfg, gmg=dataclasses.replace(cfg.gmg, level_factors=schedule))
    if gmg_t_todo:
        schedule_t = plan_coarsening(gather(dec.scalar(1, 1)), cfg.gmg_t, theta=theta)
        cfg = dataclasses.replace(
            cfg, gmg_t=dataclasses.replace(cfg.gmg_t, level_factors=schedule_t))
    return cfg


def cpr_setup(stencil: BlockStencil, cfg: CPRConfig = CPRConfig(),
              block=None) -> CPRState:
    """Build the preconditioner from the Jacobian stencil (per Newton
    iteration).  With ``block`` the decomposed form (see the module's
    docstring): ``stencil`` held on the block's extended block, D⁻¹, W and
    W·A pointwise there (right one cell into the ring, as far as the rbgs
    stage 2 reads them), the hierarchies, the zebra factor and the
    premasked halves from the owned rows, the couplings HaloStencils."""
    with span("pc_setup"):
        from thermalporous_torch.dist.halo import HaloStencil

        if block is None:
            wrap, own, make = (lambda s: s), (lambda t: t), CPRState
        else:
            wrap = lambda s: HaloStencil(s, block)
            own = lambda t: block.owned(t, lead=2)
            make = lambda **kw: BlockCPRState(block=block, **kw)
        dinv = stencil.diag_inverse()
        w = _decoupling_weights(stencil, cfg, dinv=dinv)
        dec = stencil.scale_rows(w)                     # W·A
        with span("gmg_setup").set("field", "p"):
            gmg_p = gmg_setup(dec.scalar(0, 0), cfg.gmg, block=block)
        state = make(stencil=stencil, dinv=dinv if cfg.stage2 == "rbgs" else own(dinv), w=own(w),
                     gmg_p=gmg_p, gmg_t=None, a_tp=None)
        if cfg.variant == "cptr":
            with span("gmg_setup").set("field", "T"):
                state.gmg_t = gmg_setup(dec.scalar(1, 1), cfg.gmg_t or cfg.gmg, block=block)
            state.a_tp = wrap(dec.scalar(1, 0))
            if cfg.batch_pt:
                if cfg.triangular:
                    raise ValueError(
                        "batch_pt requires triangular=False: the triangular T-residual "
                        "correction depends on e_p, so the two hierarchies cannot be "
                        "traversed together")
                if cfg.gmg_t is not None:
                    raise ValueError(
                        "batch_pt requires gmg_t=None: the stacked traversal needs "
                        "congruent p/T hierarchies")
                state.gmg_p, state.gmg_t = stack_states([state.gmg_p, state.gmg_t]), None
            if cfg.inner_iters > 0:
                state.pt = wrap(dec.block(slice(0, 2), slice(0, 2)))
            if cfg.s_stage != "none" and stencil.nc >= 3:
                state.a_sp, state.a_st, state.a_ss = (wrap(dec.scalar(2, c)) for c in range(3))
        op = wrap(stencil)
        if cfg.stage2 == "zebra":
            a = cfg.stage2_axis % stencil.dim
            state.zebra_fac = block_tridiag_factor(a, op.lower[a], op.diag, op.upper[a],
                                                   block=block)
        if cfg.stage2 == "bgmg":
            state.bgmg = block_gmg_setup(stencil, cfg.gmg, max_coarse_cells=cfg.bgmg_coarse_cells,
                                         block=block)
        if cfg.stage2 == "rbgs" and cfg.stage2_fused and cfg.stage2_axes is not None:
            d = own(dinv)
            red = kst.checkerboard(op.grid_shape, d.dtype, d.device, op.parity)
            state.dinv_red, state.dinv_black = red * d, (1.0 - red) * d
        return cast_coefficients(state, cfg.pc_dtype)


def _stage2_blocks(state: BlockCPRState, r: torch.Tensor, x1: torch.Tensor, k: int,
                   cfg: CPRConfig) -> torch.Tensor:
    """The stage 2 of a decomposed apply (``r`` and ``x1`` owned blocks)."""
    from thermalporous_torch.dist.halo import HaloStencil

    blk, st = state.block, state.stencil
    if cfg.stage2 == "rbgs" and cfg.stage2_axes is None:
        # r and x₁ through one exchange, the sweeps on the extended block in
        # the whole grid's colours (stage2_fused with the full coupling is
        # the same function as the kernels' zero-start sweep)
        ext = blk.extend(torch.cat([r, x1]), lead=1)
        r_ext, x1_ext = ext[:st.nc].contiguous(), ext[st.nc:].contiguous()
        if cfg.stage2_sweeps == 1:
            out = kst.fused_stage2_rbgs(st.coef, state.dinv, r_ext, x1_ext, parity=blk.parity)
            return blk.owned(out, lead=1)
        # r₂ right one cell into the ring, as far as the sweeps read it
        r2 = r_ext - (st.matvec_cols(x1_ext, k) if k < st.nc else st.matvec(x1_ext))
        x2 = block_red_black_gauss_seidel(st, state.dinv, r2, sweeps=cfg.stage2_sweeps,
                                          block=blk)
    else:
        op = HaloStencil(st, blk)
        r2 = r - (op.matvec_cols(x1, k) if k < st.nc else op.matvec(x1))
        if cfg.stage2 != "rbgs":
            x2 = _stage2_on(op, state, r2, cfg)
        elif cfg.stage2_fused:
            # the sparsified sweep on owned vectors in the block's colours;
            # the continuation sweeps take the full coupling on the kernels
            x2 = block_rbgs_fused_zero(op, state.dinv_red, state.dinv_black, r2,
                                       axes=cfg.stage2_axes)
            if cfg.stage2_sweeps > 1:
                x2 = block_red_black_gauss_seidel(st, state.dinv, blk.extend(r2, lead=1), x=x2,
                                                  sweeps=cfg.stage2_sweeps - 1, block=blk)
        else:
            x2 = block_red_black_gauss_seidel(op, blk.owned(state.dinv, lead=2), r2,
                                              sweeps=cfg.stage2_sweeps, axes=cfg.stage2_axes)
    x2[0:k] += x1
    return x2


def _stage2_on(st, state: CPRState, r2: torch.Tensor, cfg: CPRConfig) -> torch.Tensor:
    """The block-Jacobi, jacobi2, zebra or bgmg stage 2 of ``r2`` on the
    stencil ``st`` (a decomposed apply's: a HaloStencil, vectors owned)."""
    if cfg.stage2 == "block_jacobi":
        return apply_blocks(state.dinv, r2)
    if cfg.stage2 == "jacobi2":
        x2 = apply_blocks(state.dinv, r2)
        return x2 + cfg.stage2_omega * apply_blocks(state.dinv, r2 - st.matvec(x2))
    if cfg.stage2 == "zebra":
        return block_zebra_line_gs(st, r2, axis=cfg.stage2_axis, sweeps=cfg.stage2_sweeps,
                                   omega=cfg.stage2_omega, factor=state.zebra_fac)
    return block_gmg_apply(state.bgmg, r2, cfg.gmg, sweeps=cfg.stage2_sweeps,
                           cycles=cfg.bgmg_cycles)


def cast_coefficients(state: CPRState, pc_dtype: str) -> CPRState:
    """``state`` with its stored coefficients in bf16 as ``pc_dtype`` asks
    (the reference's groups, ``cpr.py:536-561``): "bf16" and "bf16_s2" the
    stage-2 stencil (a cast copy: the Newton operator's stencil is never
    cast), D⁻¹ and its premasked halves, and the ``bgmg`` hierarchy's level
    stencils and diagonal inverses; "bf16" and "bf16_gmg" the T←p coupling
    and both hierarchies' level stencils, the wide levels of weighted and
    variational transfers too — not their λ estimates, transfer weights or
    dense coarsest inverses (neither ``bgmg``'s); "bf16" also W, the (p, T)
    stencil and the saturation couplings.  The zebra factor, formed before,
    stays in full precision.  "f32" returns ``state`` unchanged.

    A decomposed state casts the same groups as they are held (the
    extended stage-2 stencil and D⁻¹, the couplings' HaloStencils through
    their ``map``, the decomposed and replicated levels): one rank's cast
    is the whole grid's cast, cut."""
    if pc_dtype == "f32":
        return state
    bf = lambda t: None if t is None else t.to(torch.bfloat16)
    to_bf = lambda c, lead: bf(c)
    cast = lambda s: (None if s is None else s.map(to_bf) if hasattr(s, "map")
                      else map_stencil(s, to_bf))
    levels = lambda g: None if g is None else dataclasses.replace(
        g, stencils=tuple(cast(s) for s in g.stencils))
    out = dataclasses.replace(state)
    if pc_dtype in ("bf16", "bf16_s2"):
        out.stencil = cast(state.stencil)
        out.dinv, out.dinv_red, out.dinv_black = (bf(state.dinv), bf(state.dinv_red),
                                                  bf(state.dinv_black))
        if state.bgmg is not None:
            out.bgmg = dataclasses.replace(
                state.bgmg, stencils=tuple(cast(s) for s in state.bgmg.stencils),
                dinvs=tuple(bf(d) for d in state.bgmg.dinvs))
    if pc_dtype in ("bf16", "bf16_gmg"):
        out.a_tp = cast(state.a_tp)
        out.gmg_p, out.gmg_t = levels(state.gmg_p), levels(state.gmg_t)
    if pc_dtype == "bf16":
        out.w = bf(state.w)
        out.pt = cast(state.pt)
        out.a_sp, out.a_st, out.a_ss = (cast(state.a_sp), cast(state.a_st), cast(state.a_ss))
    return out


def _s_smooth(a_ss: ScalarStencil, r_s: torch.Tensor, cfg: CPRConfig) -> torch.Tensor:
    """Approximate A_ss⁻¹ r_s with ``cfg.s_sweeps`` scalar smoother sweeps."""
    if cfg.s_stage == "rbgs":
        return red_black_gauss_seidel(a_ss, r_s, None, sweeps=cfg.s_sweeps)
    if cfg.s_stage == "zebra":
        return zebra_line_gs(a_ss, r_s, None, axis=cfg.s_axis, sweeps=cfg.s_sweeps)
    if cfg.s_stage == "line":
        return line_jacobi(a_ss, r_s, None, axis=cfg.s_axis, sweeps=cfg.s_sweeps)
    return weighted_jacobi(a_ss, r_s, None, sweeps=cfg.s_sweeps)


def _stage1_pt(state: CPRState, r_pt: torch.Tensor, cfg: CPRConfig) -> torch.Tensor:
    """Block-triangular (or block-diagonal) multigrid on the (p, T) system:
    p, then T with its residual corrected through the T←p coupling; with
    ``batch_pt`` both block-diagonal cycles in one batched traversal of the
    stacked hierarchy."""
    if cfg.batch_pt:
        return gmg_apply(state.gmg_p, r_pt.contiguous(), cfg.gmg)
    e_p = gmg_apply(state.gmg_p, r_pt[0], cfg.gmg)
    r_t = r_pt[1]
    if cfg.triangular:
        r_t = r_t - state.a_tp.matvec(e_p)
    e_t = gmg_apply(state.gmg_t, r_t, cfg.gmg_t or cfg.gmg)
    return torch.stack([e_p, e_t])


def _stage1(state: CPRState, w: torch.Tensor, cfg: CPRConfig) -> torch.Tensor:
    """x₁'s leading components (k, *grid): e_p (CPR), e_pt (CPTR), or all
    nc with the saturation leg."""
    if cfg.variant == "cpr":
        return gmg_apply(state.gmg_p, w[0], cfg.gmg)[None]
    r_pt = w[0:2]
    if cfg.inner_iters > 0 and cfg.inner_method == "richardson":
        # preconditioned Richardson: one application and inner_iters − 1
        # defect corrections
        e_pt = _stage1_pt(state, r_pt, cfg)
        for _ in range(cfg.inner_iters - 1):
            d = r_pt - state.pt.matvec(e_pt)
            e_pt = e_pt + _stage1_pt(state, d, cfg)
    elif cfg.inner_iters > 0:
        # [P2]'s inner iterations: FGMRES on the decoupled (p, T) system,
        # preconditioned by the single-pass block combination (imported
        # here: solve imports precond)
        from thermalporous_torch.solve.fgmres import fgmres

        mesh = state.block.mesh if isinstance(state, BlockCPRState) else None
        e_pt = fgmres(state.pt.matvec, r_pt,
                      precond=lambda q: _stage1_pt(state, q, cfg),
                      rtol=cfg.inner_rtol, maxiter=cfg.inner_iters, mesh=mesh).x
    else:
        e_pt = _stage1_pt(state, r_pt, cfg)
    if state.a_ss is None:
        return e_pt
    # the saturation leg: the S residual corrected through the S←(p, T)
    # couplings, then the decoupled S-S operator smoothed directly
    r_s = w[2] - state.a_sp.matvec(e_pt[0]) - state.a_st.matvec(e_pt[1])
    e_s = _s_smooth(state.a_ss, r_s, cfg)
    return torch.cat([e_pt, e_s[None]])


def cpr_apply(state: CPRState, r: torch.Tensor,
              cfg: CPRConfig = CPRConfig()) -> torch.Tensor:
    """Apply M⁻¹ to a state-shaped residual r (nc, *grid), or to this
    rank's owned block of it with a decomposed state."""
    with span("pc_apply"):
        w = apply_blocks(state.w, r)                    # decoupled residual W·r
        x1 = _stage1(state, w, cfg)                     # x₁ = [x1; 0]
        st = state.stencil
        k = x1.shape[0]
        if cfg.stage2 == "none" or not (cfg.stage2_cols and k < st.nc):
            # x₁ over all nc columns (zero-padded); with two unknowns or the
            # saturation leg it has full support, as in the reference
            x1 = torch.cat([x1, torch.zeros_like(r[k:])])
            k = st.nc
        if cfg.stage2 == "none":
            return x1
        if isinstance(state, BlockCPRState):
            return _stage2_blocks(state, r, x1, k, cfg)
        rbgs_kernel = cfg.stage2 == "rbgs" and cfg.stage2_axes is None
        if rbgs_kernel and cfg.stage2_sweeps == 1:
            return kst.fused_stage2_rbgs(st.coef, state.dinv, r, x1)
        r2 = r - (st.matvec_cols(x1, k) if k < st.nc else st.matvec(x1))
        if cfg.stage2 != "rbgs":
            x2 = _stage2_on(st, state, r2, cfg)
        elif rbgs_kernel:
            # with the full coupling stage2_fused is the same function as the
            # kernels' zero-start sweep
            x2 = block_red_black_gauss_seidel(st, state.dinv, r2, sweeps=cfg.stage2_sweeps)
        elif cfg.stage2_fused:
            x2 = block_rbgs_fused_zero(st, state.dinv_red, state.dinv_black, r2,
                                       axes=cfg.stage2_axes)
            if cfg.stage2_sweeps > 1:
                # the reference's continuation sweeps take the full coupling
                # (cpr.py:686-689); copied, pinned by the parity tests
                x2 = block_red_black_gauss_seidel(st, state.dinv, r2, x=x2,
                                                  sweeps=cfg.stage2_sweeps - 1)
        else:
            x2 = block_red_black_gauss_seidel(st, state.dinv, r2, sweeps=cfg.stage2_sweeps,
                                              axes=cfg.stage2_axes)
        x2[0:k] += x1
        return x2


def make_preconditioner(name: str, cfg: CPRConfig | None = None, block=None):
    """(setup, apply) closures of a named preconditioner: "none", "jacobi"
    (per-cell block Jacobi), "rbgs" (two red-black block Gauss–Seidel
    sweeps from zero), "lu" (the exact dense inverse; at most 20,000
    unknowns), "cpr" or "cptr".

    With ``block`` (a grid decomposition) setup takes the Jacobian held on
    the block's extended block and apply takes and returns owned blocks:
    "jacobi" the owned rows' inverse diagonal blocks, "rbgs" the kernels'
    sweeps on the extended block (the residual exchanged once, the whole
    grid's colours), "lu" the whole stencil gathered on every rank and
    inverted there, the whole residual gathered and the rank's part cut out
    of the product, "cpr"/"cptr" the decomposed :func:`cpr_setup`."""
    name = name.lower()
    if name == "none":
        return (lambda st: None, lambda state, r: r)
    if name == "lu":
        def lu_setup(st: BlockStencil) -> torch.Tensor:
            if block is not None:
                st = BlockStencil(block.gather(block.owned(st.coef, lead=3), lead=3))
            n = st.nc * math.prod(st.grid_shape)
            if n > 20000:
                raise ValueError(f"'lu' preconditioner is dense ({n}² entries); "
                                 "use it only on tiny grids")
            return dense_inv(st.to_dense())

        solve = lambda inv, r: (inv @ r.reshape(-1)).reshape(r.shape)
        if block is None:
            return lu_setup, solve
        return lu_setup, lambda inv, r: block.on_whole(lambda rr: solve(inv, rr), r, lead=1)
    if name == "jacobi":
        own = (lambda t: t) if block is None else (lambda t: block.owned(t, lead=2))
        return (lambda st: own(st.diag_inverse()),
                lambda dinv, r: apply_blocks(dinv, r))
    if name == "rbgs":
        ext = (lambda r: r) if block is None else (lambda r: block.extend(r, lead=1))
        return (lambda st: (st, st.diag_inverse()),
                lambda state, r: block_red_black_gauss_seidel(state[0], state[1], ext(r),
                                                              sweeps=2, block=block))
    if name in ("cpr", "cptr"):
        cfg = dataclasses.replace(cfg or CPRConfig(), variant=name)
        return (lambda st: cpr_setup(st, cfg, block=block),
                lambda state, r: cpr_apply(state, r, cfg))
    raise ValueError(f"unknown preconditioner {name!r}")
