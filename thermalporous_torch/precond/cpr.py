"""The CPTR two-stage preconditioner (counterpart of
``thermalporous_tpu/precond/cpr.py:46-212, 363-712``).

    M⁻¹ r = x₁ + M₂⁻¹ (r − A x₁),   x₁ = stage1(W · r)

- decoupling W: Quasi-IMPES (the last unknown's column eliminated from
  the other equations with the cell's diagonal block);
- stage 1: the block-triangular (p, T) solve — multigrid on the decoupled
  pressure block, the T residual corrected through the T←p coupling,
  multigrid on the decoupled temperature block;
- stage 2: block Jacobi with the exact per-cell inverses, or ``sweeps``
  red-black block Gauss–Seidel sweeps (the flagship: one, which is the
  ``fused_block_rbgs`` kernel); its residual r − A·x₁ reads only the block
  columns x₁ lives on (``stage2_cols``).

Ported: the options of the benchmark step and of the flagship preset,
including the adaptive coarsening schedule (:func:`resolve_adaptive_coarsening`).
The CPR variant and the other stage-2 smoothers and decouplings raise
``NotImplementedError``; the reference's stage-2 variants ``stage2_fused``,
``stage2_axes`` and ``stage2_pallas`` (the CUDA sweep already is the fused
form), the block-diagonal stage 1, inner iterations, the saturation stage,
bf16 storage and the batched p/T traversal are not ported and have no
field.
"""

from __future__ import annotations

import dataclasses

import torch

from thermalporous_torch.core.stencil import BlockStencil, ScalarStencil, apply_blocks
from thermalporous_torch.precond.chebyshev import block_red_black_gauss_seidel
from thermalporous_torch.precond.gmg import (
    GMGConfig,
    GMGState,
    gmg_apply,
    gmg_setup,
    plan_coarsening,
)


@dataclasses.dataclass(frozen=True)
class CPRConfig:
    """Configuration of the two-stage preconditioner: the reference's fields
    that the port implements (see
    ``thermalporous_tpu/precond/cpr.py:CPRConfig``)."""

    stage2: str = "block_jacobi"     # ported: "block_jacobi", "rbgs"
    stage2_sweeps: int = 1           # rbgs sweeps
    stage2_cols: bool = True         # stage-2 residual over x₁'s columns only
    decoupling: str = "qimpes"       # ported: "qimpes"
    gmg: GMGConfig = GMGConfig()
    gmg_t: GMGConfig | None = None   # T hierarchy (None = ``gmg``)

    def __post_init__(self):
        if self.stage2 not in ("block_jacobi", "rbgs"):
            raise NotImplementedError(f"stage2 {self.stage2!r} is not ported")
        if self.stage2_sweeps < 1:
            raise ValueError(f"stage2_sweeps {self.stage2_sweeps} < 1")
        if self.decoupling != "qimpes":
            raise NotImplementedError(f"decoupling {self.decoupling!r} is not ported")


@dataclasses.dataclass
class CPRState:
    """Per-Newton-iteration preconditioner state."""

    stencil: BlockStencil            # the Jacobian stencil A
    dinv: torch.Tensor               # per-cell inverse diagonal blocks (stage 2)
    w: torch.Tensor                  # per-cell decoupling blocks W
    gmg_p: GMGState                  # hierarchy of the decoupled pressure block
    gmg_t: GMGState                  # hierarchy of the decoupled T block
    a_tp: ScalarStencil              # decoupled T-equation ← p-unknown coupling


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


def resolve_adaptive_coarsening(stencil: BlockStencil, cfg: CPRConfig,
                                theta: float = 0.25) -> CPRConfig:
    """Bake the matrix-dependent coarsening schedules into ``cfg`` (once,
    before the first step): for each hierarchy with ``coarsen="adaptive"``
    and no ``level_factors`` yet, :func:`plan_coarsening` of its decoupled
    block of ``stencil`` (pressure for ``gmg``, temperature for ``gmg_t``).
    Returns ``cfg`` unchanged otherwise."""
    gmg_todo = cfg.gmg.coarsen == "adaptive" and cfg.gmg.level_factors is None
    gmg_t_todo = (cfg.gmg_t is not None and cfg.gmg_t.coarsen == "adaptive"
                  and cfg.gmg_t.level_factors is None)
    if not (gmg_todo or gmg_t_todo):
        return cfg
    dec = stencil.scale_rows(_impes_weights(stencil.diag))
    if gmg_todo:
        schedule = plan_coarsening(dec.scalar(0, 0), cfg.gmg, theta=theta)
        cfg = dataclasses.replace(
            cfg, gmg=dataclasses.replace(cfg.gmg, level_factors=schedule))
    if gmg_t_todo:
        schedule_t = plan_coarsening(dec.scalar(1, 1), cfg.gmg_t, theta=theta)
        cfg = dataclasses.replace(
            cfg, gmg_t=dataclasses.replace(cfg.gmg_t, level_factors=schedule_t))
    return cfg


def cpr_setup(stencil: BlockStencil, cfg: CPRConfig = CPRConfig()) -> CPRState:
    w = _impes_weights(stencil.diag)                # Quasi-IMPES
    dec = stencil.scale_rows(w)                     # W·A
    return CPRState(stencil=stencil, dinv=stencil.diag_inverse(), w=w,
                    gmg_p=gmg_setup(dec.scalar(0, 0), cfg.gmg),
                    gmg_t=gmg_setup(dec.scalar(1, 1), cfg.gmg_t or cfg.gmg),
                    a_tp=dec.scalar(1, 0))


def _stage1_pt(state: CPRState, r_pt: torch.Tensor, cfg: CPRConfig) -> torch.Tensor:
    """Block-triangular multigrid on the (p, T) system: p, then T with its
    residual corrected through the T←p coupling."""
    e_p = gmg_apply(state.gmg_p, r_pt[0], cfg.gmg)
    r_t = r_pt[1] - state.a_tp.matvec(e_p)
    e_t = gmg_apply(state.gmg_t, r_t, cfg.gmg_t or cfg.gmg)
    return torch.stack([e_p, e_t])


def cpr_apply(state: CPRState, r: torch.Tensor,
              cfg: CPRConfig = CPRConfig()) -> torch.Tensor:
    """Apply M⁻¹ to a state-shaped residual r (nc, *grid)."""
    w = apply_blocks(state.w, r)                    # decoupled residual W·r
    e_pt = _stage1_pt(state, w[0:2], cfg)           # x₁ = [e_p, e_T, 0]
    if cfg.stage2_cols:
        r2 = r - state.stencil.matvec_cols(e_pt, 2)
    else:
        x1 = torch.zeros_like(r)
        x1[0:2] = e_pt
        r2 = r - state.stencil.matvec(x1)
    if cfg.stage2 == "rbgs":
        x2 = block_red_black_gauss_seidel(state.stencil, state.dinv, r2,
                                          sweeps=cfg.stage2_sweeps)
    else:
        x2 = apply_blocks(state.dinv, r2)
    x2[0:2] += e_pt
    return x2


def make_preconditioner(name: str, cfg: CPRConfig | None = None):
    """(setup, apply) closures of a named preconditioner: "none", "jacobi"
    (per-cell block Jacobi) or "cptr".  "cpr", "rbgs" and "lu" are not
    ported."""
    name = name.lower()
    if name == "none":
        return (lambda st: None, lambda state, r: r)
    if name == "jacobi":
        return (lambda st: st.diag_inverse(),
                lambda dinv, r: apply_blocks(dinv, r))
    if name == "cptr":
        cfg = cfg or CPRConfig()
        return (lambda st: cpr_setup(st, cfg),
                lambda state, r: cpr_apply(state, r, cfg))
    if name in ("cpr", "rbgs", "lu"):
        raise NotImplementedError(f"preconditioner {name!r} is not ported")
    raise ValueError(f"unknown preconditioner {name!r}")
