"""Smoothers (counterpart of ``thermalporous_tpu/precond/chebyshev.py``):
Chebyshev, damped Jacobi, red-black Gauss–Seidel, line Jacobi and zebra
line Gauss–Seidel on scalar stencils; red-black block Gauss–Seidel (full or
with a sparsified coupling), the premasked zero-start block sweep, block
tridiagonal line solves and zebra block line Gauss–Seidel on block
stencils.

The Chebyshev smooth is the ``chebyshev_smooth`` kernel wrapper; the
red-black block Gauss–Seidel with the full coupling runs a zero-start sweep
through the ``fused_block_rbgs`` wrapper and every other sweep as two
``block_rbgs_half_sweep`` calls (``kernels/stencil.py``).  Everything else
here is plain PyTorch on either device, as the reference computes it in
jnp outside any Pallas kernel; its matvecs are the stencils' own (the
scalar and block matvec kernels on the card).  The line solves are
sequential recurrences along the line axis (``lax.scan`` in the
reference): here a host loop over that axis of batched small-block
operations, one step per plane; along an axis a grid decomposition splits,
a pipeline through the ranks (:meth:`Block.pipeline
<thermalporous_torch.dist.sharding.Block.pipeline>`), each rank's planes in
turn with the recurrence's carry handed on, bit for bit the whole grid's
solve.
"""

from __future__ import annotations

from typing import Sequence

import torch

from thermalporous_torch.core.stencil import (
    BlockStencil,
    ScalarStencil,
    apply_blocks,
    invert_blocks,
    multiply_blocks,
)
from thermalporous_torch.kernels import stencil as kst


def gershgorin_lambda_max(st) -> torch.Tensor:
    """Upper bound on the spectrum of D⁻¹A from Gershgorin rows (a 0-dim
    tensor on the stencil's device), for a scalar or a wide stencil."""
    return torch.max(st.row_abs_sum() / torch.abs(st.diag))


def chebyshev(
    st: ScalarStencil,
    b: torch.Tensor,
    x: torch.Tensor | None = None,
    degree: int = 3,
    lam_max: torch.Tensor | None = None,
    lam_min_frac: float = 0.25,
    lam_max_safety: float = 1.05,
    second: str | None = None,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """``degree`` Chebyshev iterations on D⁻¹A x = D⁻¹b from ``x`` (None =
    zero start) over [lam_min_frac·λmax, λmax·safety].  With ``second``
    ("residual" or "product") the result y comes with b − A·y or A·y: on a
    :class:`ScalarStencil` from the same kernel launch; any other stencil
    with ``matvec`` and ``diag`` (the wide multigrid levels of
    ``precond/transfer.py``) takes the plain iteration and a matvec after
    it, by its type."""
    if lam_max is None:
        lam_max = gershgorin_lambda_max(st)
    if isinstance(st, ScalarStencil):
        return kst.chebyshev_smooth(st.packed, b, x, lam_max, degree, lam_min_frac,
                                    lam_max_safety, second=second)
    y = chebyshev_plain(st, b, x, degree, lam_max, lam_min_frac, lam_max_safety)
    if second is None:
        return y
    ay = st.matvec(y)
    return y, (b - ay if second == "residual" else ay)


def chebyshev_plain(st, b: torch.Tensor, x: torch.Tensor | None, degree: int,
                    lam_max: torch.Tensor, lam_min_frac: float,
                    lam_max_safety: float = 1.05) -> torch.Tensor:
    """The reference's Chebyshev iteration for any stencil with ``matvec``
    and ``diag``, in plain PyTorch (from zero the first matvec is skipped:
    b − A·0 = b exactly)."""
    lmax = lam_max * lam_max_safety
    lmin = lam_max * lam_min_frac
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    inv_diag = 1.0 / st.diag
    if x is None:
        x = torch.zeros_like(b)
        z = inv_diag * b
    else:
        z = inv_diag * (b - st.matvec(x))
    d = z / theta
    rho = 1.0 / sigma1
    for _ in range(degree - 1):
        x = x + d
        z = inv_diag * (b - st.matvec(x))
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * z
        rho = rho_new
    return x + d


def weighted_jacobi(st: ScalarStencil, b: torch.Tensor, x: torch.Tensor | None = None,
                    sweeps: int = 2, omega: float = 0.8) -> torch.Tensor:
    """Damped Jacobi sweeps; from zero the first sweep is x = ωD⁻¹b with no
    matvec.  ω takes the stencil's dtype before the quotient, as the
    reference's weakly typed ω does: with bf16 coefficients that is
    bf16(0.8) = 0.80078125 (a Python float would divide in float32)."""
    inv_diag = torch.tensor(omega, dtype=st.diag.dtype, device=st.diag.device) / st.diag
    start = 0
    if x is None:
        x = torch.zeros_like(b)
        if sweeps >= 1:
            x = inv_diag * b
            start = 1
    for _ in range(start, sweeps):
        x = x + inv_diag * (b - st.matvec(x))
    return x


def red_black_gauss_seidel(st: ScalarStencil, b: torch.Tensor,
                           x: torch.Tensor | None = None, sweeps: int = 1) -> torch.Tensor:
    """Red-black Gauss–Seidel sweeps: each colour's update is a masked
    Jacobi step against the other colour's fresh values (the looped form
    from zero as well, as the reference runs it), in the colours of the
    whole grid (``st.parity``)."""
    red = kst.checkerboard(st.grid_shape, b.dtype, b.device, st.parity)
    black = 1.0 - red
    inv_diag = 1.0 / st.diag
    if x is None:
        x = torch.zeros_like(b)
    for _ in range(sweeps):
        x = x + red * inv_diag * (b - st.matvec(x))
        x = x + black * inv_diag * (b - st.matvec(x))
    return x


def _along(block, axis: int, sweep, start: tuple, reverse: bool = False):
    """``sweep(carry) -> (out, carry)`` of a recurrence along ``axis`` from
    the carry ``start``: through the ranks in turn
    (:meth:`~thermalporous_torch.dist.sharding.Block.pipeline`) when
    ``block`` decomposes the axis, at once otherwise.  Returns ``out``."""
    if block is not None and axis < 2:
        return block.pipeline(axis, sweep, start, reverse)
    return sweep(start)[0]


def _block_of(st):
    """The :class:`~thermalporous_torch.dist.sharding.Block` a decomposed
    stencil (a ``HaloStencil``) is held on, or None."""
    from thermalporous_torch.dist.halo import HaloStencil

    return st.block if isinstance(st, HaloStencil) else None


def tridiag_solve_along(axis: int, lower: torch.Tensor, diag: torch.Tensor,
                        upper: torch.Tensor, b: torch.Tensor, block=None) -> torch.Tensor:
    """Independent tridiagonal systems along ``axis``, batched over the
    other axes: the Thomas algorithm, a host loop over the line axis each
    way.  ``upper[i]`` couples i to i+1 (zero on the last slice),
    ``lower[i]`` couples i to i−1 (zero on the first).

    With ``block`` (a :class:`~thermalporous_torch.dist.sharding.Block`;
    the coefficients and ``b`` its owned rows) a decomposed line axis is
    solved as a pipeline: the elimination's carry (c, y) and the back
    substitution's x cross each rank boundary once, so that every rank
    does the whole-grid solve's operations in its order, bit for bit.

    Coefficients of another dtype than ``b`` (bf16 storage under
    ``CPRConfig.pc_dtype``) raise ``TypeError``, as the reference's
    ``lax.scan`` refuses them: its carry starts in the coefficients' dtype
    and the elimination of ``b`` returns the vector's."""
    if not lower.dtype == diag.dtype == upper.dtype == b.dtype:
        raise TypeError(f"tridiag_solve_along: coefficients of dtype {diag.dtype} with "
                        f"a right-hand side of {b.dtype} (the reference's scan carry "
                        "refuses them too)")
    mv = lambda a: torch.movedim(a, axis, 0)
    lo, d, up, rhs = mv(lower), mv(diag), mv(upper), mv(b)

    def forward(carry):
        c_prev, y_prev = carry
        cs, ys = [], []
        for i in range(d.shape[0]):
            denom = d[i] - lo[i] * c_prev
            c_prev = up[i] / denom
            y_prev = (rhs[i] - lo[i] * y_prev) / denom
            cs.append(c_prev)
            ys.append(y_prev)
        return (cs, ys), (c_prev, y_prev)

    def backward(carry):
        (x_next,) = carry
        xs = [None] * len(ys)
        for i in range(len(ys) - 1, -1, -1):
            x_next = ys[i] - cs[i] * x_next
            xs[i] = x_next
        return xs, (x_next,)

    zero = torch.zeros_like(d[0])
    cs, ys = _along(block, axis, forward, (zero, zero))
    xs = _along(block, axis, backward, (zero,), reverse=True)
    return torch.movedim(torch.stack(xs), 0, axis).contiguous()


def _line_mask(shape: Sequence[int], line_axis: int, color: int, dtype: torch.dtype,
               device: torch.device | str, offset: int = 0) -> torch.Tensor:
    """Checkerboard over the axes other than ``line_axis``: each line along
    it is one colour (the zebra 2-colouring); ``offset`` is the index sum of
    the grid's origin over those axes in a whole grid, mod 2."""
    parity = torch.full((), offset, dtype=torch.int64, device=device)
    for a, m in enumerate(shape):
        if a == line_axis % len(shape):
            continue
        view = [1] * len(shape)
        view[a] = m
        parity = parity + torch.arange(m, device=device).reshape(view)
    return (parity % 2 == color).to(dtype)


def line_jacobi(st: ScalarStencil, b: torch.Tensor, x: torch.Tensor | None = None,
                axis: int = -1, sweeps: int = 1, omega: float = 1.0) -> torch.Tensor:
    """Simultaneous line-Jacobi relaxation x ← x + ω·T⁻¹(b − A·x), T the
    tridiagonal part of A along ``axis``; from zero the first residual is b
    (no matvec).  On a decomposed stencil (a ``HaloStencil``) the line
    solves run through its block's ranks."""
    a = axis % st.dim
    lo, up = st.lower[a], st.upper[a]
    solve = lambda r: tridiag_solve_along(a, lo, st.diag, up, r,
                                          block=_block_of(st))
    start = 0
    if x is None:
        x = torch.zeros_like(b)
        if sweeps >= 1:
            x = omega * solve(b)
            start = 1
    for _ in range(start, sweeps):
        x = x + omega * solve(b - st.matvec(x))
    return x


def zebra_line_gs(st: ScalarStencil, b: torch.Tensor, x: torch.Tensor | None = None,
                  axis: int = -1, sweeps: int = 1) -> torch.Tensor:
    """Zebra (red-black line) Gauss–Seidel along ``axis``: exact line
    solves of the two line colours in turn, each against the other's fresh
    values, in the whole grid's line colours (``st.line_parity``); on a
    decomposed stencil the line solves run through its block's ranks."""
    a = axis % st.dim
    lo, up = st.lower[a], st.upper[a]
    solve = lambda r: tridiag_solve_along(a, lo, st.diag, up, r,
                                          block=_block_of(st))
    red = _line_mask(st.grid_shape, a, 0, b.dtype, b.device, st.line_parity(a))
    black = 1.0 - red
    if x is None:
        x = torch.zeros_like(b)
    for _ in range(sweeps):
        x = x + red * solve(b - st.matvec(x))
        x = x + black * solve(b - st.matvec(x))
    return x


def block_red_black_gauss_seidel(
    st: BlockStencil,
    dinv: torch.Tensor,
    b: torch.Tensor,
    x: torch.Tensor | None = None,
    sweeps: int = 1,
    axes: Sequence[int] | None = None,
    block=None,
) -> torch.Tensor:
    """``sweeps`` red-black block Gauss–Seidel sweeps on a block stencil from
    ``x`` (None = zero): each colour's cells get exact per-cell block solves
    (``dinv``, the inverse diagonal blocks) against the other colour's fresh
    values.

    With the full coupling (``axes`` None) it runs on the kernels: from
    zero the first sweep is the ``fused_block_rbgs`` kernel (the stage-2
    kernel with no x₁), every other sweep two ``block_rbgs_half_sweep``
    launches, red then black; on CPU tensors the wrappers' plain versions
    are the reference's looped form, statement by statement.

    ``axes`` restricts the coupling to those grid axes, D + offdiag(axes): a
    sparsified operator, not exact.  That route is chosen by configuration
    and is plain PyTorch on either device — the reference's own Pallas
    sweep takes no axes either — in the reference's looped form, from zero
    included, in the whole grid's colours (``st.parity``): on a decomposed
    ``HaloStencil`` with owned ``dinv``, ``b`` and ``x``.

    With ``block`` (a :class:`~thermalporous_torch.dist.sharding.Block` at
    least two cells deep, the full coupling) ``st``, ``dinv`` and ``b`` are
    held on its extended block, right at least one cell into the ring, and
    ``x`` and the result are owned blocks: the kernels run on the extended
    block in the whole grid's colours (``block.parity``), ``x`` exchanged
    once before each sweep that starts from it (the red cells of the ring's
    first layer then see their outer neighbours, so the black owned cells
    see fresh red values)."""
    if axes is None:
        p, own, ext = 0, (lambda t: t), (lambda t: t)
        if block is not None:
            p = block.parity
            own, ext = (lambda t: block.owned(t, lead=1)), (lambda t: block.extend(t, lead=1))
        if x is None:
            x = own(kst.fused_block_rbgs(st.coef, dinv, b, parity=p))
            sweeps -= 1
        for _ in range(sweeps):
            xe = kst.block_rbgs_half_sweep(st.coef, dinv, b, ext(x), 0, parity=p)
            x = own(kst.block_rbgs_half_sweep(st.coef, dinv, b, xe, 1, parity=p))
        return x
    red = kst.checkerboard(st.grid_shape, b.dtype, b.device, st.parity)
    black = 1.0 - red
    mv = lambda v: apply_blocks(st.diag, v) + st.matvec_offdiag(v, axes=axes)
    if x is None:
        x = torch.zeros_like(b)
    for _ in range(sweeps):
        x = x + red * apply_blocks(dinv, b - mv(x))
        x = x + black * apply_blocks(dinv, b - mv(x))
    return x


def block_rbgs_fused_zero(st: BlockStencil, dinv_red: torch.Tensor,
                          dinv_black: torch.Tensor, b: torch.Tensor,
                          axes: Sequence[int] | None = None) -> torch.Tensor:
    """One zero-start block red-black sweep with premasked diagonal inverses
    (``dinv_red`` = red·D⁻¹, ``dinv_black`` = black·D⁻¹, built at set-up):
    x_r = dinv_red·b, then x_r + dinv_black·(b − A_off·x_r), the black half
    without the diagonal term (x_r is zero on black cells).  With ``axes``
    the black half's coupling is restricted to those axes (not exact).
    Plain PyTorch; with the full coupling the same function is the
    ``fused_block_rbgs`` kernel."""
    x_red = apply_blocks(dinv_red, b)
    return x_red + apply_blocks(dinv_black, b - st.matvec_offdiag(x_red, axes=axes))


def block_tridiag_factor(axis: int, lower: torch.Tensor, diag: torch.Tensor,
                         upper: torch.Tensor, block=None) -> tuple[torch.Tensor, ...]:
    """Forward elimination of the block-tridiagonal part along ``axis``,
    once per set-up: ``(lo, c, dinv)`` in line-axis-major layout
    (n, nc, nc, *other), the Thomas multipliers c_i = (d_i − l_i c_{i−1})⁻¹
    u_i and the modified diagonal inverses.  With ``block`` (the blocks its
    owned rows) a decomposed axis is eliminated as a pipeline, c crossing
    each rank boundary once (:func:`tridiag_solve_along`)."""
    mvb = lambda a: torch.movedim(a, 2 + axis, 0)
    lo, d, up = mvb(lower), mvb(diag), mvb(upper)

    def forward(carry):
        (c_prev,) = carry
        cs, dinvs = [], []
        for i in range(d.shape[0]):
            dinv = invert_blocks(d[i] - multiply_blocks(lo[i], c_prev))
            c_prev = multiply_blocks(dinv, up[i])
            cs.append(c_prev)
            dinvs.append(dinv)
        return (cs, dinvs), (c_prev,)

    cs, dinvs = _along(block, axis, forward, (torch.zeros_like(d[0]),))
    return lo, torch.stack(cs), torch.stack(dinvs)


def block_tridiag_solve_factored(axis: int, factor: tuple[torch.Tensor, ...],
                                 b: torch.Tensor, block=None) -> torch.Tensor:
    """Solve with a :func:`block_tridiag_factor` (no block inversions): a
    host loop over the line axis each way; with ``block`` a pipeline
    through the ranks along a decomposed axis, y and x crossing each rank
    boundary once."""
    lo, c, dinv = factor
    rhs = torch.movedim(b, 1 + axis, 0)               # (n, nc, *other)

    def forward(carry):
        (y_prev,) = carry
        ys = []
        for i in range(rhs.shape[0]):
            y_prev = apply_blocks(dinv[i], rhs[i] - apply_blocks(lo[i], y_prev))
            ys.append(y_prev)
        return ys, (y_prev,)

    def backward(carry):
        (x_next,) = carry
        xs = [None] * len(ys)
        for i in range(len(ys) - 1, -1, -1):
            x_next = ys[i] - apply_blocks(c[i], x_next)
            xs[i] = x_next
        return xs, (x_next,)

    zero = torch.zeros_like(rhs[0])
    ys = _along(block, axis, forward, (zero,))
    xs = _along(block, axis, backward, (zero,), reverse=True)
    return torch.movedim(torch.stack(xs), 0, 1 + axis).contiguous()


def block_tridiag_solve_along(axis: int, lower: torch.Tensor, diag: torch.Tensor,
                              upper: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Independent block-tridiagonal systems along ``axis``: blocks
    (nc, nc, *grid) in the :class:`BlockStencil` convention, ``b`` (nc,
    *grid)."""
    return block_tridiag_solve_factored(
        axis, block_tridiag_factor(axis, lower, diag, upper), b)


def block_zebra_line_gs(
    st: BlockStencil,
    b: torch.Tensor,
    x: torch.Tensor | None = None,
    axis: int = 1,
    sweeps: int = 1,
    omega: float = 1.0,
    factor: tuple[torch.Tensor, ...] | None = None,
) -> torch.Tensor:
    """Zebra (red-black line) block Gauss–Seidel along ``axis``: exact block
    line solves of the two line colours in turn against the other's fresh
    values, under-relaxed by ``omega``; ``factor`` is the set-up's
    :func:`block_tridiag_factor` (computed here when None).  On a
    decomposed stencil (a ``HaloStencil``) the line colours are the whole
    grid's and the solves run through its block's ranks."""
    if x is None:
        x = torch.zeros_like(b)
    a = axis % st.dim
    block = _block_of(st)
    if factor is None:
        factor = block_tridiag_factor(a, st.lower[a], st.diag, st.upper[a], block=block)
    solve = lambda r: block_tridiag_solve_factored(a, factor, r, block=block)
    red = _line_mask(st.grid_shape, a, 0, b.dtype, b.device, st.line_parity(a))
    black = 1.0 - red
    for _ in range(sweeps):
        x = x + omega * red * solve(b - st.matvec(x))
        x = x + omega * black * solve(b - st.matvec(x))
    return x
