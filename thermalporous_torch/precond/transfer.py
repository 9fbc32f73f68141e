"""Operator-weighted and variational multigrid transfers, and the wide
stencil classes of their coarse levels (counterpart of
``thermalporous_tpu/precond/transfer.py``).

- :class:`WideStencil` — a scalar stencil over the full 3^dim neighbour
  box, one ``(3,)*dim + grid`` coefficient tensor: the coarse levels of the
  "weighted" transfer.
- :func:`transfer_weights` — per-axis two-point interpolation weights from
  the level operator's own |couplings| (a fine cell's error is the
  |coupling|-weighted average of its parent coarse cell and the coarse cell
  across its outer face), the parent weight floored at ``floor``; the
  full-shape zero-boundary convention makes domain edges inject.
- :func:`prolong_weighted` — P applied axis by axis (axis 0 first).
- :func:`galerkin_wide` — A_c = R·A·P with R the summation restriction, by
  3^dim-colour probing (the coarse operator stays in the 9/27-point class).
- :class:`BoxStencil` — a scalar stencil over a per-axis offset box of
  static half-widths: the coarse levels of the "variational" transfer.
- :func:`restrict_weighted` — R = Pᵀ, the exact adjoint of P.
- :func:`galerkin_variational` — A_c = Pᵀ·A·P exactly, by per-axis
  coefficient conjugation (support ±2 only along the axes a level
  coarsened).

Everything here is shifts and elementwise arithmetic on full-shape tensors
(the zero-filled shifts of ``core/grid.py``), plain PyTorch on either
device: the reference computes it in jnp outside any Pallas kernel.  The
wide classes' matvecs are 9/27 (or up to 125) shifted products; multigrid
smooths such levels with the plain Chebyshev or Jacobi smoother and never
hands them to a kernel (``precond/gmg.py`` routes by type).  Weights use
|coupling|, so intermediate Galerkin levels need not be M-matrices.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import torch

from thermalporous_torch.core.grid import shift_minus, shift_plus
from thermalporous_torch.core.stencil import ScalarStencil


def _blocksum(x: torch.Tensor, fine_shape, factors=None, lead: int = 0) -> torch.Tensor:
    # imported here: gmg imports this module
    from thermalporous_torch.precond.gmg import _blocksum as bs

    return bs(x, fine_shape, factors, lead)


def _shift(v: torch.Tensor, off, lead: int) -> torch.Tensor:
    """``v`` shifted by the offset vector ``off`` ∈ {0, 1, 2}^dim of a 3^dim
    box: 2 brings v[i+1] to i along that axis, 0 brings v[i−1]."""
    for a, o in enumerate(off):
        if o == 2:
            v = shift_minus(v, a, lead=lead)
        elif o == 0:
            v = shift_plus(v, a, lead=lead)
    return v


@dataclasses.dataclass
class WideStencil:
    """Scalar stencil over the full 3^dim neighbour box: ``coef[o0, o1(,
    o2)]`` couples cell i to i + (o − 1) per axis; couplings that point
    outside the domain are zero (the full-shape convention)."""

    coef: torch.Tensor   # (3,)*dim + grid

    @property
    def dim(self) -> int:
        return self.coef.dim() // 2

    @property
    def grid_shape(self) -> tuple[int, ...]:
        return tuple(self.coef.shape[self.dim:])

    @property
    def diag(self) -> torch.Tensor:
        return self.coef[(1,) * self.dim]

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """A·v for ``v`` of the grid's shape, or with leading batch axes."""
        lead = v.dim() - self.dim
        y = torch.zeros_like(v)
        for off in itertools.product((0, 1, 2), repeat=self.dim):
            y = y + self.coef[off] * _shift(v, off, lead)
        return y

    def row_abs_sum(self) -> torch.Tensor:
        flat = self.coef.reshape((3 ** self.dim,) + self.grid_shape)
        return torch.sum(torch.abs(flat), dim=0)

    def to_dense(self) -> torch.Tensor:
        """Dense (N, N) matrix (the coarsest level, tests)."""
        return _dense(self)


def _dense(st) -> torch.Tensor:
    n = math.prod(st.grid_shape)
    eye = torch.eye(n, dtype=st.coef.dtype, device=st.coef.device)
    return st.matvec(eye.reshape((n,) + st.grid_shape)).reshape(n, n).T


def as_wide(st: ScalarStencil) -> WideStencil:
    """A 5/7-point :class:`ScalarStencil` embedded in the wide class
    (exact)."""
    dim = st.dim
    coef = torch.zeros((3,) * dim + st.grid_shape, dtype=st.diag.dtype,
                       device=st.diag.device)
    coef[(1,) * dim] = st.diag
    for a in range(dim):
        coef[tuple(2 if i == a else 1 for i in range(dim))] = st.upper[a]
        coef[tuple(0 if i == a else 1 for i in range(dim))] = st.lower[a]
    return WideStencil(coef)


def _axis_couplings(st, a: int) -> tuple[torch.Tensor, torch.Tensor]:
    """|coupling| of each cell to its −a and +a sides: the axis-aligned
    entries of a scalar or wide stencil; a box level (variational
    hierarchy) sums |coef| over every offset on each side of axis ``a``."""
    if isinstance(st, BoxStencil):
        hw = st.half_widths
        lo = torch.zeros(st.grid_shape, dtype=st.coef.dtype, device=st.coef.device)
        up = torch.zeros_like(lo)
        for off in itertools.product(*[range(2 * h + 1) for h in hw]):
            o = off[a] - hw[a]
            if o < 0:
                lo = lo + torch.abs(st.coef[off])
            elif o > 0:
                up = up + torch.abs(st.coef[off])
        return lo, up
    if isinstance(st, WideStencil):
        dim = st.dim
        lo = st.coef[tuple(0 if i == a else 1 for i in range(dim))]
        up = st.coef[tuple(2 if i == a else 1 for i in range(dim))]
    else:
        lo, up = st.lower[a], st.upper[a]
    return torch.abs(lo), torch.abs(up)


@dataclasses.dataclass
class AxisWeights:
    """Interpolation weights of one coarsened axis at the shape that axis's
    prolongation applies them: ``w_self`` multiplies the parent coarse
    value, ``w_out`` the coarse neighbour across the cell's outer face
    (w_self + w_out = 1)."""

    w_self: torch.Tensor
    w_out: torch.Tensor


def _axis_index(shape, a: int, device) -> torch.Tensor:
    return torch.arange(shape[a], device=device).reshape(
        tuple(shape[a] if i == a else 1 for i in range(len(shape))))


def _axis_weights(wl: torch.Tensor, wr: torch.Tensor, a: int,
                  floor: float = 0.75) -> AxisWeights:
    """Resistance-calibrated 1D weights from |couplings| ``wl`` (−a) and
    ``wr`` (+a): an even child takes 3·wr/(3·wr + wl) of its parent (¾ in
    a homogeneous field), an odd child mirrors; the parent share is floored
    at ``floor``; a cell with no coupling, and the lone even child at the
    end of an odd-length axis, inject from the parent."""
    idx = _axis_index(wl.shape, a, wl.device)
    even = idx % 2 == 0
    se = 3.0 * wr + wl
    so = 3.0 * wl + wr
    w_par_even = torch.where(se > 0, 3.0 * wr / torch.where(se > 0, se, 1.0), 1.0)
    w_par_odd = torch.where(so > 0, 3.0 * wl / torch.where(so > 0, so, 1.0), 1.0)
    w_self = torch.clamp(torch.where(even, w_par_even, w_par_odd), min=floor)
    lone = even & (idx == wl.shape[a] - 1)
    w_self = torch.where(lone, 1.0, w_self)
    return AxisWeights(w_self=w_self, w_out=1.0 - w_self)


def _even_mask(shape, a: int, dtype: torch.dtype, device) -> torch.Tensor:
    return (_axis_index(shape, a, device) % 2 == 0).to(dtype)


def _subsample(x: torch.Tensor, axes) -> torch.Tensor:
    """Even-index subsample along ``axes`` (mask and pairwise block sum, as
    the reference forms it)."""
    for a in axes:
        mask = _even_mask(x.shape, a, x.dtype, x.device)
        fac = tuple(2 if i == a else 1 for i in range(x.dim()))
        x = _blocksum(x * mask, x.shape, fac)
    return x


def transfer_weights(st, factors: tuple[int, ...],
                     floor: float = 0.75) -> tuple[AxisWeights | None, ...]:
    """The weights of every coarsened axis of this level (None on factor-1
    axes).  Axis a's weights are applied once the lower coarsened axes are
    at fine resolution and the higher ones still coarse, so they are the
    fine weights even-subsampled along the higher coarsened axes."""
    dim = len(factors)
    out: list[AxisWeights | None] = []
    for a in range(dim):
        if factors[a] != 2:
            out.append(None)
            continue
        wl, wr = _axis_couplings(st, a)
        aw = _axis_weights(wl, wr, a, floor=floor)
        higher = tuple(b for b in range(a + 1, dim) if factors[b] == 2)
        out.append(AxisWeights(w_self=_subsample(aw.w_self, higher),
                               w_out=_subsample(aw.w_out, higher)))
    return tuple(out)


def _prolong_axis(e: torch.Tensor, fine_n: int, a: int, w: AxisWeights) -> torch.Tensor:
    """1D weighted prolongation along axis ``a`` (coarse → ``fine_n``)."""
    inj = torch.repeat_interleave(e, 2, dim=a)
    if inj.shape[a] != fine_n:
        inj = inj.narrow(a, 0, fine_n)
    even = _even_mask(inj.shape, a, inj.dtype, inj.device)
    # the outer coarse neighbour: for an even cell the injected value at
    # f−1 (the previous coarse cell), for an odd cell at f+1
    outer = even * shift_plus(inj, a, lead=0) + (1.0 - even) * shift_minus(inj, a, lead=0)
    return w.w_self * inj + w.w_out * outer


def prolong_weighted(e: torch.Tensor, fine_shape: tuple[int, ...],
                     weights: tuple[AxisWeights | None, ...]) -> torch.Tensor:
    """P·e, axis by axis (axis 0 first)."""
    for a, w in enumerate(weights):
        if w is not None:
            e = _prolong_axis(e, fine_shape[a], a, w)
    return e


def galerkin_wide(st, weights: tuple[AxisWeights | None, ...],
                  coarse_shape: tuple[int, ...], origin=None) -> WideStencil:
    """A_c = R·A·P (R the summation restriction) by 3^dim-colour probing:
    the composed operator applied to the coarse indicator of each colour
    k ∈ {0, 1, 2}^dim (cells ≡ k mod 3); entry (i → i + o − 1) of A_c is
    read off the probe of the colour of the target cell, with residue masks
    instead of a gather, as the reference extracts it.  Exact for coarse
    support |i − j| ≤ 1 per axis, which this pair guarantees.  ``origin``
    (a decomposed level's extended block) is the coarse grid's index of the
    held grid's first cell per axis: the colours are the whole grid's."""
    dim = len(coarse_shape)
    fine_shape = st.grid_shape
    dtype, dev = st.diag.dtype, st.diag.device
    factors = tuple(2 if c < f else 1 for f, c in zip(fine_shape, coarse_shape))
    idx = [_axis_index(coarse_shape, a, dev) for a in range(dim)]
    origin = origin or (0,) * dim
    masks = []
    for k in itertools.product((0, 1, 2), repeat=dim):
        mask = torch.ones(coarse_shape, dtype=dtype, device=dev)
        for a in range(dim):
            mask = mask * ((idx[a] + origin[a]) % 3 == k[a]).to(dtype)
        masks.append(mask)
    probes = [_blocksum(st.matvec(prolong_weighted(m, fine_shape, weights)),
                        fine_shape, factors) for m in masks]
    coefs = []
    for off in itertools.product((0, 1, 2), repeat=dim):
        inside = torch.ones(coarse_shape, dtype=torch.bool, device=dev)
        for a in range(dim):
            j = idx[a] + (off[a] - 1)
            inside = inside & (j >= 0) & (j < coarse_shape[a])
        acc = torch.zeros(coarse_shape, dtype=dtype, device=dev)
        # a row cell of whole-grid colour r reads its coupling to the cell
        # at offset o − 1 off the probe of colour r + o − 1
        for ri, r in enumerate(itertools.product((0, 1, 2), repeat=dim)):
            c = 0
            for a in range(dim):
                c = c * 3 + (r[a] + off[a] - 1) % 3
            acc = acc + masks[ri] * probes[c]
        coefs.append(torch.where(inside, acc, 0.0))
    return WideStencil(torch.stack(coefs).reshape((3,) * dim + tuple(coarse_shape)))


# --------------------------------------------------------------------------
# The variational pair: R = Pᵀ, A_c = Pᵀ·A·P on a box of per-axis widths
# --------------------------------------------------------------------------


def _shift_k(x: torch.Tensor, a: int, k: int) -> torch.Tensor:
    """``x[i] ← x[i+k]`` along axis ``a``, zero-filled."""
    for _ in range(abs(k)):
        x = shift_minus(x, a, lead=0) if k > 0 else shift_plus(x, a, lead=0)
    return x


def _shift_table(base: torch.Tensor, offs, lead: int) -> dict:
    """offset → ``base`` shifted by the whole offset vector (zero-filled),
    each entry one unit shift of an entry nearer the origin."""
    table: dict = {}

    def build(off):
        if off in table:
            return table[off]
        if not any(off):
            out = base
        else:
            b = next(i for i, o in enumerate(off) if o)
            s = 1 if off[b] > 0 else -1
            p = build(off[:b] + (off[b] - s,) + off[b + 1:])
            out = shift_minus(p, b, lead=lead) if s > 0 else shift_plus(p, b, lead=lead)
        table[off] = out
        return out

    for off in sorted(offs, key=lambda o: sum(map(abs, o))):
        build(off)
    return table


@dataclasses.dataclass
class BoxStencil:
    """Scalar stencil over a static per-axis offset box: ``coef[i0, i1(,
    i2)]`` couples cell c to c + (i_a − hw_a) per axis, with half-width
    ``hw_a = (coef.shape[a] − 1) // 2``; out-of-domain couplings are zero."""

    coef: torch.Tensor   # (w0, ..., w_{dim−1}) + grid, each w odd

    @property
    def dim(self) -> int:
        return self.coef.dim() // 2

    @property
    def grid_shape(self) -> tuple[int, ...]:
        return tuple(self.coef.shape[self.dim:])

    @property
    def half_widths(self) -> tuple[int, ...]:
        return tuple((w - 1) // 2 for w in self.coef.shape[: self.dim])

    @property
    def diag(self) -> torch.Tensor:
        return self.coef[self.half_widths]

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """A·v for ``v`` of the grid's shape, or with leading batch axes."""
        lead = v.dim() - self.dim
        offs = list(itertools.product(*[range(-h, h + 1) for h in self.half_widths]))
        table = _shift_table(v, offs, lead=lead)
        w = torch.stack([table[o] for o in offs])
        flat = self.coef.reshape((len(offs),) + self.grid_shape)
        return torch.sum(flat.reshape(flat.shape[:1] + (1,) * lead + flat.shape[1:]) * w,
                         dim=0)

    def row_abs_sum(self) -> torch.Tensor:
        flat = self.coef.reshape((-1,) + self.grid_shape)
        return torch.sum(torch.abs(flat), dim=0)

    def to_dense(self) -> torch.Tensor:
        """Dense (N, N) matrix (the coarsest level, tests)."""
        return _dense(self)


def _coef_dict(st) -> dict:
    """Signed offset → coefficient tensor, the offsets the stencil has."""
    if isinstance(st, BoxStencil):
        hw = st.half_widths
        return {tuple(o - h for o, h in zip(off, hw)): st.coef[off]
                for off in itertools.product(*[range(2 * h + 1) for h in hw])}
    dim = len(st.grid_shape)
    out = {(0,) * dim: st.diag}
    for a in range(dim):
        out[tuple(1 if i == a else 0 for i in range(dim))] = st.upper[a]
        out[tuple(-1 if i == a else 0 for i in range(dim))] = st.lower[a]
    return out


def _box_from_dict(coefs: dict, shape: tuple[int, ...]) -> BoxStencil:
    dim = len(shape)
    hw = tuple(max(abs(off[a]) for off in coefs) for a in range(dim))
    widths = tuple(2 * h + 1 for h in hw)
    zero = torch.zeros(shape, dtype=next(iter(coefs.values())).dtype,
                       device=next(iter(coefs.values())).device)
    rows = [coefs.get(tuple(i[a] - hw[a] for a in range(dim)), zero)
            for i in itertools.product(*[range(w) for w in widths])]
    return BoxStencil(torch.stack(rows).reshape(widths + tuple(shape)))


def restrict_weighted(r: torch.Tensor,
                      weights: tuple[AxisWeights | None, ...]) -> torch.Tensor:
    """R·r with R = Pᵀ, the exact adjoint of :func:`prolong_weighted`: the
    highest axis's adjoint first.  Per axis, coarse j collects the parent
    weights of its children (2j, 2j+1) and the outer weights of the fine
    cells whose outer coarse cell is j (even 2j+2, odd 2j−1)."""
    for a in reversed(range(len(weights))):
        w = weights[a]
        if w is None:
            continue
        shape = r.shape
        even = _even_mask(shape, a, r.dtype, r.device)
        odd = 1.0 - even
        g = w.w_out * r
        t = even * (_shift_k(g * even, a, 2) + _shift_k(g * odd, a, -1))
        factors = tuple(2 if i == a else 1 for i in range(r.dim()))
        r = _blocksum(w.w_self * r + t, shape, factors)
    return r


def _conjugate_axis(coefs: dict, a: int, w: AxisWeights) -> dict:
    """Pᵀ·Ã·P along axis ``a`` on offset → coefficient dicts (exact): with
    fine rows f = 2j + r and P's columns folded into residue-masked weights
    q_r (q_0/q_1 the parent weights on even/odd cells, q_{−1}/q_2 the outer
    ones), c_d[j] = Σ_{r,r'} q_r[f]·ã_δ[f]·q_{r'}[f+δ], δ = 2d + r' − r."""
    any_t = next(iter(coefs.values()))
    shape = tuple(any_t.shape)
    even = _even_mask(shape, a, any_t.dtype, any_t.device)
    odd = 1.0 - even
    rs = (-1, 0, 1, 2)
    q = {0: w.w_self * even, 1: w.w_self * odd, -1: w.w_out * odd, 2: w.w_out * even}
    offs = sorted(coefs)
    q_stack = torch.stack([q[r].expand(shape) for r in rs])
    table = _shift_table(q_stack, offs, lead=1)
    acc: dict = {}
    for ir, r in enumerate(rs):
        for irp, rp in enumerate(rs):
            sel = [o for o in offs if (o[a] + r - rp) % 2 == 0
                   and abs((o[a] + r - rp) // 2) <= 2]
            if not sel:
                continue
            C = torch.stack([coefs[o] for o in sel])
            Q = torch.stack([table[o][irp] for o in sel])
            g = q_stack[ir] * C * Q
            # land fine row 2j + r on the residue the block sum reads
            if r == -1:
                g = even * shift_plus(g, a, lead=1)
            elif r == 2:
                g = even * shift_minus(shift_minus(g, a, lead=1), a, lead=1)
            elif r == 0:
                g = even * g
            else:
                g = odd * g
            for i, o in enumerate(sel):
                key = o[:a] + ((o[a] + r - rp) // 2,) + o[a + 1:]
                acc[key] = acc[key] + g[i] if key in acc else g[i]
    out_keys = sorted(acc)
    x = torch.stack([acc[k] for k in out_keys])
    x = _blocksum(x, shape, tuple(2 if i == a else 1 for i in range(len(shape))), lead=1)
    return {k: x[i] for i, k in enumerate(out_keys)}


def galerkin_variational(st, weights: tuple[AxisWeights | None, ...],
                         coarse_shape: tuple[int, ...]) -> BoxStencil:
    """A_c = Pᵀ·A·P, exact, by conjugating the highest coarsened axis first
    (where the weights from :func:`transfer_weights` sit at the current
    mixed shape); the result keeps minimal per-axis widths."""
    coefs = _coef_dict(st)
    for a in reversed(range(len(coarse_shape))):
        if weights[a] is not None:
            coefs = _conjugate_axis(coefs, a, weights[a])
    return _box_from_dict(coefs, tuple(coarse_shape))


def is_wide(st) -> bool:
    """Whether a multigrid level is of the wide classes (no kernel takes it)."""
    return isinstance(st, (WideStencil, BoxStencil))
