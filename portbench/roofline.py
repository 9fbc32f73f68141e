"""Each kernel call's least time on the card: the larger of the bytes its
function must move over the HBM rate and its operations over the float32
rate, worked out from the call's argument shapes and dtypes (each input
read once, each output written once).

The reckoning is a frozen copy of ``chip_smoke.py``'s ``cost_*``
functions, ``model_ops`` and ``bound_ms`` with its peaks; ``n`` cells,
``dim`` axes, ``item`` bytes per vector value, ``citem`` per stored
coefficient (2 with bf16 coefficients; None: ``item``).
"""

from __future__ import annotations

import math

# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s and FP32 outside the
# tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def cost_block_matvec(n, dim, nc, k, item, citem=None):
    return (((2 * dim + 1) * nc * k * (citem or item) + (k + nc) * item) * n,
            2 * (2 * dim + 1) * nc * k * n)


def cost_matvec(n, dim, item, citem=None):
    return ((2 * dim + 1) * (citem or item) + 2 * item) * n, 2 * (2 * dim + 1) * n


def cost_chebyshev(n, dim, degree, from_x0, item, citem=None):
    mv = 2 * (2 * dim + 1) * n
    ops = (mv if from_x0 else 0) + 3 * n + (degree - 1) * (mv + 7 * n) + n
    return ((2 * dim + 1) * (citem or item) + (2 + int(from_x0)) * item) * n, ops


def cost_chebyshev_second(n, dim, degree, from_x0, kind, item, citem=None):
    """The smooth with its second output: one more vector out, one more
    product (and a subtraction for the residual)."""
    nbytes, ops = cost_chebyshev(n, dim, degree, from_x0, item, citem)
    return nbytes + n * item, ops + 2 * (2 * dim + 1) * n + (n if kind == "residual" else 0)


# Operations of one residual evaluation, per cell, per well cell and per
# face, counted from csrc/residual.cu's device physics (see chip_smoke.py)
OPS_TP = dict(cell=43, old=29, well=46, face=81)
OPS_SP = dict(cell=23, old=14, well=21, face=35)


def model_ops_counts(nc, grid, n_well, inflow, pows):
    """(arithmetic operations without the old accumulation, those of the old
    accumulation, transcendentals) of one residual evaluation on ``grid``
    with ``n_well`` well cells, ``inflow`` injecting BHP well cells and
    ``pows`` Corey exponents other than 2."""
    dim, n = len(grid), math.prod(grid)
    faces = sum(n - n // e for e in grid)
    if nc == 2:
        ops, mus, extra = OPS_SP, 1, 0
    else:
        ops, mus = OPS_TP, 2
        extra = inflow + pows * (n_well + faces)
    arith = ops["cell"] * n + ops["well"] * n_well + ops["face"] * faces
    return arith, ops["old"] * n, mus * (n_well + faces) + extra


def model_bytes(nc, grid, item):
    # the state (u and u_old, or u and v) and the fields in, the result out
    return (3 * nc + 2 * len(grid) + 7) * math.prod(grid) * item


def cost_residual_counts(nc, grid, n_well, inflow, pows, item):
    # each transcendental counted as 16 operations (the SM's FP32 :
    # special-function rate)
    arith, old, trans = model_ops_counts(nc, grid, n_well, inflow, pows)
    return model_bytes(nc, grid, item), arith + old + 16 * trans


def cost_jvp_counts(nc, grid, n_well, inflow, pows, item):
    # no u_old and none of its operations; a dual-number operation is about
    # three of its primal's, a transcendental one evaluation and two products
    arith, _, trans = model_ops_counts(nc, grid, n_well, inflow, pows)
    return model_bytes(nc, grid, item), 3 * arith + 18 * trans


def cost_stage2(n, dim, nc, k, item, citem=None):
    """The stage 2 after x1 = [x1_cols; 0] over k columns (k = 0: the
    zero-start sweep alone)."""
    nb = n // 2
    coefs = (2 * dim + 1) * nc * k * n + nb * 2 * dim * nc * (nc - k) + nc * nc * n
    ops = (n * (2 * (2 * dim + 1) * nc * k + nc + 2 * nc * nc + k)
           + nb * (2 * 2 * dim * nc * nc + nc))
    return coefs * (citem or item) + (2 * nc + k) * n * item, ops


def cost_half(n, dim, nc, item, citem=None):
    """One red-black half-sweep."""
    nh = -(-n // 2)
    nbytes = nh * (((2 * dim + 1) * nc * nc + nc * nc) * (citem or item) + nc * item)
    return nbytes + 2 * nc * n * item, nh * (2 * (2 * dim + 1) * nc * nc + 2 * nc * nc + 2 * nc)


def cost_deep(shapes, degree, cycle_type, kmin, item, citem=None, batch=1):
    """Bytes: every level's stencil, the dense inverse, rc and the output,
    once.  Operations: the recursion's passes, walked as the kernel walks
    them."""
    sizes = [math.prod(s) for s in shapes]
    last = len(shapes) - 1
    mv = [2 * (2 * len(s) + 1) * m for s, m in zip(shapes, sizes)]

    def smooth(ell, zero):
        n = sizes[ell]
        return (0 if zero else mv[ell] + n) + 3 * n + (degree - 1) * (mv[ell] + 7 * n) + n

    def cycle(ell):
        if ell == last:
            return 2 * sizes[ell] ** 2
        n = sizes[ell]
        return smooth(ell, True) + mv[ell] + 2 * n + corr(ell + 1) + n + smooth(ell, False)

    def corr(ell):
        ops = cycle(ell)
        if cycle_type != "v" and ell < last and sizes[ell] >= kmin:
            extra = (2 * mv[ell] + 16 * sizes[ell] if cycle_type == "k"
                     else mv[ell] + 2 * sizes[ell])
            ops += cycle(ell) + extra
        return ops

    nbytes = (sum((2 * len(s) + 1) * m for s, m in zip(shapes, sizes)) * (citem or item)
              + (sizes[-1] ** 2 + 2 * sizes[0]) * item)
    return batch * nbytes, batch * corr(0)


# ------------------------------------------------ a call's least time

def _arg(args, kw, i, name, default=None):
    return args[i] if len(args) > i else kw.get(name, default)


def _well_counts(model, u, data, cache: dict):
    """(well cells, injecting BHP well cells, Corey exponents other than 2)
    of ``data``: counted at the first call on ``data`` (one transfer), then
    kept in ``cache``; the injecting cells are those of that first state."""
    held = cache.get(id(data.fields))
    if held is None:
        dim = len(model.grid.shape)
        wi, pbh, _, has_tinj, qrate = data.fields[2 * dim + 1:2 * dim + 6]
        n_well = int(((wi != 0) | (qrate != 0)).sum())
        inflow = int(((wi != 0) & (pbh - u[0] >= 0) & (has_tinj > 0.5)).sum())
        pows = 0
        if model.nc == 3:
            rp = model.relperm
            pows = int(rp.n_w != 2) + int(rp.n_o != 2)
        held = cache[id(data.fields)] = (n_well, inflow, pows)
    return held


def _cost(name, args, kw, cache):
    if name == "block_matvec":
        coef, v, k = _arg(args, kw, 0, "coef"), _arg(args, kw, 1, "v"), _arg(args, kw, 2, "k")
        return cost_block_matvec(v[0].numel(), coef.dim() - 3, coef.shape[1], k,
                                 v.element_size(), coef.element_size())
    if name == "matvec":
        packed, v = _arg(args, kw, 0, "packed"), _arg(args, kw, 1, "v")
        return cost_matvec(v.numel(), packed.dim() - 1, v.element_size(), packed.element_size())
    if name == "chebyshev_smooth":
        packed, b, x = (_arg(args, kw, i, k) for i, k in enumerate(("packed", "b", "x")))
        lam, degree = _arg(args, kw, 3, "lam_max"), _arg(args, kw, 4, "degree")
        second = _arg(args, kw, 7, "second")
        batch = lam.shape[0] if lam.dim() == 1 else 1
        dim = packed.dim() - 1 - (1 if lam.dim() == 1 else 0)
        n, item, citem = b.numel() // batch, b.element_size(), packed.element_size()
        nbytes, ops = (cost_chebyshev(n, dim, degree, x is not None, item, citem)
                       if second is None else
                       cost_chebyshev_second(n, dim, degree, x is not None, second, item, citem))
        return batch * nbytes, batch * ops
    if name == "fused_stage2_rbgs":
        coef, r, x1 = _arg(args, kw, 0, "coef"), _arg(args, kw, 2, "r"), _arg(args, kw, 3, "x1_cols")
        return cost_stage2(r[0].numel(), r.dim() - 1, r.shape[0], x1.shape[0],
                           r.element_size(), coef.element_size())
    if name == "block_rbgs_half_sweep":
        coef, b = _arg(args, kw, 0, "coef"), _arg(args, kw, 2, "b")
        return cost_half(b[0].numel(), b.dim() - 1, b.shape[0], b.element_size(),
                         coef.element_size())
    if name == "deep_correction":
        packed, inv, rc = _arg(args, kw, 0, "packed"), _arg(args, kw, 2, "coarse_inv"), \
            _arg(args, kw, 3, "rc")
        batch = inv.shape[0] if inv.dim() == 3 else 1
        nl = 1 if inv.dim() == 3 else 0
        shapes = [tuple(p.shape[nl + 1:]) for p in packed]
        return cost_deep(shapes, kw["degree"], kw["cycle_type"], kw["kcycle_min_cells"],
                         rc.element_size(), packed[0].element_size(), batch)
    if name in ("fused_residual", "fused_jvp"):
        model, u = _arg(args, kw, 0, "model"), _arg(args, kw, 1, "u")
        data = args[-1] if len(args) >= 5 else kw["data"]
        counts = _well_counts(model, u, data, cache)
        fn = cost_residual_counts if name == "fused_residual" else cost_jvp_counts
        return fn(model.nc, tuple(model.grid.shape), *counts, u.element_size())
    raise KeyError(name)


def least_seconds(name: str, args: tuple, kw: dict, cache: dict) -> float:
    """The least time on the card of wrapper ``name`` called with
    ``args``/``kw`` (``cache`` keeps each problem's well counts)."""
    nbytes, ops = _cost(name, args, kw, cache)
    return bound_ms(nbytes, ops)[0] * 1e-3
