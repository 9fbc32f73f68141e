"""The fused multigrid coarse-subtree correction (``csrc/deep_cycle.cu``).

Counterpart of ``thermalporous_tpu/kernels/deep_cycle.py``: the whole
coarse-grid correction below a level — the V-, W- or K-cycle recursion,
Chebyshev smoothing, constant-transfer restriction and prolongation and the
dense coarsest-level solve — in one cooperative launch over up to one block
per SM, with a grid-wide barrier between dependent passes, instead of a few
hundred small launches per visit of the subtree.

``deep_correction`` is the wrapper: on CPU tensors it returns its plain
version, ``deep_correction_plain`` (the counterpart of the reference's
``_correction_math``, which is ``precond.gmg._coarse_correction`` unrolled);
on CUDA tensors it launches the kernel and adds one to
``deep_correction.launches``.

Sizing (:func:`subtree_bytes`) counts the stencils at the dtype they are
stored in (bf16 under ``CPRConfig.pc_dtype``) and the vectors and the dense
coarsest inverse at the dtype the correction computes in — the right-hand
side's — and every member of a batch.  Each level runs one of three cycle
kinds (:func:`cycle_kinds`): a single cycle, the K-cycle or the W-cycle;
the kernel reads the kind from the level's descriptor.

A batch (``CPRConfig.batch_pt``: the pressure and temperature hierarchies,
congruent, stacked along a leading axis of every stencil, λ estimate,
inverse and vector) runs in ONE launch: every pass covers each member's
cells in turn, with the same barriers as one member's visit and each
member's K-cycle scalars its own.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Sequence

import torch

from thermalporous_torch.kernels import _lib
from thermalporous_torch.kernels import stencil as kst

#: vectors per level the kernel keeps in its scratch buffer (csrc/deep_cycle.cu:
#: b, out, e1, v1, r1, e2, v2, ya, yb, d)
VECS_PER_LEVEL = 10
#: partial dot products a block leaves in scratch per member (csrc/deep_cycle.cu:
#: kMaxDots), and the most members of a launch (kDeepMaxBatch)
MAX_DOTS = 3
MAX_BATCH = 2
#: cells of the entry level per block before another block is used
MIN_CELLS_PER_BLOCK = 256
MAX_THREADS = 1024


def launch_shape(n_entry: int, sms: int) -> tuple[int, int]:
    """(blocks, threads per block) of the subtree kernel for an entry level
    of ``n_entry`` cells on a card with ``sms`` SMs: about one cell a thread
    on the entry level, at most one block per SM (the grid must be
    co-resident for its barriers), threads a multiple of 32."""
    blocks = max(1, min(sms, -(-n_entry // MIN_CELLS_PER_BLOCK)))
    threads = 32 * -(-(-(-n_entry // blocks)) // 32)
    return blocks, max(32, min(MAX_THREADS, threads))


#: a level's cycle kind (csrc/deep_cycle.cu: the descriptor's kind): one
#: cycle, the K-cycle (flexible CG(2) over two cycles) or the W-cycle (a
#: second cycle on the first's residual, the two added)
SINGLE, KCYCLE, WCYCLE = 0, 1, 2
_KIND = {"v": SINGLE, "k": KCYCLE, "w": WCYCLE}


def cycle_kinds(sizes: Sequence[int], cycle_type: str,
                kcycle_min_cells: int) -> list[int]:
    """Per level of a subtree with ``sizes`` cells, its cycle kind: the
    configuration's on levels with at least ``kcycle_min_cells`` cells, a
    single cycle below and on the coarsest (which is solved directly)."""
    if cycle_type not in _KIND:
        raise ValueError(f"unknown cycle_type {cycle_type!r}")
    last = len(sizes) - 1
    return [_KIND[cycle_type] if ell < last and m >= kcycle_min_cells else SINGLE
            for ell, m in enumerate(sizes)]


def barrier_count(kinds: Sequence[int], degree: int, single_block: bool = False) -> int:
    """Barriers on the critical path of one visit of a subtree whose levels
    run the cycle kinds ``kinds`` (the last level is the dense solve).  The
    cooperative kernel's grid barriers: per cycle of a level 2·degree + 3
    (one per Chebyshev step, after the residual, the restriction and the
    prolongation), per K-cycle level 3 more (two reductions, the
    combination), per W-cycle level none more (its residual joins the
    second cycle's first pass, its sum the last smoothing step), 1 for the
    dense solve.  With ``single_block``, the block barriers of the earlier
    one-block kernel (V and K only), which spent two on each Chebyshev step
    after the first and kept the K-cycle's matvec, dots and update as
    separate passes."""
    last = len(kinds) - 1
    if single_block:
        if WCYCLE in kinds:
            raise ValueError("the one-block kernel had no W-cycle")
        cycle, extra = 2 * (2 * degree) + 3, 10
    else:
        cycle, extra = 2 * degree + 3, 3

    def visit(ell: int) -> int:
        if ell == last:
            return 1
        one = cycle + visit(ell + 1)
        if kinds[ell] == KCYCLE:
            return 2 * one + extra
        return 2 * one if kinds[ell] == WCYCLE else one

    return visit(0)


def subtree_bytes(shapes: Sequence[tuple[int, ...]], inv_numel: int,
                  dtype: torch.dtype, coef_dtype: torch.dtype | None = None,
                  batch: int = 1) -> int:
    """Bytes a fused subtree of ``batch`` members touches: the packed
    stencils at their stored ``coef_dtype`` (None: ``dtype``), the kernel's
    per-level vectors and the dense coarsest inverse at the apply dtype
    ``dtype``."""
    item = torch.empty((), dtype=dtype).element_size()
    citem = item if coef_dtype is None else torch.empty((), dtype=coef_dtype).element_size()
    total = inv_numel * item
    for shape in shapes:
        cells = math.prod(shape)
        total += ((2 * len(shape) + 1) * citem + VECS_PER_LEVEL * item) * cells
    return batch * total


def scratch_offsets(sizes: Sequence[int], members: int) -> list[list[int]]:
    """Offsets (in values) into the kernel's scratch of each level's
    VECS_PER_LEVEL vectors, member 0's: a vector of a level of n cells
    holds its members n values apart (csrc/deep_cycle.cu: the kernel adds
    m·n), and the next vector starts after its last member."""
    out, off = [], 0
    for n in sizes:
        out.append([off + k * members * n for k in range(VECS_PER_LEVEL)])
        off += VECS_PER_LEVEL * members * n
    return out


def _factors(shapes: Sequence[tuple[int, ...]]) -> list[tuple[int, ...]]:
    return [tuple(2 if c < f else 1 for f, c in zip(fine, coarse))
            for fine, coarse in zip(shapes[:-1], shapes[1:])]


def warp_order_mv(inv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """inv·b summed in the order of the kernel's coarsest solve
    (csrc/deep_cycle.cu: dk_dense): per row, 32 lane sums over the columns
    j ≡ lane (mod 32) in increasing j, then the warp's shuffle tree.  The
    plain version's ``torch.mv`` sums in another order; with this one the
    subtree's kernel and its plain version round alike wherever the
    recursion has no dot products (V- and W-cycles)."""
    n = b.numel()
    v = b.reshape(-1)
    acc = torch.zeros((n, 32), dtype=b.dtype, device=b.device)
    for j0 in range(0, n, 32):
        w = min(32, n - j0)
        acc[:, :w] = acc[:, :w] + inv[:, j0:j0 + w] * v[j0:j0 + w]
    for off in (16, 8, 4, 2, 1):
        acc = acc[:, :off] + acc[:, off:2 * off]
    return acc[:, 0].reshape(b.shape)


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
    coarse_solve: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
) -> torch.Tensor:
    """Approximate A₀⁻¹ rc over the subtree ``packed`` (entry level first,
    scalar stencils (2·dim+1, *grid)); ``lam_max`` has one 0-dim tensor per
    level but the coarsest.  The recursion of ``precond.gmg``: one cycle per
    level, or on levels with at least ``kcycle_min_cells`` cells the W-cycle
    (a second cycle on b − A·e1, added to the first) or the K-cycle
    (flexible CG(2) over two cycles).  ``coarse_solve(inv, b)`` is the
    coarsest level's product (None: ``torch.mv``, as the unfused recursion
    computes it; :func:`warp_order_mv`: the kernel's summation order).

    A ``coarse_inv`` of shape (batch, m, m) corrects that many members
    stacked along a leading axis of every stencil, λ estimate and ``rc``,
    one after the other."""
    from thermalporous_torch.precond.gmg import _blocksum, _prolong

    if coarse_inv.dim() == 3:
        return torch.stack([
            deep_correction_plain([p[m] for p in packed], [lam[m] for lam in lam_max],
                                  coarse_inv[m], rc[m], degree=degree,
                                  lam_min_frac=lam_min_frac, cycle_type=cycle_type,
                                  kcycle_min_cells=kcycle_min_cells, safety=safety,
                                  coarse_solve=coarse_solve)
            for m in range(coarse_inv.shape[0])])

    shapes = [tuple(p.shape[1:]) for p in packed]
    factors = _factors(shapes)
    last = len(packed) - 1

    def smooth(ell, b, x):
        return kst.chebyshev_smooth_plain(packed[ell], b, x, lam_max[ell], degree,
                                          lam_min_frac, safety)

    def v_cycle(ell, b):
        if ell == last:
            if coarse_solve is not None:
                return coarse_solve(coarse_inv, b)
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
        if cycle_type == "w":
            r1 = b - kst.matvec_plain(packed[ell], e1)
            return e1 + v_cycle(ell, r1)
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
    barriers: torch.Tensor | None = None,
) -> torch.Tensor:
    """The whole coarse correction below the entry level ``packed[0]`` (see
    the plain version) in one cooperative launch (:func:`launch_shape`).
    ``barriers``, a 0-dim int32 tensor on the card, receives the number of
    grid barriers the kernel went through.  The stencils may be stored in
    bf16 (``CPRConfig.pc_dtype``); the λ estimates, the inverse and ``rc``
    share the apply dtype.  With a ``coarse_inv`` of shape (batch, m, m)
    the members stacked along the leading axes are corrected in the same
    launch, each as it would be alone (:func:`launch_shape` of one
    member's entry level, the same passes and summation orders)."""
    n_lev = len(packed)
    if cycle_type not in _KIND:
        raise ValueError(f"deep_correction: unknown cycle_type {cycle_type!r}")
    if n_lev < 1 or len(lam_max) < n_lev - 1 or degree < 1:
        raise ValueError(f"deep_correction: {n_lev} levels, {len(lam_max)} "
                         f"lambda estimates, degree {degree}")
    lams = list(lam_max[: n_lev - 1])
    dev = kst._check("deep_correction", rc, coarse_inv, *lams, coefs=tuple(packed))
    batch = coarse_inv.shape[0] if coarse_inv.dim() == 3 else 0
    lead = (batch,) if batch else ()
    nl = len(lead)
    shapes = [tuple(p.shape[nl + 1:]) for p in packed]
    n_last = math.prod(shapes[-1])
    if (tuple(rc.shape) != lead + shapes[0]
            or tuple(coarse_inv.shape) != lead + (n_last, n_last)
            or any(tuple(p.shape[:nl + 1]) != lead + (2 * len(s) + 1,)
                   or len(s) not in (2, 3) for p, s in zip(packed, shapes))
            or any(tuple(lam.shape) != lead for lam in lams)):
        raise ValueError(f"deep_correction: rc {tuple(rc.shape)}, levels "
                         f"{[tuple(p.shape) for p in packed]}, inverse "
                         f"{tuple(coarse_inv.shape)}")
    if dev.type == "cpu":
        return deep_correction_plain(packed, lams, coarse_inv, rc, degree=degree,
                                     lam_min_frac=lam_min_frac, cycle_type=cycle_type,
                                     kcycle_min_cells=kcycle_min_cells, safety=safety)
    if n_lev > _lib.DEEP_MAX_LEVELS or degree > _lib.DEEP_MAX_DEGREE or batch > MAX_BATCH:
        raise NotImplementedError(f"deep_correction kernel: {n_lev} levels > "
                                  f"{_lib.DEEP_MAX_LEVELS}, degree {degree} > "
                                  f"{_lib.DEEP_MAX_DEGREE} or batch {batch} > {MAX_BATCH}")
    members = max(batch, 1)
    sizes = [math.prod(s) for s in shapes]
    if sizes[0] >= 2**31:
        raise NotImplementedError(f"deep_correction kernel: {sizes[0]} cells >= 2**31")
    if barriers is not None and (barriers.dtype != torch.int32 or barriers.dim() != 0
                                 or barriers.device != dev):
        raise ValueError("deep_correction: barriers must be a 0-dim int32 tensor on "
                         f"{dev}")
    blocks, threads = launch_shape(sizes[0], _lib.limits_of(rc)[0])
    kinds = cycle_kinds(sizes, cycle_type, kcycle_min_cells)
    # the levels' vectors, each with its members n cells apart, then the
    # blocks' partial dot products
    n_vecs = VECS_PER_LEVEL * members * sum(sizes)
    scratch = torch.empty(n_vecs + MAX_DOTS * members * blocks, dtype=rc.dtype, device=dev)
    out = torch.empty_like(rc)
    factors = _factors(shapes) + [(1, 1, 1)]
    per = _lib.DEEP_DESC_PER_LEVEL
    desc = (ctypes.c_longlong * (per * n_lev))()
    base = scratch.data_ptr()
    item = rc.element_size()
    offsets = scratch_offsets(sizes, members)
    for ell, (p, shape) in enumerate(zip(packed, shapes)):
        vecs = [base + o * item for o in offsets[ell]]
        if ell == 0:
            vecs[0], vecs[1] = rc.data_ptr(), out.data_ptr()   # b in, out
        fac = tuple(factors[ell]) + (1,) * (3 - len(factors[ell]))
        row = [p.data_ptr(), lams[ell].data_ptr() if ell < n_lev - 1 else 0,
               *vecs, len(shape), *_lib.dims3(shape), *fac, kinds[ell]]
        assert len(row) == per
        desc[ell * per:(ell + 1) * per] = row
    _lib.launch("tp_deep_correction", _lib.dtype_code(rc, packed[0]),
                ctypes.cast(desc, ctypes.c_void_p), n_lev, coarse_inv.data_ptr(),
                base + n_vecs * item, None if barriers is None else barriers.data_ptr(),
                int(degree), float(lam_min_frac), float(safety), blocks, threads,
                members, _lib.stream_of(rc))
    deep_correction.launches += 1
    kst.count_variant("deep_correction", packed[0], batch)
    return out


deep_correction.launches = 0
