"""Stencil kernels: block matvec, scalar matvec, the whole Chebyshev smooth,
the red-black block Gauss–Seidel stage 2 of the CPTR apply and the
red-black half-sweep.

Each public function is a wrapper around one CUDA kernel of
``csrc/stencil.cu`` (the red-black ones: ``csrc/rbgs.cu``) and has its plain
PyTorch version beside it (``*_plain``).  A wrapper checks its arguments, then:

- for tensors on the CPU, returns the plain version;
- for CUDA tensors, launches the kernel (or raises), and adds one to its
  ``launches`` counter.

The smooth can return a second output from the same launch
(``second="residual"``: b − A·y, ``second="product"``: A·y, of its result
y): the scalar matvec that multigrid would run right after it.  Such a
call counts one smooth, no ``matvec`` launch, and one in
``second_outputs`` under its kind.

Layouts (the reference's ``pack_block_stencil`` / ``pack_stencil``):

- block stencil ``coef``: ``(2·dim+1, nc, nc, *grid)`` — offsets
  ``[diag, up_0, lo_0, up_1, lo_1, ...]``, each an nc×nc block per cell;
  ``up_a`` couples cell i to i+e_a, ``lo_a`` to i−e_a;
- scalar stencil ``packed``: ``(2·dim+1, *grid)`` in the same offset order.

Values beyond the boundary are zero.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from thermalporous_torch.core.grid import shift_minus, shift_plus
from thermalporous_torch.kernels import _lib

_FLOATS = (torch.float32, torch.float64)


#: launches of each wrapper's bf16-coefficient and batched instantiations,
#: by "<wrapper> bf16" and "<wrapper> batched" (a launch counts in its
#: wrapper's ``launches`` too)
variant_launches: dict[str, int] = {}


def count_variant(wrapper: str, coef: torch.Tensor, batch: int = 0) -> None:
    """Count a launch of ``wrapper`` that has just been counted in its
    ``launches`` under its variants: bf16 coefficients, a batch of
    members."""
    for key, on in (("bf16", coef.dtype == torch.bfloat16), ("batched", batch > 0)):
        if on:
            name = f"{wrapper} {key}"
            variant_launches[name] = variant_launches.get(name, 0) + 1


def _check(name: str, *tensors: torch.Tensor, coefs: tuple = ()) -> torch.device:
    """Same device, contiguous; returns the device.  ``tensors`` (vectors)
    share one float dtype; the coefficient tensors ``coefs`` share either
    that dtype or bfloat16, the storage of ``CPRConfig.pc_dtype``: the
    kernels read such coefficients as bf16 and compute in the vectors'
    dtype."""
    dev, dt = tensors[0].device, tensors[0].dtype
    if dt not in _FLOATS:
        raise TypeError(f"{name}: dtype {dt} not in {_FLOATS}")
    cdt = coefs[0].dtype if coefs and coefs[0].dtype == torch.bfloat16 else dt
    for t in tensors + tuple(coefs):
        want = dt if not any(t is c for c in coefs) else cdt
        if t.device != dev or t.dtype != want:
            raise ValueError(f"{name}: mixed devices/dtypes "
                             f"({t.device}/{t.dtype} vs {dev}/{want})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


# ------------------------------------------------------------ block matvec

def apply_block_cols(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-cell blocks ``w`` (nc, nc, *grid) applied over their first
    ``v.shape[0]`` columns to ``v`` (k, *grid), as explicit small-index sums
    (row i: Σ_c w[i,c]·v[c], left to right) — all nc rows out."""
    nc, k = w.shape[0], v.shape[0]
    rows = []
    for i in range(nc):
        acc = w[i, 0] * v[0]
        for c in range(1, k):
            acc = acc + w[i, c] * v[c]
        rows.append(acc)
    return torch.stack(rows)


def block_matvec_plain(coef: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y = A·[v; 0]: block columns 0:k of the stencil, k = v.shape[0]."""
    dim = coef.dim() - 3
    y = apply_block_cols(coef[0], v)
    for a in range(dim):
        y = y + apply_block_cols(coef[1 + 2 * a], shift_minus(v, a, lead=1))
        y = y + apply_block_cols(coef[2 + 2 * a], shift_plus(v, a, lead=1))
    return y


def block_matvec(coef: torch.Tensor, v: torch.Tensor, k: int) -> torch.Tensor:
    """y = A·[v; 0] for a block stencil over block columns 0:k.

    ``v`` has shape (k, *grid); with k < nc the result equals A applied to v
    padded with nc−k zero components, while the kernel reads only k/nc of
    the coefficients.
    """
    dev = _check("block_matvec", v, coefs=(coef,))
    nco, nc = coef.shape[0], coef.shape[1]
    grid = tuple(coef.shape[3:])
    dim = len(grid)
    if (dim not in (2, 3) or nco != 2 * dim + 1 or coef.shape[2] != nc
            or not 1 <= k <= nc or tuple(v.shape) != (k,) + grid):
        raise ValueError(f"block_matvec: coef {tuple(coef.shape)}, v "
                         f"{tuple(v.shape)}, k={k}")
    if dev.type == "cpu":
        return block_matvec_plain(coef, v)
    if nc > 3:
        raise NotImplementedError("block_matvec kernel: nc <= 3")
    y = torch.empty((nc,) + grid, dtype=v.dtype, device=dev)
    _lib.launch("tp_block_matvec", _lib.dtype_code(v, coef), coef.data_ptr(),
                v.data_ptr(), y.data_ptr(), nc, k, dim, *_lib.dims3(grid),
                _lib.stream_of(v))
    block_matvec.launches += 1
    count_variant("block_matvec", coef)
    return y


block_matvec.launches = 0


# ----------------------------------------------------------- scalar matvec

def matvec_plain(packed: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    dim = packed.dim() - 1
    y = packed[0] * v
    for a in range(dim):
        y = y + packed[1 + 2 * a] * shift_minus(v, a, lead=0)
        y = y + packed[2 + 2 * a] * shift_plus(v, a, lead=0)
    return y


def _check_scalar(name: str, packed: torch.Tensor, *vecs: torch.Tensor,
                  batch: int = 0) -> tuple:
    """The grid of a scalar stencil ``packed`` (2·dim+1, *grid) and its
    vectors (*grid); with ``batch`` members stacked along a leading axis of
    each: (batch, 2·dim+1, *grid) and (batch, *grid)."""
    lead = (batch,) if batch else ()
    grid = tuple(packed.shape[len(lead) + 1:])
    dim = len(grid)
    if (dim not in (2, 3) or tuple(packed.shape[:len(lead)]) != lead
            or packed.shape[len(lead)] != 2 * dim + 1):
        raise ValueError(f"{name}: packed stencil shape {tuple(packed.shape)}"
                         + (f" for a batch of {batch}" if batch else ""))
    for t in vecs:
        if tuple(t.shape) != lead + grid:
            raise ValueError(f"{name}: vector shape {tuple(t.shape)} != {lead + grid}")
    return grid


#: cells a thread of the scalar matvec and smooth kernels takes at a time
#: (csrc/stencil.cu: a quad)
QUAD = 4
#: threads of a block of the scalar matvec kernel (csrc/common.cuh: kThreads)
MATVEC_THREADS = 256


@functools.cache
def matvec_plan(n: int) -> tuple[int, int]:
    """(blocks, threads) of the scalar matvec kernel for ``n`` cells: one
    thread per quad of 4 consecutive cells, with 32-bit indices."""
    if n < 1 or n >= 2**31:
        raise ValueError(f"matvec kernel: {n} cells (needs 1 <= n < 2**31)")
    quads = -(-n // QUAD)
    return -(-quads // MATVEC_THREADS), MATVEC_THREADS


def vector_access(n: int, *tensors: torch.Tensor) -> bool:
    """Whether a quad kernel may use 16-byte loads and stores: every
    tensor starts on a 16-byte boundary and every quad is whole, so that
    each channel of the packed stencil is aligned too.  A quad of bf16
    coefficients is one 8-byte load, whose channel offsets (multiples of 4
    values) keep it aligned; the members of a batch lie n values (vectors)
    or (2·dim+1)·n values (stencils) apart, which keeps them aligned too
    (:func:`quad_address`)."""
    return n % QUAD == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def quad_address(gq: int, n: int, batch: int, channels: int) -> tuple[int, int, int]:
    """The smooth kernel's index arithmetic for global quad ``gq`` of a
    batch of ``batch`` members of ``n`` cells (csrc/stencil.cu:
    cheb_smooth_kernel): (member, its first cell, the offset in values of
    its channel 0 from the stencil's base, members ``channels`` channels
    of n values apart)."""
    quads = -(-n // QUAD)
    if not 0 <= gq < batch * quads:
        raise ValueError(f"quad {gq} outside {batch} x {quads}")
    m = gq // quads
    c0 = QUAD * (gq - m * quads)
    return m, c0, m * channels * n + c0


def matvec(packed: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y = A·v for a scalar stencil ``packed`` (2·dim+1, *grid)."""
    dev = _check("matvec", v, coefs=(packed,))
    grid = _check_scalar("matvec", packed, v)
    if dev.type == "cpu":
        return matvec_plain(packed, v)
    n = v.numel()
    blocks, threads = matvec_plan(n)
    y = torch.empty_like(v)
    _lib.launch("tp_scalar_matvec", _lib.dtype_code(v, packed), packed.data_ptr(),
                v.data_ptr(), y.data_ptr(), len(grid), *_lib.dims3(grid),
                blocks, threads, int(vector_access(n, packed, v, y)),
                _lib.stream_of(v))
    matvec.launches += 1
    count_variant("matvec", packed)
    return y


matvec.launches = 0


# -------------------------------------------------------- Chebyshev smooth

def chebyshev_smooth_plain(
    packed: torch.Tensor,
    b: torch.Tensor,
    x: torch.Tensor | None,
    lam_max: torch.Tensor,
    degree: int,
    lam_min_frac: float,
    safety: float = 1.05,
    second: str | None = None,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """``degree`` Chebyshev iterations on D⁻¹A x = D⁻¹b over
    [lam_min_frac·λ, safety·λ], from ``x`` (None = zero start, which skips
    the first matvec: b − A·0 = b exactly).  With ``second`` the result y
    comes with b − A·y ("residual") or A·y ("product"), formed as the
    smooth followed by :func:`matvec_plain`.

    A ``lam_max`` of shape (batch,) smooths that many members stacked along
    a leading axis of ``packed``, ``b`` and ``x``, one after the other.
    With bf16 coefficients ``1.0 / packed[0]`` is a bf16 value, as the
    reference's weakly typed quotient is; it multiplies the vectors in
    their dtype."""
    if lam_max.dim() == 1:
        outs = [chebyshev_smooth_plain(packed[m], b[m], None if x is None else x[m],
                                       lam_max[m], degree, lam_min_frac, safety, second)
                for m in range(lam_max.shape[0])]
        if second is None:
            return torch.stack(outs)
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    lmax = lam_max * safety
    lmin = lam_max * lam_min_frac
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    inv_diag = 1.0 / packed[0]
    if x is None:
        x = torch.zeros_like(b)
        z = inv_diag * b
    else:
        z = inv_diag * (b - matvec_plain(packed, x))
    d = z / theta
    rho = 1.0 / sigma1
    for _ in range(degree - 1):
        x = x + d
        z = inv_diag * (b - matvec_plain(packed, x))
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * z
        rho = rho_new
    y = x + d
    if second is None:
        return y
    ay = matvec_plain(packed, y)
    return y, (b - ay if second == "residual" else ay)


#: the smooth's second outputs and their codes in csrc/stencil.cu
SMOOTH_SECOND = {None: 0, "residual": 1, "product": 2}
#: least quads a block of the smooth kernel is given before another block is used
SMOOTH_MIN_QUADS_PER_BLOCK = 128
#: csrc/stencil.cu: kSmoothMaxThreads (512 threads leave each 128 registers,
#: enough to have all of a quad's loads in flight at once)
SMOOTH_MAX_THREADS = 512
#: most members one smooth launch takes (csrc/stencil.cu: kSmoothMaxBatch):
#: the pressure and temperature hierarchies of ``CPRConfig.batch_pt``
SMOOTH_MAX_BATCH = 2


@dataclasses.dataclass(frozen=True)
class SmoothPlan:
    """Launch shape of the one-launch Chebyshev smooth (csrc/stencil.cu)."""

    blocks: int          # co-resident blocks, at most one per SM
    threads: int         # per block, a multiple of 32
    per_block: int       # quads (4 consecutive cells) a block owns, contiguous
    iters: int           # block-stride iterations over the block's quads
    cached_quads: int    # the block's first quads keep stencil, b and d in shared memory
    smem: int            # bytes of dynamic shared memory per block


@functools.cache
def smooth_plan(n: int, dim: int, item: int, sms: int, smem_max: int,
                batch: int = 1) -> SmoothPlan:
    """The launch shape for ``batch`` members of ``n`` cells each of a
    ``dim``-axis grid at ``item`` bytes a value (the vectors' dtype: the
    cache holds the coefficients converted to it) on a card with ``sms``
    SMs and ``smem_max`` bytes of shared memory a block.

    The grid must be co-resident (the steps are separated by grid-wide
    barriers), so there is at most one block per SM; small levels use fewer
    blocks.  The members' quads are numbered one member after the other (a
    quad never straddles two) and each block owns a contiguous range of
    them, which it walks in ``iters`` equally filled block-stride
    iterations.  As many of its quads as fit (whole warps of them) keep
    their 2·dim+1 stencil channels, b and d in shared memory, so they come
    from device memory once per smooth."""
    if n < 1 or batch * n >= 2**31 or not 1 <= batch <= SMOOTH_MAX_BATCH:
        raise ValueError(f"chebyshev_smooth kernel: {batch} x {n} cells (needs "
                         f"1 <= batch * n < 2**31, batch <= {SMOOTH_MAX_BATCH})")
    quads = batch * -(-n // QUAD)
    blocks = max(1, min(sms, -(-quads // SMOOTH_MIN_QUADS_PER_BLOCK)))
    per_block = -(-quads // blocks)
    iters = -(-per_block // SMOOTH_MAX_THREADS)
    threads = 32 * -(-(-(-per_block // iters)) // 32)
    per_quad = (2 * dim + 3) * QUAD * item
    # the kernel's static shared memory (a few scalars) counts against the
    # same limit: leave it 1 KiB
    fit = max(0, smem_max - 1024) // per_quad
    cached = per_block if fit >= per_block else fit // 32 * 32
    return SmoothPlan(blocks, threads, per_block, iters, cached, cached * per_quad)


def chebyshev_smooth(
    packed: torch.Tensor,
    b: torch.Tensor,
    x: torch.Tensor | None,
    lam_max: torch.Tensor,
    degree: int,
    lam_min_frac: float,
    safety: float = 1.05,
    second: str | None = None,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """A whole degree-``degree`` Chebyshev smooth of D⁻¹A (see the plain
    version).  ``lam_max`` is a 0-dim tensor on the device of ``b``; the
    kernel reads it there, so the call never waits on the host.  On the
    card it is one cooperative launch (:func:`smooth_plan`), counted as one
    smooth.  ``packed`` may hold bf16 coefficients (``CPRConfig.pc_dtype``).

    A ``lam_max`` of shape (batch,) smooths ``batch`` members stacked
    along a leading axis of ``packed``, ``b`` and ``x`` (``batch_pt``'s p
    and T levels) in the same single launch.

    With ``second="residual"`` or ``"product"`` the call returns
    ``(y, b − A·y)`` or ``(y, A·y)``: the kernel forms the second output
    after its last step, behind one more grid-wide barrier, from the
    stencil it still holds in shared memory.  That is no ``matvec`` launch;
    it is counted in ``second_outputs``."""
    if lam_max.dim() > 1:
        raise ValueError("chebyshev_smooth: lam_max must be a 0-dim tensor or one "
                         "per member")
    batch = lam_max.shape[0] if lam_max.dim() == 1 else 0
    if degree < 1:
        raise ValueError(f"chebyshev_smooth: degree {degree} < 1")
    if second not in SMOOTH_SECOND:
        raise ValueError(f"chebyshev_smooth: second {second!r} not in "
                         f"{tuple(SMOOTH_SECOND)}")
    vecs = (b, lam_max) + (() if x is None else (x,))
    dev = _check("chebyshev_smooth", *vecs, coefs=(packed,))
    grid = _check_scalar("chebyshev_smooth", packed, b,
                         *(() if x is None else (x,)), batch=batch)
    if dev.type == "cpu":
        return chebyshev_smooth_plain(packed, b, x, lam_max, degree,
                                      lam_min_frac, safety, second)
    n = math.prod(grid)
    plan = smooth_plan(n, len(grid), b.element_size(), *_lib.limits_of(b), max(batch, 1))
    out = torch.empty_like(b)
    out2 = None if second is None else torch.empty_like(b)
    scratch = torch.empty((3,) + tuple(b.shape), dtype=b.dtype, device=dev)
    vec = vector_access(n, packed, b, out, scratch,
                        *(t for t in (x, out2) if t is not None))
    _lib.launch("tp_chebyshev_smooth", _lib.dtype_code(b, packed), packed.data_ptr(),
                b.data_ptr(), None if x is None else x.data_ptr(),
                lam_max.data_ptr(), out.data_ptr(),
                None if out2 is None else out2.data_ptr(),
                *(scratch[i].data_ptr() for i in range(3)),
                int(degree), float(lam_min_frac), float(safety), len(grid),
                *_lib.dims3(grid), plan.blocks, plan.threads, plan.per_block,
                plan.iters, plan.cached_quads, plan.smem, int(vec),
                SMOOTH_SECOND[second], max(batch, 1), _lib.stream_of(b))
    chebyshev_smooth.launches += 1
    count_variant("chebyshev_smooth", packed, batch)
    if second is None:
        return out
    second_outputs[second] += 1
    return out, out2


chebyshev_smooth.launches = 0
#: second outputs the smooth kernel has produced, by kind: each stands for a
#: scalar matvec launch that did not happen
second_outputs = {"residual": 0, "product": 0}


# ----------------------------------------- red-black block Gauss–Seidel

def checkerboard(shape: tuple[int, ...], dtype: torch.dtype,
                 device: torch.device | str, parity: int = 0) -> torch.Tensor:
    """Parity mask: 1.0 on 'red' cells (even index sum plus ``parity``),
    0.0 on black.  ``parity`` is the index sum of the grid's origin in a
    larger grid, mod 2: a block of a decomposed grid then keeps the whole
    grid's colours."""
    idx = torch.full((), parity, dtype=torch.int64, device=device)
    for a, m in enumerate(shape):
        view = [1] * len(shape)
        view[a] = m
        idx = idx + torch.arange(m, device=device).reshape(view)
    return (idx % 2 == 0).to(dtype)


def fused_block_rbgs_plain(coef: torch.Tensor, dinv: torch.Tensor,
                          b: torch.Tensor, parity: int = 0) -> torch.Tensor:
    """One red-black block Gauss–Seidel sweep from x = 0:
    x_r = red⊙D⁻¹b, out = x_r + black⊙D⁻¹(b − A·x_r) (the looped form's
    first half-sweep, b − A·0 = b exactly); colours by
    :func:`checkerboard` with ``parity``."""
    red = checkerboard(tuple(b.shape[1:]), b.dtype, b.device, parity)
    black = 1.0 - red
    xr = red * apply_block_cols(dinv, b)
    return xr + black * apply_block_cols(dinv, b - block_matvec_plain(coef, xr))


def fused_stage2_rbgs_plain(coef: torch.Tensor, dinv: torch.Tensor, r: torch.Tensor,
                            x1_cols: torch.Tensor, parity: int = 0) -> torch.Tensor:
    """The CPTR stage 2 after stage 1, composed as the apply composed it:
    r2 = r − A·[x1_cols; 0] (:func:`block_matvec_plain` over k =
    ``x1_cols.shape[0]`` columns; k = 0: r2 = r), one zero-start sweep on r2
    (:func:`fused_block_rbgs_plain`), then x1_cols added to the first k
    components."""
    k = x1_cols.shape[0]
    r2 = r - block_matvec_plain(coef, x1_cols) if k else r
    x2 = fused_block_rbgs_plain(coef, dinv, r2, parity)
    x2[0:k] += x1_cols
    return x2


#: most threads of a block of the stage-2 kernel (csrc/rbgs.cu:
#: kStage2MaxThreads): one per pair of consecutive cells of the tile's rows,
#: then one per red cell of its one-cell ring
STAGE2_MAX_THREADS = 384
#: blocks per SM that :func:`stage2_plan` fills in one wave (csrc/rbgs.cu
#: launches with __launch_bounds__(384, 1): a block's threads keep every
#: load of a step in flight at once, in up to 170 registers), and the fewest
#: planes of a chunk (a chunk computes the red values of the plane below it
#: and of its first plane again)
STAGE2_BLOCKS_PER_SM = 1
STAGE2_MIN_PLANES = 8


def stage2_ring(dim: int, ty: int, tz: int) -> int:
    """Red cells of a tile's one-cell ring in a plane, at most: the ring
    threads of its block (csrc/rbgs.cu: stage2_ring)."""
    return 2 * -(-ty // 2) + (tz if dim == 3 else 0)


@dataclasses.dataclass(frozen=True)
class Stage2Plan:
    """Tiling of the stage-2 kernel (csrc/rbgs.cu).  The grid is seen as
    (e0, e1, e2) with e1 = 1 in 2D; a block owns ``lx`` planes along axis 0
    of a tile of ``ty`` rows of ``tz`` consecutive cells (``tz`` even, a
    thread per pair), with ``ring`` more threads for the ring's red cells."""

    ty: int
    tz: int
    lx: int
    tiles_y: int
    tiles_z: int
    chunks: int
    ring: int

    @property
    def blocks(self) -> int:
        return self.tiles_y * self.tiles_z * self.chunks

    @property
    def own(self) -> int:
        """Pair threads, whole warps: the ring threads start here."""
        return 32 * -(-(self.ty * self.tz // 2) // 32)

    @property
    def threads(self) -> int:
        return self.own + 32 * -(-self.ring // 32)

    def smem(self, dim: int, nc: int, item: int) -> int:
        """Bytes of shared memory of a block (csrc/rbgs.cu: stage2_smem):
        two planes' red values of the tile with its one-cell ring."""
        return 2 * nc * (self.ty + (2 if dim == 3 else 0)) * (self.tz + 2) * item


@functools.cache
def stage2_plan(shape: tuple[int, ...], sms: int) -> Stage2Plan:
    """The tiling of the stage-2 kernel for a grid of ``shape`` on a card
    with ``sms`` SMs.

    Tiles keep rows of at least 64 consecutive cells where the grid has
    them, and at least 4 (which keeps the shared memory under 48 KB), and at
    most ``STAGE2_MAX_THREADS`` threads.  Axis 0 is cut into as many chunks
    of at least ``STAGE2_MIN_PLANES`` planes as one wave of
    ``STAGE2_BLOCKS_PER_SM`` blocks per SM holds.  Of all tiles, the one
    with the least time: waves × planes a block × lanes a plane, a pair
    lane counting twice a ring lane (a red and a black value against one
    red value)."""
    n = math.prod(shape)
    if len(shape) not in (2, 3) or n < 1 or n >= 2**31:
        raise ValueError(f"stage-2 kernel: grid {shape} (2 or 3 axes, "
                         f"1 <= cells < 2**31)")
    dim = len(shape)
    e0, e1, e2 = shape[0], (shape[1] if dim == 3 else 1), shape[-1]
    e2p = e2 + e2 % 2
    lo = max(4, min(e2p, 64))
    slots = STAGE2_BLOCKS_PER_SM * sms
    best = None
    for tz in range(lo, max(lo, min(e2p, 2 * STAGE2_MAX_THREADS)) + 1, 2):
        tiles_z = -(-e2 // tz)
        for tiles_y in range(-(-e1 // min(e1, 2 * STAGE2_MAX_THREADS // tz)), e1 + 1):
            ty = -(-e1 // tiles_y)
            if -(-e1 // ty) != tiles_y:
                continue
            ring = stage2_ring(dim, ty, tz)
            plan = Stage2Plan(ty, tz, 1, tiles_y, tiles_z, 1, ring)
            if plan.threads > STAGE2_MAX_THREADS:
                continue
            tiles = tiles_y * tiles_z
            chunks = max(1, min(slots // tiles, e0 // STAGE2_MIN_PLANES))
            lx = -(-e0 // chunks)
            chunks = -(-e0 // lx)
            cost = (-(-tiles * chunks // slots) * lx
                    * (plan.own + plan.threads))
            if best is None or cost < best[0]:
                best = (cost, Stage2Plan(ty, tz, lx, tiles_y, tiles_z, chunks, ring))
    return best[1]


def _check_rbgs(name: str, coef: torch.Tensor, dinv: torch.Tensor,
                *vecs: torch.Tensor) -> tuple[int, tuple[int, ...]]:
    """(nc, grid) of a block stencil ``coef``, its inverse diagonal blocks
    ``dinv`` and state-shaped vectors; raises on any other shape."""
    nco, nc = coef.shape[0], coef.shape[1]
    grid = tuple(coef.shape[3:])
    dim = len(grid)
    if (dim not in (2, 3) or nco != 2 * dim + 1 or coef.shape[2] != nc
            or tuple(dinv.shape) != (nc, nc) + grid
            or any(tuple(v.shape) != (nc,) + grid for v in vecs)):
        raise ValueError(f"{name}: coef {tuple(coef.shape)}, dinv {tuple(dinv.shape)}, "
                         f"vectors {[tuple(v.shape) for v in vecs]}")
    return nc, grid


def fused_stage2_rbgs(coef: torch.Tensor, dinv: torch.Tensor, r: torch.Tensor,
                      x1_cols: torch.Tensor, parity: int = 0) -> torch.Tensor:
    """The whole red-black stage 2 of the CPTR apply after stage 1 (see the
    plain version): x1 = [x1_cols; 0] with k = ``x1_cols.shape[0]`` (0 ≤ k ≤
    nc), r2 = r − A·x1 over block columns 0:k, one zero-start red-black block
    Gauss–Seidel sweep on r2, plus x1.  ``coef`` (2·dim+1, nc, nc, *grid) is
    the block stencil, ``dinv`` (nc, nc, *grid) its per-cell inverse
    diagonal blocks, ``r`` (nc, *grid).  ``parity`` offsets the colours (see
    :func:`checkerboard`): a block of a decomposed grid passes its origin's
    index sum mod 2.  On the card one launch (:func:`stage2_plan`)."""
    dev = _check("fused_stage2_rbgs", r, x1_cols, coefs=(coef, dinv))
    nc, grid = _check_rbgs("fused_stage2_rbgs", coef, dinv, r)
    k = x1_cols.shape[0]
    if not 0 <= k <= nc or tuple(x1_cols.shape) != (k,) + grid:
        raise ValueError(f"fused_stage2_rbgs: x1_cols {tuple(x1_cols.shape)} for "
                         f"nc={nc}, grid {grid}")
    if parity not in (0, 1):
        raise ValueError(f"fused_stage2_rbgs: parity {parity} not in (0, 1)")
    if dev.type == "cpu":
        return fused_stage2_rbgs_plain(coef, dinv, r, x1_cols, parity)
    if nc > 3:
        raise NotImplementedError("fused_stage2_rbgs kernel: nc <= 3")
    plan = stage2_plan(grid, _lib.limits_of(r)[0])
    out = torch.empty_like(r)
    _lib.launch("tp_stage2_rbgs", _lib.dtype_code(r, coef), coef.data_ptr(), dinv.data_ptr(),
                r.data_ptr(), x1_cols.data_ptr() if k else None, out.data_ptr(), nc, k,
                len(grid), *_lib.dims3(grid), plan.ty, plan.tz, plan.lx, int(parity),
                _lib.stream_of(r))
    fused_stage2_rbgs.launches += 1
    count_variant("fused_stage2_rbgs", coef)
    return out


fused_stage2_rbgs.launches = 0


def fused_block_rbgs(coef: torch.Tensor, dinv: torch.Tensor,
                     b: torch.Tensor, parity: int = 0) -> torch.Tensor:
    """One zero-start red-black block Gauss–Seidel sweep on ``b`` (see
    :func:`fused_block_rbgs_plain`): the stage-2 kernel with k = 0, counted
    as a ``fused_stage2_rbgs`` launch."""
    return fused_stage2_rbgs(coef, dinv, b, b[:0], parity)


def block_rbgs_half_sweep_plain(coef: torch.Tensor, dinv: torch.Tensor, b: torch.Tensor,
                                x: torch.Tensor, colour: int, parity: int = 0) -> torch.Tensor:
    """x + colour⊙D⁻¹(b − A·x) for one colour (0 red, 1 black; colours by
    :func:`checkerboard` with ``parity``): a half-sweep of the looped
    red-black block Gauss–Seidel."""
    mask = checkerboard(tuple(b.shape[1:]), b.dtype, b.device, parity)
    if colour:
        mask = 1.0 - mask
    return x + mask * apply_block_cols(dinv, b - block_matvec_plain(coef, x))


def block_rbgs_half_sweep(coef: torch.Tensor, dinv: torch.Tensor, b: torch.Tensor,
                          x: torch.Tensor, colour: int, parity: int = 0) -> torch.Tensor:
    """One red-black half-sweep (see the plain version) from ``x``: the
    cells of ``colour`` (0 red, 1 black) take their block solve against the
    other colour's values.  On the card one launch, a thread a cell."""
    dev = _check("block_rbgs_half_sweep", b, x, coefs=(coef, dinv))
    nc, grid = _check_rbgs("block_rbgs_half_sweep", coef, dinv, b, x)
    if colour not in (0, 1) or parity not in (0, 1):
        raise ValueError(f"block_rbgs_half_sweep: colour {colour}, parity {parity} "
                         f"not in (0, 1)")
    if dev.type == "cpu":
        return block_rbgs_half_sweep_plain(coef, dinv, b, x, colour, parity)
    if nc > 3:
        raise NotImplementedError("block_rbgs_half_sweep kernel: nc <= 3")
    n = math.prod(grid)
    if n >= 2**31:
        raise ValueError(f"block_rbgs_half_sweep kernel: {n} cells (needs n < 2**31)")
    out = torch.empty_like(x)
    _lib.launch("tp_block_rbgs_half", _lib.dtype_code(x, coef), coef.data_ptr(), dinv.data_ptr(),
                b.data_ptr(), x.data_ptr(), out.data_ptr(), colour, int(parity), nc,
                len(grid),
                *_lib.dims3(grid), _lib.stream_of(x))
    block_rbgs_half_sweep.launches += 1
    count_variant("block_rbgs_half_sweep", coef)
    return out


block_rbgs_half_sweep.launches = 0
