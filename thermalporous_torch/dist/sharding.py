"""Grid decomposition over ranks (counterpart of
``thermalporous_tpu/dist/sharding.py``).

The reference places its arrays on a 2D ``jax.sharding.Mesh`` over
("x", "y") and lets XLA's SPMD partitioner insert the halo permutes and the
all-reduces.  PyTorch has no such partitioner that reaches the hand-written
kernels, so the port decomposes the grid the way the upstream simulator did
through PETSc/MPI: each rank of a ``torch.distributed`` group owns a block
of the (x, y) grid, keeps a ring of ghost cells around it that it fills from
its mesh neighbours before every stencil pass (``dist/halo.py``), and routes
every global reduction through one deterministic collective
(:meth:`GridMesh.allreduce_sum`).  z stays local, as in the reference.

A :class:`GridMesh` is an (mx, my) process grid with mx = ⌊√n⌋ lowered
until it divides n (the reference's rule, :func:`mesh_shape`); rank
``ix·my + iy`` holds block (ix, iy).  The backend ("nccl" or "gloo") is
the caller's choice: over gloo with CUDA tensors the ghost slices and the
reduction partials are staged through the host, over NCCL they stay on the
card.  A mesh of one rank needs no process group; its exchanges and
reductions do nothing, so that a one-rank run is the undecomposed run.

Owned ranges (:func:`split_ranges`) may be uneven, as in PETSc's DMDA: each
interior block boundary is the multiple of 2^k nearest the even split, for
the largest k ≤ 6 that keeps every boundary within n/(8m) cells of it.
Boundaries divisible by 2^k let k coarsenings of an axis restrict block by
block, without a coarsening pair straddling two blocks; the scalar
multigrid (``precond/gmg.py``) and bgmg's coupled block hierarchy
(``precond/block_gmg.py``) keep a level decomposed only while that holds
(:meth:`Block.level_blocks`, walked by :meth:`Block.walk_levels`).

Tensors of a decomposed run are held on the **extended block**: the owned
cells plus a ghost ring ``width`` cells deep on each side that has a
neighbour (none beyond the grid's boundary), at :data:`STATE_HALO` for the
state and the problem data.  :func:`shard_state` and
:func:`shard_problem_data` cut a whole array to it; :func:`gather_state`
puts the owned parts of every rank back together.  :meth:`Block.fold` is
the adjoint of the exchange (:meth:`Block.extend`): it sends a cotangent
held on the ring back to the rank that owns those cells and adds it there,
as the decomposed adjoint needs.  :meth:`Block.pipeline` runs a recurrence
along a decomposed axis through the ranks in turn, its carry handed from
each to the next: the Thomas line solves, bit for bit the whole grid's.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import math
import time

import numpy as np
import torch
import torch.distributed as tdist

from thermalporous_torch._device import require_cuda
from thermalporous_torch.models.base import ProblemData
from thermalporous_torch.physics.wells import WELL_FIELDS, WellFields

#: ghost width of the state and the problem data: the red-black stage 2
#: reads the Jacobian's rows one cell into the ring and x₁ two cells in
STATE_HALO = 2
#: largest power of two the owned-range boundaries are rounded to
SPLIT_MAX_POW = 6


def mesh_shape(n: int) -> tuple[int, int]:
    """(mx, my) of an n-rank grid mesh: mx = ⌊√n⌋ lowered until it divides
    n (the reference's ``make_grid_mesh``)."""
    if n < 1:
        raise ValueError(f"mesh_shape: {n} ranks")
    mx = int(np.floor(np.sqrt(n)))
    while n % mx:
        mx -= 1
    return mx, n // mx


def split_ranges(n: int, m: int) -> tuple[int, ...]:
    """The m + 1 boundaries of m owned ranges of an axis of n cells: the
    interior ones at the multiple of 2^k nearest i·n/m, for the largest
    k ≤ SPLIT_MAX_POW that keeps each within n/(8m) of i·n/m and every range
    non-empty (k = 0 rounds to the nearest cell)."""
    if n < m:
        raise ValueError(f"split_ranges: {n} cells over {m} ranks")
    for k in range(SPLIT_MAX_POW, -1, -1):
        a = 2 ** k
        bounds = [0] + [a * math.floor(i * n / (m * a) + 0.5) for i in range(1, m)] + [n]
        if any(hi <= lo for lo, hi in zip(bounds, bounds[1:])):
            continue
        if k == 0 or all(abs(bounds[i] - i * n / m) <= n / (8 * m) for i in range(1, m)):
            return tuple(bounds)
    raise AssertionError("unreachable")


@dataclasses.dataclass(eq=False)
class GridMesh:
    """An (mx, my) process grid over the default ``torch.distributed``
    group (or no group, for one rank), its collectives and their counts."""

    shape: tuple[int, int]
    rank: int
    backend: str | None
    device: torch.device
    #: exchanges, all-reduces and all-gathers issued, the line solves'
    #: pipeline carries sent or received (:meth:`Block.pipeline`), and the
    #: seconds spent in exchanges and carries (host-synchronized), since
    #: the last :meth:`reset_stats`
    stats: dict = dataclasses.field(default_factory=lambda: dict(
        exchanges=0, allreduces=0, gathers=0, carries=0, exchange_s=0.0))

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def coords(self) -> tuple[int, int]:
        return divmod(self.rank, self.shape[1])

    def rank_at(self, ix: int, iy: int) -> int:
        return ix * self.shape[1] + iy

    def reset_stats(self) -> None:
        self.stats.update(exchanges=0, allreduces=0, gathers=0, carries=0, exchange_s=0.0)

    @property
    def _staged(self) -> bool:
        """Whether tensors go through the host (gloo, or a CPU run)."""
        return self.backend != "nccl"

    # ------------------------------------------------------------ collectives
    def all_gather(self, t: torch.Tensor, kind: str = "gathers") -> list[torch.Tensor]:
        """Every rank's ``t`` (equal shapes), in rank order, on this rank's
        device; counted under ``kind`` in :attr:`stats`."""
        if self.size == 1:
            return [t]
        self.stats[kind] += 1
        src = t.detach().contiguous()
        if self._staged:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        tdist.all_gather(parts, src)
        return [p.to(t.device) for p in parts]

    def allreduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``t``: the rank partials gathered and
        added in rank order, in f64 when ``t`` is f32, then cast back, so
        that every rank holds the same bits.  One rank: ``t`` itself."""
        if self.size == 1:
            return t
        wide = torch.float64 if t.dtype == torch.float32 else t.dtype
        parts = self.all_gather(t.to(wide), "allreduces")
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc.to(t.dtype)

    def allreduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over the ranks of ``t`` (exact)."""
        if self.size == 1:
            return t
        parts = self.all_gather(t, "allreduces")
        acc = parts[0]
        for p in parts[1:]:
            acc = torch.maximum(acc, p)
        return acc

    def exchange(self, sends, recvs) -> list[torch.Tensor]:
        """Point-to-point: ``sends`` (dst rank, tag, tensor) and ``recvs``
        (src rank, tag, shape, dtype), all posted together and waited for;
        returns the received tensors on this rank's device, in the order of
        ``recvs``.  Over gloo the slices go through CPU tensors."""
        if not sends and not recvs:
            return []
        staged = self._staged
        host = torch.device("cpu")
        ops, outs = [], []
        for dst, tag, x in sends:
            buf = x.contiguous()
            ops.append(tdist.P2POp(tdist.isend, buf.cpu() if staged else buf, dst, tag=tag))
        for src, tag, shape, dtype in recvs:
            buf = torch.empty(shape, dtype=dtype, device=host if staged else self.device)
            ops.append(tdist.P2POp(tdist.irecv, buf, src, tag=tag))
            outs.append(buf)
        if self.backend == "nccl":
            reqs = tdist.batch_isend_irecv(ops)
        else:
            reqs = [op.op(op.tensor, op.peer, tag=op.tag) for op in ops]
        for req in reqs:
            req.wait()
        return [o.to(self.device) for o in outs]

    def barrier(self) -> None:
        if self.size > 1:
            tdist.barrier()


def make_grid_mesh(n_ranks: int | None = None, backend: str | None = None,
                   device: torch.device | str = "cuda") -> GridMesh:
    """The (close-to-square) process grid over the default
    ``torch.distributed`` group, for this process's rank.

    ``n_ranks`` defaults to the group's size (1 without a group) and must
    equal it when a group exists.  ``backend`` is the caller's explicit
    choice and must be the group's; with one rank and no group it is
    recorded as given (None: no process group).  ``device`` is where this
    rank's tensors live."""
    device = require_cuda(device)
    if tdist.is_available() and tdist.is_initialized():
        world, rank = tdist.get_world_size(), tdist.get_rank()
        have = tdist.get_backend()
        if backend is None or backend != have:
            raise ValueError(f"make_grid_mesh: backend {backend!r}, but the process group "
                             f"runs {have!r}")
    else:
        world, rank = 1, 0
    n = world if n_ranks is None else int(n_ranks)
    if n != world:
        raise ValueError(f"make_grid_mesh: {n} ranks asked for, the process group has {world}")
    return GridMesh(shape=mesh_shape(n), rank=rank, backend=backend, device=device)


def init_process_group(backend: str, rank: int, world: int, init_method: str,
                       timeout_s: float = 300.0) -> None:
    """``torch.distributed.init_process_group`` with an explicit address (a
    ``tcp://host:port`` or ``file://`` URL), world size and rank; a
    collective that waits ``timeout_s`` raises."""
    tdist.init_process_group(backend, init_method=init_method, rank=rank,
                             world_size=world,
                             timeout=datetime.timedelta(seconds=timeout_s))


def state_spec() -> tuple:
    """The partition of a (nc, nx, ny[, nz]) state: z and the components
    stay local."""
    return (None, "x", "y")


def field_spec() -> tuple:
    """The partition of an (nx, ny[, nz]) cell field."""
    return ("x", "y")


# -------------------------------------------------------------- the blocks

@dataclasses.dataclass(frozen=True, eq=False)
class Block:
    """This rank's block of a grid of ``shape`` on ``mesh``: the owned
    ranges between ``bounds`` (the mx + 1 and my + 1 boundaries along x and
    y), and tensors held with ``width`` ghost cells on each side that has a
    neighbour (an int, or one per decomposed axis: :meth:`ring`)."""

    mesh: GridMesh
    shape: tuple[int, ...]
    bounds: tuple[tuple[int, ...], tuple[int, ...]]
    width: int | tuple[int, int]

    @classmethod
    def of(cls, mesh: GridMesh, shape, width: int = STATE_HALO) -> "Block":
        """The block of ``mesh``'s rank under :func:`split_ranges`."""
        shape = tuple(int(n) for n in shape)
        if len(shape) not in (2, 3):
            raise ValueError(f"Block: grid {shape} is not 2D or 3D")
        return cls(mesh, shape, tuple(split_ranges(shape[a], mesh.shape[a]) for a in (0, 1)),
                   int(width))

    def with_width(self, width) -> "Block":
        return dataclasses.replace(
            self, width=tuple(int(w) for w in width) if isinstance(width, tuple) else int(width))

    def ring(self, axis: int) -> int:
        """The ghost width along decomposed ``axis`` (0 or 1)."""
        return self.width[axis] if isinstance(self.width, tuple) else self.width

    def owned_range(self, axis: int, coord: int | None = None) -> tuple[int, int]:
        if axis >= 2:
            return 0, self.shape[axis]
        c = self.mesh.coords[axis] if coord is None else coord
        return self.bounds[axis][c], self.bounds[axis][c + 1]

    def ghosts(self, axis: int) -> tuple[int, int]:
        """Ghost cells held before and after the owned range along ``axis``."""
        if axis >= 2:
            return 0, 0
        c, m = self.mesh.coords[axis], self.mesh.shape[axis]
        w = self.ring(axis)
        return (w if c > 0 else 0), (w if c < m - 1 else 0)

    def ext_range(self, axis: int) -> tuple[int, int]:
        lo, hi = self.owned_range(axis)
        gl, gr = self.ghosts(axis)
        return lo - gl, hi + gr

    @property
    def owned_shape(self) -> tuple[int, ...]:
        return tuple(hi - lo for lo, hi in (self.owned_range(a) for a in range(len(self.shape))))

    @property
    def ext_shape(self) -> tuple[int, ...]:
        return tuple(hi - lo for lo, hi in (self.ext_range(a) for a in range(len(self.shape))))

    @property
    def has_ghosts(self) -> bool:
        return any(g for a in (0, 1) for g in self.ghosts(a))

    @property
    def parity(self) -> int:
        """The index sum of the extended block's origin, mod 2: the colour
        offset of the red-black kernels on it."""
        return sum(self.ext_range(a)[0] for a in range(len(self.shape))) % 2

    def fits(self) -> bool:
        """Whether every rank's owned range is at least the ring deep along
        each decomposed axis (ghosts come from the next block only)."""
        for a in (0, 1):
            b = self.bounds[a]
            if len(b) > 2 and min(hi - lo for lo, hi in zip(b, b[1:])) < self.ring(a):
                return False
        return True

    def aligned(self, factors) -> bool:
        """Whether the interior boundaries are even along every decomposed
        axis that ``factors`` coarsens: no coarsening pair straddles two
        blocks."""
        return all(factors[a] == 1 or all(x % 2 == 0 for x in self.bounds[a][1:-1])
                   for a in (0, 1))

    def coarsen(self, factors) -> "Block":
        """The block of the next coarser level (pairs summed along factor-2
        axes; an odd last range rounds up)."""
        shape = tuple(-(-n // 2) if f == 2 else n for n, f in zip(self.shape, factors))
        bounds = tuple(tuple(-(-x // 2) for x in self.bounds[a]) if factors[a] == 2
                       else self.bounds[a] for a in (0, 1))
        return dataclasses.replace(self, shape=shape, bounds=bounds)

    def coarse_ring(self, factors) -> "Block":
        """The next coarser level's block whose ring covers the same cells:
        :meth:`coarsen` with the width halved along each coarsened axis (an
        even ring on aligned boundaries)."""
        ring = tuple(self.ring(a) // 2 if factors[a] == 2 else self.ring(a) for a in (0, 1))
        return self.coarsen(factors).with_width(ring)

    def level_blocks(self, shapes, factors, replicate_below: int,
                     widths=None) -> tuple["Block", ...]:
        """The blocks of a hierarchy's leading levels that stay decomposed,
        from this block down (the levels' whole ``shapes``, the ``factors``
        between them, each level's ring ``widths[l]``, or this block's): a
        level stays while it has more than ``replicate_below`` cells, every
        range holds the ring and no coarsening pair straddles two blocks;
        the levels below are replicated.  The one rule of every
        hierarchy's decomposition."""
        blocks, b = [], self
        for level, (shape, f) in enumerate(zip(shapes, factors)):
            if widths is not None:
                b = b.with_width(widths[level])
            if math.prod(shape) <= replicate_below or not b.fits() or not b.aligned(f):
                break
            blocks.append(b)
            b = b.coarsen(f)
        return tuple(blocks)

    def walk_levels(self, shapes, factors, replicate_below: int, top, coarsen,
                    widths=None) -> tuple[tuple["Block", ...], list]:
        """A hierarchy's levels over this block: the decomposed levels'
        blocks (:meth:`level_blocks`) and each level's stencil, owned on a
        decomposed level and whole on a replicated one.  ``top`` is the
        finest level's owned stencil (gathered when no level is decomposed),
        ``coarsen(cur, level, blk)`` the next level's stencil from level
        ``level``'s (``blk`` its block, None when replicated); the first
        replicated level is gathered from the last decomposed level's
        blocks."""
        from thermalporous_torch.core.stencil import map_stencil

        blocks = self.level_blocks(shapes, factors, replicate_below, widths)
        cur = top if blocks else map_stencil(top, lambda t, lead: self.gather(t, lead=lead))
        levels = [cur]
        for level in range(len(shapes) - 1):
            blk = blocks[level] if level < len(blocks) else None
            cur = coarsen(cur, level, blk)
            if level + 1 == len(blocks):
                coarse = blk.coarsen(factors[level])
                cur = map_stencil(cur, lambda t, lead: coarse.gather(t, lead=lead))
            levels.append(cur)
        return blocks, levels

    def through_coarse(self, factors, rc: torch.Tensor, solve, replicate: bool,
                       lead: int = 1, out: "Block | None" = None) -> torch.Tensor:
        """The next level's correction ``solve(rc)`` of this rank's restricted
        residual ``rc``; when that level is replicated (``replicate``),
        ``rc`` all-gathered onto it first and the rank's part cut out of the
        correction.  With ``out`` (a block of the next level) the
        correction comes back on ``out``'s extended block: cut from the
        whole correction, or extended by one exchange."""
        coarse = self.coarsen(factors)
        if not replicate:
            ec = solve(rc)
            return ec if out is None else out.extend(ec, lead=lead)
        whole = solve(coarse.gather(rc, lead=lead))
        return (coarse.cut(whole, lead=lead, ghosts=False) if out is None
                else out.cut(whole, lead=lead))

    def reframe(self, x: torch.Tensor, other: "Block", lead: int = 1) -> torch.Tensor:
        """``x``, held on this block's extended block, cut to the extended
        block of ``other`` (the same owned block, a ring no deeper)."""
        sl = tuple(slice(other.ext_range(a)[0] - self.ext_range(a)[0],
                         other.ext_range(a)[1] - self.ext_range(a)[0])
                   for a in range(len(self.shape)))
        return x[(slice(None),) * lead + sl].contiguous()

    def on_whole(self, fn, x: torch.Tensor, lead: int = 1) -> torch.Tensor:
        """``fn`` of the whole tensor put together from every rank's owned
        block ``x``, and this rank's owned part of its result."""
        return self.cut(fn(self.gather(x, lead=lead)), lead=lead, ghosts=False)

    # ------------------------------------------------------------- slicing
    def _slices(self, ranges, lead: int, origin=None) -> tuple:
        origin = origin or (0,) * len(self.shape)
        return (slice(None),) * lead + tuple(slice(lo - o, hi - o)
                                             for (lo, hi), o in zip(ranges, origin))

    def owned(self, x: torch.Tensor, lead: int = 1) -> torch.Tensor:
        """The owned part of an extended-block tensor (``x`` itself when the
        block holds no ghosts), contiguous."""
        if not self.has_ghosts:
            return x
        ext = [self.ext_range(a) for a in range(len(self.shape))]
        sl = self._slices([self.owned_range(a) for a in range(len(self.shape))], lead,
                          origin=[lo for lo, _ in ext])
        return x[sl].contiguous()

    def cut(self, x: torch.Tensor, lead: int = 1, ghosts: bool = True) -> torch.Tensor:
        """This rank's extended block (``ghosts``) or owned block of a whole
        tensor, contiguous (``x`` itself for one rank)."""
        if self.mesh.size == 1:
            return x
        rng = self.ext_range if ghosts else self.owned_range
        return x[self._slices([rng(a) for a in range(len(self.shape))], lead)].contiguous()

    def extend(self, x: torch.Tensor, lead: int = 1) -> torch.Tensor:
        """An owned-block tensor with its ghost ring filled from the mesh
        neighbours: along x, then along y of the x-extended tensor, so that
        the corners come along.  ``x`` itself when the block holds no
        ghosts."""
        if not self.has_ghosts:
            return x
        mesh = self.mesh
        t0 = time.perf_counter()
        for a in (0, 1):
            gl, gr = self.ghosts(a)
            if not (gl or gr):
                continue
            axis = lead + a
            w = self.ring(a)
            n = x.shape[axis]
            c = list(mesh.coords)
            nbr = lambda step: mesh.rank_at(*[ci + (step if i == a else 0)
                                              for i, ci in enumerate(c)])
            slab = list(x.shape)
            slab[axis] = w
            sends, recvs = [], []
            # tag 4a: a slice travelling towards lower coordinates, 4a + 1: higher
            if gl:
                sends.append((nbr(-1), 4 * a, x.narrow(axis, 0, w)))
                recvs.append((nbr(-1), 4 * a + 1, tuple(slab), x.dtype))
            if gr:
                sends.append((nbr(+1), 4 * a + 1, x.narrow(axis, n - w, w)))
                recvs.append((nbr(+1), 4 * a, tuple(slab), x.dtype))
            got = mesh.exchange(sends, recvs)
            parts = ([got.pop(0)] if gl else []) + [x] + ([got.pop(0)] if gr else [])
            x = torch.cat(parts, dim=axis)
        mesh.stats["exchanges"] += 1
        # host-staged slices are copied back before this point: the wall is
        # the exchange's; over NCCL it is only the time to queue it
        mesh.stats["exchange_s"] += time.perf_counter() - t0
        return x

    def pipeline(self, axis: int, sweep, start: tuple, reverse: bool = False):
        """This rank's stage of a sweep that runs along decomposed ``axis``
        (0 or 1) through the ranks in turn: the carry (a tuple of planes,
        of ``start``'s shapes and dtypes) arrives from the previous rank
        along the axis (the next one with ``reverse``; the first rank takes
        ``start``), ``sweep(carry) -> (out, carry)`` runs over this rank's
        planes, and its carry goes on to the next rank.  Ranks at other
        coordinates of the other mesh axis run independent pipelines.
        Returns ``out``.  The line solves' Thomas recurrences across ranks
        (``precond/chebyshev.py``); a carry that does not arrive raises
        (the process group's timeout)."""
        mesh = self.mesh
        c = list(mesh.coords)
        step = -1 if reverse else 1
        nbr = lambda i: (mesh.rank_at(*[i if k == axis else ci for k, ci in enumerate(c)])
                         if 0 <= i < mesh.shape[axis] else None)
        src, dst = nbr(c[axis] - step), nbr(c[axis] + step)
        # tag 16 + 2a: a carry travelling towards higher coordinates, + 1 lower
        tag = 16 + 2 * axis + int(reverse)
        carry = start
        if src is not None:
            t0 = time.perf_counter()
            carry = tuple(mesh.exchange([], [(src, tag, tuple(t.shape), t.dtype)
                                             for t in start]))
            mesh.stats["carries"] += 1
            mesh.stats["exchange_s"] += time.perf_counter() - t0
        out, carry = sweep(carry)
        if dst is not None:
            t0 = time.perf_counter()
            mesh.exchange([(dst, tag, t) for t in carry], [])
            mesh.stats["carries"] += 1
            mesh.stats["exchange_s"] += time.perf_counter() - t0
        return out

    def fold(self, y: torch.Tensor, lead: int = 1) -> torch.Tensor:
        """The adjoint of :meth:`extend`: each ghost slab of the
        extended-block tensor ``y`` sent back to the rank that owns those
        cells and added to them there, along y, then along x of the
        y-folded tensor (extend's order reversed, so that a corner's share
        reaches the diagonal neighbour through the side one); the owned
        block.  Summed over the ranks, ⟨extend(x), y⟩ = ⟨x, fold(y)⟩.  A
        side with no neighbour holds no ghosts (the ring stops at the
        grid's boundary), so nothing is filled and nothing folds back
        there."""
        if not self.has_ghosts:
            return y
        mesh = self.mesh
        t0 = time.perf_counter()
        for a in (1, 0):
            gl, gr = self.ghosts(a)
            if not (gl or gr):
                continue
            axis = lead + a
            n = y.shape[axis]
            c = list(mesh.coords)
            nbr = lambda step: mesh.rank_at(*[ci + (step if i == a else 0)
                                              for i, ci in enumerate(c)])
            core = y.narrow(axis, gl, n - gl - gr).clone()
            slab = list(y.shape)
            slab[axis] = self.ring(a)
            sends, recvs = [], []
            # tags as extend's: 4a towards lower coordinates, 4a + 1 higher
            if gl:
                sends.append((nbr(-1), 4 * a, y.narrow(axis, 0, gl)))
                recvs.append((nbr(-1), 4 * a + 1, tuple(slab), y.dtype))
            if gr:
                sends.append((nbr(+1), 4 * a + 1, y.narrow(axis, n - gr, gr)))
                recvs.append((nbr(+1), 4 * a, tuple(slab), y.dtype))
            got = mesh.exchange(sends, recvs)
            m = core.shape[axis]
            if gl:
                core.narrow(axis, 0, gl).add_(got.pop(0))
            if gr:
                core.narrow(axis, m - gr, gr).add_(got.pop(0))
            y = core
        mesh.stats["exchanges"] += 1
        mesh.stats["exchange_s"] += time.perf_counter() - t0
        return y

    def pad(self, x: torch.Tensor, lead: int = 1) -> torch.Tensor:
        """The adjoint of :meth:`owned`: an owned-block tensor in the
        extended block, its ghost ring zero."""
        if not self.has_ghosts:
            return x
        shape = list(x.shape)
        for a in (0, 1):
            shape[lead + a] = self.ext_shape[a]
        out = x.new_zeros(shape)
        ext = [self.ext_range(a) for a in range(len(self.shape))]
        sl = self._slices([self.owned_range(a) for a in range(len(self.shape))], lead,
                          origin=[lo for lo, _ in ext])
        out[sl] = x
        return out

    def gather(self, x: torch.Tensor, lead: int = 1) -> torch.Tensor:
        """The whole tensor on every rank from each rank's owned block
        ``x`` (``x`` itself for one rank)."""
        return _assemble(self.mesh, x, lead, self.bounds, self.shape)


def _assemble(mesh: GridMesh, x: torch.Tensor, lead: int, bounds, shape) -> torch.Tensor:
    """Every rank's owned block (of ``bounds``) put together into the whole
    tensor, on every rank.  The blocks are padded to the largest for one
    all-gather."""
    if mesh.size == 1:
        return x
    dim = len(shape)
    sizes = []
    for r in range(mesh.size):
        ix, iy = divmod(r, mesh.shape[1])
        ext = [bounds[0][ix + 1] - bounds[0][ix], bounds[1][iy + 1] - bounds[1][iy]]
        sizes.append(tuple(x.shape[:lead]) + tuple(ext) + tuple(shape[2:]))
    big = max(math.prod(s) for s in sizes)
    flat = torch.zeros(big, dtype=x.dtype, device=x.device)
    flat[: x.numel()] = x.reshape(-1)
    parts = mesh.all_gather(flat)
    out = torch.empty(tuple(x.shape[:lead]) + tuple(shape), dtype=x.dtype, device=x.device)
    for r, (part, s) in enumerate(zip(parts, sizes)):
        ix, iy = divmod(r, mesh.shape[1])
        sl = ((slice(None),) * lead + (slice(bounds[0][ix], bounds[0][ix + 1]),
                                       slice(bounds[1][iy], bounds[1][iy + 1]))
              + (slice(None),) * (dim - 2))
        out[sl] = part[: math.prod(s)].reshape(s)
    return out


# ------------------------------------------------------- placing arrays

@dataclasses.dataclass
class ShardedProblemData(ProblemData):
    """This rank's extended block of a :class:`ProblemData` (every field,
    the wells' too), with the :class:`Block` it was cut to."""

    block: Block | None = None

    def with_wells(self, wells: WellFields) -> "ShardedProblemData":
        """The block under other well fields: whole-grid fields (as
        ``build_well_fields`` gives them) are cut to this block, block-shaped
        ones are taken as they are."""
        blk = self.block
        cut = {}
        for name in WELL_FIELDS:
            f = getattr(wells, name)
            cut[name] = blk.cut(f, lead=0) if tuple(f.shape) == blk.shape else f
        out = ProblemData.with_wells(self, WellFields(**cut))
        return ShardedProblemData(out.fields, blk)


def block_model(model, block: Block):
    """``model`` on ``block``'s extended block: a shallow copy whose grid
    has the extended shape (the spacing, gravity and depths along the local
    z are the whole grid's), as the residual kernels and ``initial_state``
    of a block need it.  ``model`` itself when it already is."""
    if model.grid.shape == block.ext_shape:
        return model
    out = copy.copy(model)
    out.grid = dataclasses.replace(model.grid, shape=block.ext_shape)
    return out


def shard_state(u: torch.Tensor, mesh: GridMesh) -> torch.Tensor:
    """This rank's extended block (ghost ring :data:`STATE_HALO` deep) of a
    whole state (nc, nx, ny[, nz]), on the mesh's device."""
    blk = Block.of(mesh, tuple(u.shape[1:]))
    return blk.cut(u.to(mesh.device), lead=1)


def shard_problem_data(data: ProblemData, mesh: GridMesh) -> ShardedProblemData:
    """This rank's extended block of every field of ``data`` (each array of
    ≥ 2 dims is a field: the wells' too), on the mesh's device."""
    blk = Block.of(mesh, tuple(data.fields.shape[1:]))
    return ShardedProblemData(blk.cut(data.fields.to(mesh.device), lead=1), blk)


def replicated(x: torch.Tensor, mesh: GridMesh) -> torch.Tensor:
    """``x`` as rank 0 holds it, on every rank (a broadcast)."""
    x = x.to(mesh.device).contiguous()
    if mesh.size == 1:
        return x
    buf = x.cpu() if mesh._staged else x.clone()
    tdist.broadcast(buf, src=0)
    return buf.to(mesh.device)


def block_of(u: torch.Tensor, mesh: GridMesh, width: int = STATE_HALO) -> Block:
    """The :class:`Block` of an extended-block state ``u`` (nc, *grid): the
    global grid from every rank's owned extents (a collective)."""
    dim = u.dim() - 1
    c = mesh.coords
    own = []
    for a in range(dim):
        g = 0
        if a < 2:
            g = width * (c[a] > 0) + width * (c[a] < mesh.shape[a] - 1)
        own.append(u.shape[1 + a] - g)
    ext = torch.tensor(own, dtype=torch.int64)
    allx = [p.tolist() for p in mesh.all_gather(ext.to(mesh.device))] if mesh.size > 1 \
        else [own]
    bounds = []
    for a in (0, 1):
        line = [allx[mesh.rank_at(*((i, c[1]) if a == 0 else (c[0], i)))][a]
                for i in range(mesh.shape[a])]
        bounds.append(tuple(int(v) for v in np.concatenate([[0], np.cumsum(line)])))
    shape = (bounds[0][-1], bounds[1][-1]) + tuple(own[2:])
    return Block(mesh, shape, tuple(bounds), width)


def gather_state(u: torch.Tensor, mesh: GridMesh) -> torch.Tensor:
    """The whole state, on every rank, from each rank's extended block
    (the counterpart of ``np.asarray`` of a sharded array): for tests,
    checkpoints and comparisons."""
    blk = block_of(u, mesh)
    return blk.gather(blk.owned(u, lead=1), lead=1)
