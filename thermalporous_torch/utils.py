"""Utilities: finite checks, profiling, convergence-history summaries
(counterpart of ``thermalporous_tpu/utils.py``).

The checks take a tensor or any nest of them (dicts, lists, tuples,
dataclasses); leaves that are not tensors are skipped, as the reference
skips leaves without a dtype.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import time

import numpy as np
import torch

from thermalporous_torch import tracing
from thermalporous_torch._device import require_cuda


def _leaves(tree):
    """The leaves of a nest in the reference's pytree order (None is an
    empty subtree, dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in _leaves(x)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in _leaves(getattr(tree, f.name))]
    return [tree]


def all_finite(tree, mesh=None) -> bool:
    """True iff every tensor leaf is free of NaN/Inf (one device-to-host
    read per leaf); over a grid decomposition (``mesh``, leaves the ranks'
    blocks) iff every rank's are, the same answer on every rank."""
    ok = all(bool(torch.isfinite(leaf).all()) for leaf in _leaves(tree)
             if isinstance(leaf, torch.Tensor))
    if mesh is None:
        return ok
    return not bool(mesh.allreduce_max(torch.tensor(0 if ok else 1)))


def assert_all_finite(tree, name: str = "array") -> None:
    """Raise ``FloatingPointError`` naming the first leaf with non-finite
    entries and how many it has."""
    for i, leaf in enumerate(_leaves(tree)):
        if isinstance(leaf, torch.Tensor) and not bool(torch.isfinite(leaf).all()):
            bad = int((~torch.isfinite(leaf)).sum())
            raise FloatingPointError(f"{name}[leaf {i}]: {bad} non-finite entries")


def finite_guard(fn):
    """Wrap a step function to raise on non-finite outputs (debug tool)."""

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_all_finite(out, name=getattr(fn, "__name__", "step output"))
        return out

    return wrapped


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (the card's kernels too when CUDA
    is available), written to ``log_dir/trace.json`` as a Chrome trace
    (chrome://tracing, Perfetto), with the program's spans
    (:mod:`thermalporous_torch.tracing`, recording for the block) beside
    it in ``log_dir/spans.json``, on the same clock and time base."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with tracing.recording() as rec, torch.profiler.profile(activities=acts) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:      # the time base is in the trace's header
        found = re.search(r'"baseTimeNanoseconds":\s*(\d+)', fh.read(1 << 16))
    base = int(found.group(1)) if found else 0
    # each closed span a complete event, in µs after the trace's time base
    events = [{"ph": "X", "cat": "span", "name": s.name, "pid": "thermalporous_torch spans",
               "tid": 0, "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
               "args": {"id": s.id, "parent": s.parent, "episode": s.episode,
                        **s.attrs, **s.counts}}
              for s in rec.spans if s.end_ns]
    with open(os.path.join(log_dir, "spans.json"), "w") as fh:
        json.dump({"traceEvents": events, "baseTimeNanoseconds": base,
                   "displayTimeUnit": "ms"}, fh)


def _synchronize(sync) -> None:
    if sync is None:
        # a CUDA tensor is in play once this process has initialised CUDA
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.current_stream().synchronize()
        return
    for leaf in _leaves(sync):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            torch.cuda.current_stream(leaf.device).synchronize()


class Timer:
    """Wall-clock timer for device code: on exit it waits for the work
    queued on the current CUDA stream (of the devices of the tensors in
    ``sync``, or, with no ``sync``, of the current device once CUDA is in
    use), then sets ``seconds``."""

    def __init__(self, name: str = "", sync=None):
        self.name = name
        self.sync = sync

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _synchronize(self.sync)
        self.seconds = time.perf_counter() - self.t0


_M32 = np.uint64(0xFFFFFFFF)


def _threefry2x32(k1: int, k2: int, x1: np.ndarray, x2: np.ndarray):
    """Threefry-2x32 (20 rounds) of the counter words ``(x1, x2)`` under the
    key ``(k1, k2)``: 32-bit words held in uint64 arrays."""
    rotl = lambda x, r: ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & _M32
    ks = [np.uint64(k1), np.uint64(k2), np.uint64(k1 ^ k2 ^ 0x1BD11BDA)]
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + np.uint64(i + 1)) & _M32
    return x


def normal_start(shape, dtype: torch.dtype, seed: int = 0,
                 device: torch.device | str = "cuda") -> torch.Tensor:
    """The reference's start vector ``jax.random.normal(PRNGKey(seed),
    shape, dtype)``: the same Threefry counter bits (its partitionable
    form) and the same map to (−1, 1), then √2·erfinv, the one step that
    may differ from it in the last bits (torch's erfinv against XLA's).
    f32 and f64 only."""
    device = require_cuda(device)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"normal_start: dtype {dtype}")
    npt = np.float64 if dtype == torch.float64 else np.float32
    idx = np.arange(math.prod(shape), dtype=np.uint64)
    b1, b2 = _threefry2x32(seed >> 32, seed & 0xFFFFFFFF, idx >> np.uint64(32), idx & _M32)
    if npt is np.float64:
        bits = (((b1 << np.uint64(32)) | b2) >> np.uint64(12)) | np.uint64(0x3FF0000000000000)
    else:
        bits = (((b1 ^ b2) >> np.uint64(9)) | np.uint64(0x3F800000)).astype(np.uint32)
    unit = bits.view(npt) - npt(1.0)
    lo = np.nextafter(npt(-1.0), npt(0.0))
    u = np.maximum(lo, unit * (npt(1.0) - lo) + lo).astype(npt)
    z = torch.erfinv(torch.as_tensor(u, device=device))
    return (torch.tensor(math.sqrt(2.0), dtype=dtype, device=device) * z).reshape(shape)


def power_iteration(matvec, shape, dtype: torch.dtype = torch.float64,
                    iters: int = 20, seed: int = 0,
                    device: torch.device | str = "cuda", block=None) -> torch.Tensor:
    """Estimate the dominant eigenvalue magnitude of a linear operator (a
    0-dim tensor) from the reference's start vector (:func:`normal_start`),
    so that a level's estimate after a few iterations is the reference's.

    With ``block`` (a :class:`~thermalporous_torch.dist.sharding.Block` of
    the grid ``shape``) ``matvec`` takes and returns owned blocks: the start
    is the whole grid's, cut to the owned block, and each norm sums the
    ranks' partials through the mesh, so that every rank holds the
    undecomposed estimate to rounding."""
    v = normal_start(shape, dtype, seed, device)
    if block is None or block.mesh.size == 1:
        norm = torch.linalg.vector_norm
    else:
        v = block.cut(v, lead=0, ghosts=False)
        norm = lambda t: torch.sqrt(block.mesh.allreduce_sum(torch.sum(t * t)))
    v = v / norm(v)
    lam = torch.zeros((), dtype=dtype, device=v.device)
    for _ in range(iters):
        w = matvec(v)
        lam = norm(w)
        v = w / torch.where(lam > 0, lam, 1.0)
    return lam


def convergence_summary(records) -> dict:
    """Aggregate a run's StepRecords into the papers' headline numbers."""
    if not records:
        return {}
    newton = np.array([r.newton_iters for r in records])
    ksp = np.array([r.ksp_iters for r in records])
    dts = np.array([r.dt for r in records])
    per_newton = ksp / np.maximum(newton, 1)
    return {
        "steps": len(records),
        "newton_per_step_mean": float(newton.mean()),
        "newton_per_step_max": int(newton.max()),
        "ksp_per_newton_mean": float(per_newton.mean()),
        "ksp_per_newton_max": float(per_newton.max()),
        "dt_min": float(dts.min()),
        "dt_max": float(dts.max()),
        "total_newton": int(newton.sum()),
        "total_ksp": int(ksp.sum()),
        "retries": int(sum(r.retries for r in records)),
    }
