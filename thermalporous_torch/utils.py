"""Utilities: finite checks, profiling, convergence-history summaries
(counterpart of ``thermalporous_tpu/utils.py``).

The checks take a tensor or any nest of them (dicts, lists, tuples,
dataclasses); leaves that are not tensors are skipped, as the reference
skips leaves without a dtype.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch

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


def all_finite(tree) -> bool:
    """True iff every tensor leaf is free of NaN/Inf (one device-to-host
    read per leaf)."""
    return all(bool(torch.isfinite(leaf).all()) for leaf in _leaves(tree)
               if isinstance(leaf, torch.Tensor))


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
    (chrome://tracing, Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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


def power_iteration(matvec, shape, dtype: torch.dtype = torch.float64,
                    iters: int = 20, seed: int = 0,
                    device: torch.device | str = "cuda") -> torch.Tensor:
    """Estimate the dominant eigenvalue magnitude of a linear operator (a
    0-dim tensor); the start vector is normal from a ``torch.Generator``
    seeded with ``seed`` on ``device``."""
    device = require_cuda(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    v = torch.randn(shape, dtype=dtype, device=device, generator=gen)
    v = v / torch.linalg.vector_norm(v)
    lam = torch.zeros((), dtype=dtype, device=device)
    for _ in range(iters):
        w = matvec(v)
        lam = torch.linalg.vector_norm(w)
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
