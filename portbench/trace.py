"""The traced run's instruments, from the benchmark's own files.

- :class:`Spans`: a ``torch.cuda.synchronize()`` on each side of every
  call into a layer (the assembly, the preconditioner's set-up and apply,
  FGMRES), summed on the host's clock:
  the method of ``chip_smoke.py``'s phase 7, copied.  The wrappers take
  the place of ``solve/timeloop.py``'s ``newton_solve`` and
  ``solve/newton.py``'s ``fgmres`` for the span's duration.
- :class:`Stamps`: the host interval of every kernel wrapper call, with
  the call's least time on the card from its arguments (``roofline.py``),
  and of every layer call, unsynchronized, on the profiler's clock.
- :class:`Profile`: a ``torch.profiler`` profile of the device's activity
  alone, read from its raw events: the device's busy time, the operations
  that took most time, the device time of the kernels each wrapper call
  launched (each kernel linked to its launch), and the idle gaps by what
  the host was doing.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

import torch

from portbench import roofline

def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Synchronized spans around the calls into the assembly, the
    preconditioner's set-up and apply, and FGMRES: ``seconds[name]``,
    ``calls[name]``, and ``seconds["pc_apply_in_fgmres"]`` for the applies
    inside FGMRES; ``newton`` counts the Newton iterations of every solve,
    retried attempts included."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.newton = 0
        self._in_fgmres = 0

    def _timed(self, name, fn):
        def call(*args, **kw):
            sync(self.device)
            t = time.perf_counter()
            out = fn(*args, **kw)
            sync(self.device)
            dt = time.perf_counter() - t
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.calls[name] = self.calls.get(name, 0) + 1
            if name == "pc_apply" and self._in_fgmres:
                self.seconds["pc_apply_in_fgmres"] = (
                    self.seconds.get("pc_apply_in_fgmres", 0.0) + dt)
            return out
        return call

    @contextlib.contextmanager
    def active(self):
        from thermalporous_torch.solve import newton as tnewton
        from thermalporous_torch.solve import timeloop as ttimeloop

        real_solve, real_fgmres = ttimeloop.newton_solve, tnewton.fgmres
        timed_fgmres = self._timed("fgmres", real_fgmres)

        def solve(*, assemble, pc_setup, pc_apply, **kw):
            u, stats = real_solve(assemble=self._timed("assembly", assemble),
                                  pc_setup=self._timed("pc_setup", pc_setup),
                                  pc_apply=self._timed("pc_apply", pc_apply), **kw)
            self.newton += stats.iters
            return u, stats

        def fgmres(*args, **kw):
            self._in_fgmres += 1
            try:
                return timed_fgmres(*args, **kw)
            finally:
                self._in_fgmres -= 1

        ttimeloop.newton_solve, tnewton.fgmres = solve, fgmres
        try:
            yield self
        finally:
            ttimeloop.newton_solve, tnewton.fgmres = real_solve, real_fgmres


# (module, attribute) of every kernel wrapper the program's solver calls by
# module attribute, and the name its least time is reckoned under
_WRAPPERS = (
    ("thermalporous_torch.kernels.stencil", "block_matvec"),
    ("thermalporous_torch.kernels.stencil", "matvec"),
    ("thermalporous_torch.kernels.stencil", "chebyshev_smooth"),
    ("thermalporous_torch.kernels.stencil", "fused_stage2_rbgs"),
    ("thermalporous_torch.kernels.stencil", "block_rbgs_half_sweep"),
    ("thermalporous_torch.kernels.deep_cycle", "deep_correction"),
    ("thermalporous_torch.solve.timeloop", "fused_residual"),
    ("thermalporous_torch.solve.timeloop", "fused_jvp"),
)


class Stamps:
    """Host intervals, on the profiler's clock (``time.time_ns``), of every
    kernel wrapper call — with the call's least time on the card — and of
    every layer call, without a synchronize: the profile of the device's
    activity credits each call with the kernels it launched and names what
    the host was doing while the device idled."""

    def __init__(self):
        self.calls: list[tuple[int, int, str, float]] = []
        self.layers: list[tuple[int, int, str]] = []
        # every call of each wrapper, nested ones included
        self.seen: dict[str, int] = {}
        self._depth = 0
        self._wells: dict = {}

    def _wrapper(self, name, fn):
        def call(*args, **kw):
            self.seen[name] = self.seen.get(name, 0) + 1
            if self._depth:
                return fn(*args, **kw)
            self._depth += 1
            t = time.time_ns()
            try:
                out = fn(*args, **kw)
            finally:
                self._depth -= 1
            self.calls.append((t, time.time_ns(), name,
                               roofline.least_seconds(name, args, kw, self._wells)))
            return out
        # a wrapper counts its launches on the module attribute it is called by
        call.launches = 0
        return call

    def _layer(self, name, fn):
        def call(*args, **kw):
            t = time.time_ns()
            out = fn(*args, **kw)
            self.layers.append((t, time.time_ns(), name))
            return out
        return call

    def unseen(self, before: dict, after: dict) -> dict:
        """Kernel launches, by wrapper, beyond the calls of it that went
        through the stand-ins (``before``/``after``: the program's
        ``launch_counts()`` around the stamped window, a model form's
        ``_sp`` counter under its wrapper's name): launches the roofline
        would miss."""
        out = {}
        for _, attr in _WRAPPERS:
            launched = sum(after.get(k, 0) - before.get(k, 0) for k in (attr, attr + "_sp"))
            if launched > self.seen.get(attr, 0):
                out[attr] = launched - self.seen.get(attr, 0)
        return out

    @contextlib.contextmanager
    def active(self):
        import importlib

        from thermalporous_torch.solve import newton as tnewton
        from thermalporous_torch.solve import timeloop as ttimeloop

        saved = []
        for mod_name, attr in _WRAPPERS:
            mod = importlib.import_module(mod_name)
            real = getattr(mod, attr)
            saved.append((mod, attr, real))
            setattr(mod, attr, self._wrapper(attr, real))
        real_solve, real_fgmres = ttimeloop.newton_solve, tnewton.fgmres
        timed_solve = self._layer("newton", real_solve)

        def solve(*, residual, assemble, pc_setup, pc_apply, **kw):
            return timed_solve(residual=self._layer("residual", residual),
                               assemble=self._layer("assembly", assemble),
                               pc_setup=self._layer("pc_setup", pc_setup),
                               pc_apply=self._layer("pc_apply", pc_apply), **kw)

        ttimeloop.newton_solve = solve
        tnewton.fgmres = self._layer("fgmres", real_fgmres)
        try:
            yield self
        finally:
            ttimeloop.newton_solve, tnewton.fgmres = real_solve, real_fgmres
            for mod, attr, real in saved:
                # the launches counted on the stand-in go back to the wrapper
                if hasattr(real, "launches"):
                    real.launches += getattr(mod, attr).launches
                setattr(mod, attr, real)


@dataclasses.dataclass
class Profile:
    """The device's operations of a profile, (start_ns, end_ns, name), and
    the host's launch time of each, where the profile links it (None
    otherwise)."""

    ops: list
    launched: list

    @classmethod
    def of(cls, prof, kind=torch.autograd.DeviceType.CUDA) -> "Profile":
        """The operations of device type ``kind`` in ``prof`` (the CPU's
        in the CPU rehearsal)."""
        events = prof.profiler.kineto_results.events()
        host = {}
        for e in events:
            if e.device_type() != torch.autograd.DeviceType.CUDA and "aunch" in e.name():
                host[e.correlation_id()] = e.start_ns()
        ops, launched = [], []
        for e in events:
            if e.device_type() == kind:
                ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
                launched.append(host.get(e.correlation_id(),
                                         host.get(e.linked_correlation_id())))
        return cls(ops, launched)

    def busy_seconds(self) -> float:
        """Seconds in which at least one device operation ran."""
        return sum(e - s for s, e in merged(self.ops)) * 1e-9

    def top_ops(self, n: int = 10) -> list[list]:
        """The ``n`` device operations that took most time, by name."""
        by: dict[str, float] = {}
        for s, e, name in self.ops:
            by[name] = by.get(name, 0.0) + (e - s) * 1e-9
        return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_layer(self, layers, n: int = 10) -> list[list]:
        """The device's idle gaps between its operations, summed by the
        innermost layer the host was in at each gap's middle ("host" in
        none): the ``n`` largest sums."""
        busy = merged(self.ops)
        spans = sorted(layers)
        starts = [s for s, _, _ in spans]
        by: dict[str, float] = {}
        for (_, a), (b, _) in zip(busy, busy[1:]):
            mid = (a + b) // 2
            label = "host"
            # the latest-starting layer around the middle: the innermost
            for s, e, name in reversed(spans[:bisect.bisect_right(starts, mid)]):
                if e >= mid:
                    label = name
                    break
            by[label] = by.get(label, 0.0) + (b - a) * 1e-9
        return [[f"idle in {k}", v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def wrapper_seconds(self, calls) -> tuple[float, int]:
        """(device seconds of the operations launched inside the wrapper
        calls ``calls`` [(start_ns, end_ns, …)], operations so credited)."""
        calls = sorted(calls)
        starts = [c[0] for c in calls]
        total, count = 0.0, 0
        for (s, e, _), at in zip(self.ops, self.launched):
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= calls[i][1]:
                total += (e - s) * 1e-9
                count += 1
        return total, count


def merged(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]
