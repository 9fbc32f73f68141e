"""Spans and counters of the solver's layers, on the clock of
``torch.profiler``'s events.

Off by default.  ``with recording() as rec:`` turns it on for a block and
yields the record: ``rec.spans`` (every :class:`Span` opened in the block,
in the order they opened), then ``rec.counters`` (the block's totals).
Three calls instrument the program:

- ``with span(name):`` a layer's interval; ``span(name).set(key, value)``
  attaches a small attribute (set it only where the value is at hand: off,
  ``set`` does nothing and the value is never stored);
- ``count(name, n=1)``: credited to the innermost open span and to the
  record's total;
- ``host_read(t)``: the one place where the solver turns a device tensor
  into host values — ``t.item()`` of a 0-dim tensor, ``t.cpu()`` of any
  other — timed as a ``wait`` span and counted as ``host.reads``.

Off, ``span`` returns one preallocated no-op object and ``host_read`` is
the read plus one test of the flag: no device operation, no synchronize,
no allocation.  On, a span adds two host clock reads and no synchronize: a
``wait`` times a read the solver makes anyway.  The clock is
``time.time_ns()``, the wall clock ``torch.profiler``'s events are stamped
on, so a span's interval holds the operators called inside it and, on the
card, the launches of its kernels.

Spans of the port (the layer each belongs to, its parent in brackets):
``setup.kernel_library`` (``kernels/_lib.py``), ``setup.simulator``,
``setup.coarsening_bake`` [setup.simulator], ``episode``, ``step``
[episode, attribute ``retries``], ``attempt`` [step, ``dt``, ``failed``]
(``solve/timeloop.py``); ``newton.iter`` [attempt, ``k``], ``residual``
[newton.iter or attempt, ``why``: start / anchor / line_search],
``fgmres`` [newton.iter, ``iters``] (``solve/newton.py``); ``assembly``
[newton.iter or setup.coarsening_bake] (``models/base.py``); ``pc_setup``
[newton.iter], ``gmg_setup`` [pc_setup, ``field``], ``pc_apply`` [fgmres]
(``precond/cpr.py``); ``wait`` [the innermost].  Counters: ``host.reads``
(``host_read``); ``assembly.probed``, one a probed assembly, and
``assembly.probes``, its J·v products (``models/base.py:probe_stencil``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch


class Span:
    """One interval: ``name``, ``start_ns``, ``end_ns`` (0 while open), its
    ``id``, its ``parent``'s id and the id of its ``episode`` (None outside
    one), ``attrs`` and the ``counts`` credited to it."""

    __slots__ = ("name", "id", "parent", "episode", "start_ns", "end_ns", "attrs", "counts")

    def __init__(self, name: str):
        self.name = name
        self.attrs: dict = {}
        self.counts: dict = {}
        self.end_ns = 0

    def set(self, key: str, value) -> "Span":
        self.attrs[key] = value
        return self

    def __enter__(self) -> "Span":
        rec = _rec
        top = _open[-1] if _open else None
        self.id = len(rec.spans)
        self.parent = None if top is None else top.id
        self.episode = self.id if self.name == "episode" else (
            None if top is None else top.episode)
        rec.spans.append(self)
        _open.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        _open.pop()
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"episode={self.episode}, {self.start_ns}..{self.end_ns}, {self.attrs})")


class _Off:
    """What :func:`span` returns while the recorder is off: false, and every
    use a no-op."""

    __slots__ = ()

    def set(self, key, value) -> "_Off":
        return self

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


@dataclasses.dataclass
class Record:
    spans: list
    counters: dict


OFF = _Off()
_rec: Record | None = None
_open: list[Span] = []


def span(name: str):
    """A span named ``name`` to enter with ``with`` (:data:`OFF` while the
    recorder is off)."""
    if _rec is None:
        return OFF
    return Span(name)


def count(name: str, n: int = 1) -> None:
    if _rec is None:
        return
    _rec.counters[name] = _rec.counters.get(name, 0) + n
    if _open:
        counts = _open[-1].counts
        counts[name] = counts.get(name, 0) + n


def host_read(t: torch.Tensor):
    """``t.item()`` of a 0-dim tensor, ``t.cpu()`` of any other: the read
    that waits for the device; while recording, counted as ``host.reads``
    and timed as a ``wait`` span (attribute ``values``: the elements of a
    tensor read whole)."""
    if _rec is None:
        return t.item() if t.dim() == 0 else t.cpu()
    count("host.reads")
    with Span("wait") as sp:
        if t.dim() == 0:
            return t.item()
        sp.attrs["values"] = t.numel()
        return t.cpu()


@contextlib.contextmanager
def recording():
    """Turn the recorder on for the block and yield its :class:`Record`;
    inside another recording, yield that one and leave it on."""
    global _rec
    if _rec is not None:
        yield _rec
        return
    _rec = Record(spans=[], counters={})
    try:
        yield _rec
    finally:
        _rec = None
        _open.clear()

