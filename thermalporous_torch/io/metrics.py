"""Per-step telemetry as JSON lines (counterpart of
``thermalporous_tpu/io/metrics.py``, the same keys)."""

from __future__ import annotations

import json
import time


class MetricsLogger:
    """Append one JSON object per accepted step to a .jsonl file: the
    ``StepRecord``'s fields, ``extra``, ``wallclock`` since the logger was
    made and, given ``ncells``, ``cell_updates_per_s`` (cells × Newton
    iterations / the step's wall seconds).  Usable as a ``Simulator.run``
    callback."""

    def __init__(self, path: str, ncells: int | None = None, extra: dict | None = None):
        self.path = path
        self.ncells = ncells
        self.extra = extra or {}
        self._f = open(path, "a", buffering=1)
        self._t0 = time.time()

    def __call__(self, step: int, t: float, u, record):
        rec = record.as_dict()
        rec.update(self.extra)
        rec["wallclock"] = time.time() - self._t0
        if self.ncells and record.wall_s > 0:
            rec["cell_updates_per_s"] = self.ncells * record.newton_iters / record.wall_s
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
