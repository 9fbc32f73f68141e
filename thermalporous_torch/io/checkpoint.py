"""Checkpoints and exact resume (counterpart of
``thermalporous_tpu/io/checkpoint.py``, the same ``.npz`` layout: a file
written by either package loads in the other).

The state of a run is one array and the controller's clock: ``{u, t, dt,
step}`` and ``meta`` (JSON, with the failure-memory Δt cap when one is
active) round-trip exactly through one ``.npz``, so a killed run resumes
bit for bit.

A run decomposed over ranks checkpoints the whole state: every rank calls
``dist.sharding.gather_state`` (a collective), rank 0 writes it, and on
resume every rank reads the file and cuts its block with ``shard_state``
(``dist/dryrun.py``'s second scenario), so that the file is the same as an
undecomposed run's.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import torch

from thermalporous_torch._device import require_cuda


def save_checkpoint(path: str, u, t: float, dt: float, step: int,
                    meta: dict | None = None) -> str:
    """Write ``u`` (a tensor on any device, or an array) and the clock to
    ``path`` atomically: a crash never leaves a torn checkpoint."""
    host = u.detach().cpu().numpy() if isinstance(u, torch.Tensor) else np.asarray(u)
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, u=host, t=np.float64(t), dt=np.float64(dt), step=np.int64(step),
                 meta=json.dumps(meta or {}))
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, device: torch.device | str = "cuda",
                    dtype: torch.dtype | None = None):
    """``(u, t, dt, step, meta)`` of a checkpoint, ``u`` a tensor on
    ``device`` in ``dtype`` (default: the file's)."""
    device = require_cuda(device)
    with np.load(path, allow_pickle=False) as z:
        u = torch.as_tensor(z["u"], dtype=dtype, device=device)
        t = float(z["t"])
        dt = float(z["dt"])
        step = int(z["step"])
        meta = json.loads(str(z["meta"]))
    return u, t, dt, step, meta


class CheckpointManager:
    """Periodic snapshots with retention, as a ``Simulator.run`` callback."""

    def __init__(self, directory: str, every: int = 10, keep: int = 3, name: str = "ckpt"):
        self.directory = directory
        self.every = every
        self.keep = keep
        self.name = name
        os.makedirs(directory, exist_ok=True)
        # retention seeded from the files already on disk, so a resumed run
        # keeps pruning the previous run's files and latest() finds them
        self._written: list[str] = sorted(
            glob.glob(os.path.join(directory, f"{name}_*.npz")))
        self._last_step = (int(self._written[-1].rsplit("_", 1)[1].split(".")[0])
                           if self._written else 0)

    def __call__(self, step: int, t: float, u, record):
        # Only state-consistent records are snapshotted: the intermediate
        # records of a block pair a later state with their own clock.  The
        # cadence is "every `every` steps since the last snapshot", not
        # step % every == 0: retries shift the block-final step numbers, and
        # a modulus could miss every consistent record.
        if not getattr(record, "state_consistent", True):
            return
        if step - self._last_step < self.every:
            return
        path = os.path.join(self.directory, f"{self.name}_{step:07d}.npz")
        # the controller's NEXT Δt and its failure-memory cap make the
        # resumed run continue the uninterrupted trajectory exactly
        dt = record.next_dt or record.dt
        meta = None
        if getattr(record, "dt_cap", None) is not None:
            meta = {"dt_cap": record.dt_cap}
        save_checkpoint(path, u, t, dt, step, meta)
        self._last_step = step
        self._written.append(path)
        while len(self._written) > self.keep:
            old = self._written.pop(0)
            if os.path.exists(old):
                os.remove(old)

    def latest(self) -> str | None:
        return self._written[-1] if self._written else None
