"""Run a function on every rank of a grid mesh, one process each.

:func:`run_ranks` starts ``n`` processes (the "spawn" start method: each
imports the function by its module path, so it must live in an importable
module), gives each a ``torch.distributed`` process group over a file
store in a fresh temporary directory (no port to collide with), a
:class:`~thermalporous_torch.dist.sharding.GridMesh` and one CPU thread,
and calls ``fn(mesh, *args)``; each rank's result comes back through a
file in that directory.  A rank that raises makes the call raise; the
other ranks are stopped.  Kernels a CUDA run needs are built in the
parent first, so that the ranks do not race to build them.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from thermalporous_torch.dist.sharding import init_process_group, make_grid_mesh


def rank_device(device: str, backend: str, rank: int) -> torch.device:
    """The device of ``rank``: ``device`` itself, or for "cuda" with no
    index card ``rank`` under NCCL (a card per rank) and card 0 otherwise
    (gloo ranks sharing one card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
    return dev


def _rank_main(rank: int, n: int, backend: str, device: str, tmp: str, timeout_s: float,
               fn, args) -> None:
    torch.set_num_threads(1)
    dev = rank_device(device, backend, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_process_group(backend, rank, n, "file://" + os.path.join(tmp, "store"),
                       timeout_s=timeout_s)
    try:
        mesh = make_grid_mesh(n, backend=backend, device=dev)
        torch.save(fn(mesh, *args), os.path.join(tmp, f"rank{rank}.pt"))
        tdist.barrier()
    finally:
        tdist.destroy_process_group()


def run_ranks(fn, n: int, *args, backend: str = "gloo", device: str = "cpu",
              meanwhile=None, timeout_s: float = 300.0) -> tuple[list, object]:
    """``fn(mesh, *args)`` on ``n`` ranks over ``backend``, each rank's
    tensors on :func:`rank_device` of ``device``, and ``meanwhile()`` (if
    given) in this process while they run; returns (each rank's result,
    picklable, in rank order; ``meanwhile``'s result).  A rank that waits
    ``timeout_s`` on a collective raises, which stops them all."""
    if torch.device(device).type == "cuda":
        from thermalporous_torch.kernels import _lib

        _lib.build()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank_main,
                                 args=(n, backend, device, tmp, timeout_s, fn, args),
                                 nprocs=n, join=False, start_method="spawn")
        try:
            mine = meanwhile() if meanwhile is not None else None
        finally:
            while not ctx.join():
                pass
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(n)], mine
