"""Start a world of gloo ranks in fresh processes on this machine's CPU.

`run_ranks(fn, world_size, workdir, *args)` spawns `world_size` processes
(the `spawn` start method: nothing of the parent's state is inherited),
joins each to the world through a `file://` store under `workdir` with one
torch thread, calls `fn(rank, world_size, *args)` there and returns the
ranks' results in rank order. `fn` must be importable by name (a
module-level function) and its result picklable by `torch.save`; a rank's
exception is raised here with its traceback.

A run on several cards is started instead by `torchrun --nproc-per-node N
script.py`, whose ranks call `mesh.init_process_group("cuda", "env://",
rank, world)` with the rank and world from its environment (README.md).
"""

from __future__ import annotations

import os
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from deformablelka_tpu_torch.parallel.mesh import init_process_group


def _rank_main(rank, fn, world_size, workdir, args):
    torch.set_num_threads(1)
    init_process_group("cpu", f"file://{Path(workdir) / 'store'}", rank, world_size)
    try:
        result = fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()
    torch.save(result, Path(workdir) / f"rank_{rank}.pt")


def run_ranks(fn, world_size: int, workdir, *args) -> list:
    """[fn(rank, world_size, *args) for each rank], each run in its own
    process of a `world_size` world."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    for stale in [workdir / "store", *workdir.glob("rank_*.pt")]:
        if stale.exists():
            os.remove(stale)
    mp.start_processes(_rank_main, args=(fn, world_size, str(workdir), args),
                       nprocs=world_size, join=True, start_method="spawn")
    return [torch.load(workdir / f"rank_{rank}.pt", weights_only=False)
            for rank in range(world_size)]
