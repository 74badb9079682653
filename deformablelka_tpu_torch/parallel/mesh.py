"""A mesh of ranks over `torch.distributed`, and batch sharding.

Port of `deformablelka_tpu/parallel/mesh.py`. The JAX package lays its
devices out as a named mesh and lets XLA place the collectives; here each
device is one process (a rank), and a `Mesh` lays the world's ranks out
row-major over named axes, as `jax.sharding.Mesh` lays out its devices,
with one process group per axis line. A rank asks for its coordinate and
its group on an axis ("data", "space"), and the collectives name that
group.

- `init_process_group(device_type, init_method, rank, world_size)` starts
  the world with the backend stated for the device: NCCL for "cuda", gloo
  for "cpu". It raises where NCCL is missing and never falls back.
- `make_mesh(("data",))` is a 1-D mesh over the world; `make_mesh(("data",
  "space"), shape=(n_dp, n_sp))` the 2-D one of the data × space step.
- `replicated(module)` broadcasts the parameters and buffers of a module
  from rank 0, so every rank starts from the same weights (JAX's
  replicated sharding, `P()`).
- `batch_sharding(mesh, n)` is this rank's contiguous slice of a batch of
  n along dim 0, and `shard_batch(mesh, batch)` applies it to every tensor
  or array of a batch (JAX's `P("data")`). Both raise if n does not divide.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_process_group(device_type: str, init_method: str, rank: int,
                       world_size: int) -> None:
    """Join the world of `world_size` ranks as `rank`, with NCCL on "cuda"
    (this rank's card: rank mod the cards present) or gloo on "cpu".
    `init_method` is a rendezvous URL, "file://<path>" or
    "tcp://localhost:<port>"."""
    if device_type not in BACKENDS:
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    backend = BACKENDS[device_type]
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device_type='cpu' to run on "
                               "the CPU with gloo")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL: the mesh on the card needs it")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    elif not dist.is_gloo_available():
        raise RuntimeError("this torch has no gloo: the mesh on the CPU needs it")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


class Mesh:
    """The world's ranks laid out row-major over `axis_names` with `shape`.

    `size(axis)`, `coordinate(axis)` and `group(axis)` give an axis's
    extent, this rank's place on it and the process group of this rank's
    line along it (the ranks that differ from this one on that axis only);
    `ranks(axis)` lists that line's global ranks.
    """

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 device_type: str):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.device_type = device_type
        self.rank = dist.get_rank()
        layout = np.arange(math.prod(shape)).reshape(tuple(shape))
        coords = np.unravel_index(self.rank, layout.shape)
        self._coord = dict(zip(self.axis_names, (int(c) for c in coords)))
        self._ranks, self._groups = {}, {}
        for i, axis in enumerate(self.axis_names):
            lines = np.moveaxis(layout, i, -1).reshape(-1, layout.shape[i])
            # every rank creates every group, in the same order, as
            # torch.distributed requires; each keeps the one it is on
            for line in lines:
                ranks = [int(r) for r in line]
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._ranks[axis], self._groups[axis] = ranks, group

    @property
    def device(self) -> torch.device:
        if self.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def coordinate(self, axis: str) -> int:
        return self._coord[axis]

    def group(self, axis: str):
        return self._groups[axis]

    def ranks(self, axis: str) -> list:
        return list(self._ranks[axis])

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, {self.device_type}, rank {self.rank} at "
                f"{self._coord})")


def make_mesh(axis_names: Sequence[str] = ("data",),
              shape: Sequence[int] | None = None,
              device_type: str = "cuda") -> Mesh:
    """A mesh over every rank of the initialised world. The default shape
    puts them all on the first axis ([world, 1, ...]). The world's backend
    must be the one `device_type` takes: NCCL for "cuda", gloo for "cpu"."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised; call "
                           "parallel.init_process_group first")
    want = BACKENDS.get(device_type)
    if want is None:
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    if dist.get_backend() != want:
        raise RuntimeError(f"a {device_type} mesh needs the {want} backend, the world "
                           f"runs {dist.get_backend()}")
    n = dist.get_world_size()
    if shape is None:
        shape = [n] + [1] * (len(axis_names) - 1)
    if len(shape) != len(axis_names) or math.prod(shape) != n:
        raise ValueError(f"mesh shape {tuple(shape)} over axes {tuple(axis_names)} does "
                         f"not hold the world's {n} ranks")
    return Mesh(axis_names, shape, device_type)


@torch.no_grad()
def replicated(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast `module`'s parameters and buffers from rank 0 to every
    rank of the world, in place; returns the module."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, 0)
    return module


def batch_sharding(mesh: Mesh, n: int, axis: str = "data") -> slice:
    """This rank's contiguous part of a batch of `n` along dim 0 over
    `axis`."""
    size = mesh.size(axis)
    if n % size:
        raise ValueError(f"batch of {n} does not divide over the {size} ranks "
                         f"of axis {axis!r}")
    per = n // size
    start = mesh.coordinate(axis) * per
    return slice(start, start + per)


def shard_batch(mesh: Mesh, batch, axis: str = "data"):
    """This rank's part of every tensor or array in `batch` (a tensor, an
    array, or a dict, list or tuple of them), along dim 0."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, axis) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v, axis) for v in batch)
    return batch[batch_sharding(mesh, batch.shape[0], axis)]
