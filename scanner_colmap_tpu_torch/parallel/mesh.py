"""The rank mesh and row sharding (port of ``parallel/mesh.py``).

A ``Mesh`` is one ``torch.distributed`` process group seen from one rank:
its rank, its size and the device its tensors live on. Several ranks may
share a card (gloo). Rows shard in the JAX ``P(axis)`` layout: contiguous
blocks in rank order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from scanner_colmap_tpu_torch import device as devlib

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``group`` None is a world of one outside ``torch.distributed``:
    every collective is the identity."""
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device


def make_mesh(group: Optional[dist.ProcessGroup] = None, device=None) -> Mesh:
    """The mesh of ``group`` (default: the initialized world; a world of
    one when ``torch.distributed`` is not initialized). ``device=None``
    means the card."""
    dev = devlib.resolve(device)
    if not dist.is_initialized():
        if group is not None:
            raise ValueError("a process group was given, but torch.distributed "
                             "is not initialized")
        return Mesh(None, 0, 1, dev)
    group = group or dist.group.WORLD
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), dev)


def shard_bounds(mesh: Mesh, n: int) -> tuple:
    """[start, stop) of this rank's block of n rows; n must divide by the
    mesh size."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide over {mesh.size} ranks; pad "
                         "with pad_to_shards")
    k = n // mesh.size
    return mesh.rank * k, (mesh.rank + 1) * k


def shard_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous block of axis 0 of x."""
    s, e = shard_bounds(mesh, x.shape[0])
    return x[s:e]


def pad_to_shards(x: np.ndarray, num_shards: int, axis: int = 0):
    """Pad axis to a multiple of num_shards. Returns (padded, orig_len)."""
    n = x.shape[axis]
    target = ((n + num_shards - 1) // num_shards) * num_shards
    if target == n:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - n)
    return np.pad(x, pad), n
