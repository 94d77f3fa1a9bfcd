"""Halo exchange over the ordered-image axis (port of ``parallel/halo.py``).

Row i's stencil reads rows [i, i + overlap) of the ordered axis. When the
axis is sharded over ranks, a window near a block's end needs the first
``halo`` rows of the next rank's block: a ring exchange. It runs as one
``all_reduce`` sum of a zero-filled (world, halo, ...) byte buffer into
which each rank writes its head: a sum with zeros gives every rank every
head bit for bit, on gloo and NCCL alike, with no send/recv (which gloo
lacks for CUDA tensors).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from scanner_colmap_tpu_torch.parallel.mesh import Mesh, shard_rows


def _gather_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(world,) + x.shape: every rank's x, through its bytes."""
    raw = x.contiguous().reshape(x.shape + (1,)).view(torch.uint8)
    buf = torch.zeros((mesh.size,) + raw.shape, dtype=torch.uint8, device=raw.device)
    buf[mesh.rank] = raw
    if mesh.group is not None:
        dist.all_reduce(buf, group=mesh.group)
    return buf.view(x.dtype).reshape((mesh.size,) + x.shape)


def ring_halo_append(x: torch.Tensor, halo: int, mesh: Mesh) -> torch.Tensor:
    """Append the next rank's first ``halo`` rows to this rank's rows.

    x: (n_local, ...) this rank's block of the ordered axis. Returns
    (n_local + halo, ...). The last rank receives rank 0's rows (ring);
    callers mask them by global index. Every rank must call it."""
    if halo > x.shape[0]:
        raise ValueError(
            f"halo {halo} exceeds local shard rows {x.shape[0]}; use fewer "
            f"shards or a smaller window")
    heads = _gather_all(x[:halo], mesh)
    return torch.cat([x, heads[(mesh.rank + 1) % mesh.size]], dim=0)


def windowed_gather(mesh: Mesh, x: torch.Tensor, halo: int) -> torch.Tensor:
    """x (N, ...) whole on every rank -> (world, n_local + halo, ...): each
    rank's block with its halo appended, assembled on every rank, as the
    JAX function returns it."""
    mine = ring_halo_append(shard_rows(mesh, x), halo, mesh)
    return _gather_all(mine, mesh)
