"""Point-sharded Schur-complement bundle adjustment (port of
``parallel/dist_ba.py``).

Landmarks (points and their observations) shard over the ranks; camera
parameters are small and replicated. Each LM trial:

  1. every rank evaluates residuals and Jacobians for its points and
     builds its points' Schur term with kernel 2
  2. the camera system's point sums (U, g_c, S_pt, rhs_pt; for CG the
     build pass's sums and each matvec's (M, 8) term) are summed over the
     ranks with ``all_reduce``
  3. every rank solves the same camera system
  4. point back-substitution is local

``ops/ba.bundle_adjust(group=...)`` does all four; this module shards the
problem and assembles the result.
"""

from __future__ import annotations

import dataclasses

import torch

from scanner_colmap_tpu_torch.ops import ba
from scanner_colmap_tpu_torch.parallel.mesh import Mesh, shard_bounds


def _shard_problem(mesh: Mesh, params: ba.BundleParams, obs: ba.BundleObs,
                  cfg: ba.BundleConfig):
    """This rank's share of a whole problem, on the mesh's device: its block
    of points (xyz, the observations, pt_valid), every camera."""
    s, e = shard_bounds(mesh, params.xyz.shape[0])

    def take(obj, sharded):
        return {f.name: (None if v is None else (v[s:e] if f.name in sharded else v)
                         .to(mesh.device))
                for f in dataclasses.fields(obj) for v in (getattr(obj, f.name),)}

    return (ba.BundleParams(**take(params, ("xyz",))),
            ba.BundleObs(**take(obs, ("cam_idx", "uv", "valid"))),
            ba.BundleConfig(**take(cfg, ("pt_valid",))))


def _gather_points(mesh: Mesh, xyz_local: torch.Tensor, n_points: int) -> torch.Tensor:
    """The whole (n_points, 3) on every rank: one all_reduce of zero-filled
    blocks (a sum with zeros is exact; gloo has no all_gather for CUDA
    tensors)."""
    if mesh.group is None:
        return xyz_local
    s, e = shard_bounds(mesh, n_points)
    full = xyz_local.new_zeros((n_points,) + tuple(xyz_local.shape[1:]))
    full[s:e] = xyz_local
    torch.distributed.all_reduce(full, group=mesh.group)
    return full


def distributed_bundle_adjust(mesh: Mesh, params: ba.BundleParams, obs: ba.BundleObs,
                              cfg: ba.BundleConfig, max_iterations: int = 25,
                              solver: str = "dense", cg_iters: int = 64, **kw):
    """``bundle_adjust`` with the points sharded over the mesh's ranks.

    Every rank passes the whole problem; xyz, the observations and
    pt_valid shard on axis 0, everything else is replicated. P must divide
    by the mesh size (pad with invalid points: ``pad_to_shards``). Every
    rank returns the same cameras and info and the whole xyz."""
    P = params.xyz.shape[0]
    p, o, c = _shard_problem(mesh, params, obs, cfg)
    out, info = ba.bundle_adjust(p, o, c, max_iterations=max_iterations, solver=solver,
                                 cg_iters=cg_iters, group=mesh.group, **kw)
    return dataclasses.replace(out, xyz=_gather_points(mesh, out.xyz, P)), info
