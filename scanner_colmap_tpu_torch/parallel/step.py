"""The fused multi-rank SfM step: sharded windowed matching and sharded BA
(port of ``parallel/step.py``).

The recurring heavy iteration of a large reconstruction: match imagery
against its neighbourhood and re-solve the bundle. Sharding layout:

- the ordered-image axis shards over the ranks in contiguous blocks; the
  match window crosses a block's end through the ring halo
  (``halo.ring_halo_append``)
- BA landmarks shard over the same ranks; the camera system's sums are
  summed over them (``dist_ba``)
"""

from __future__ import annotations

import torch

from scanner_colmap_tpu_torch.ops import ba, matching
from scanner_colmap_tpu_torch.parallel.dist_ba import distributed_bundle_adjust
from scanner_colmap_tpu_torch.parallel.halo import ring_halo_append
from scanner_colmap_tpu_torch.parallel.mesh import Mesh, shard_rows


def make_distributed_step(mesh: Mesh, overlap: int, ba_iterations: int = 3):
    """The step for this rank of ``mesh``. Returned fn:

      fn(desc (N, K, 128), kp_valid (N, K), params, obs, cfg)
      -> (match_idx (n_local, overlap, K) int32, match_ok (n_local, overlap, K),
          params', info)

    Every rank passes the whole arrays; N images (N must divide by the mesh
    size) shard in blocks, points as in ``distributed_bundle_adjust``. Row
    i of the result matches this rank's i-th image against the next
    ``overlap`` images of the ordered axis: the block with its halo is one
    bank and its pairs (i, i+j) one ``matching.match_bank`` launch at bf16
    (kernel 1), row for row ``match_window`` on each pivot's window; rows
    whose window wraps past the last image are computed and left to the
    caller to mask, as in the JAX step. A tied config (``cfg.cam_group``)
    keeps its slots' intrinsics exactly equal."""

    def step(desc, kp_valid, params: ba.BundleParams, obs: ba.BundleObs,
             cfg: ba.BundleConfig):
        d = ring_halo_append(shard_rows(mesh, desc).to(mesh.device), overlap, mesh)
        v = ring_halo_append(shard_rows(mesh, kp_valid).to(mesh.device), overlap, mesh)
        n_local, K = d.shape[0] - overlap, d.shape[1]
        bank, vb = matching.window_bank(d, v)
        ai = torch.arange(n_local, dtype=torch.int32, device=bank.device)
        ai = ai.repeat_interleave(overlap)
        bi = ai + torch.arange(1, overlap + 1, dtype=torch.int32,
                               device=bank.device).repeat(n_local)
        idx = matching.match_bank(bank, vb, ai, bi)[:, :K]
        idx = idx.reshape(n_local, overlap, K).to(torch.int32)
        p_out, info = distributed_bundle_adjust(mesh, params, obs, cfg,
                                                max_iterations=ba_iterations)
        return idx, idx >= 0, p_out, info

    return step
