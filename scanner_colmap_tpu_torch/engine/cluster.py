"""Cluster scheduling for the mapping stage (port of ``engine/cluster.py``).

Images are ordered; each cluster covers ``cluster_size`` consecutive images
and shares ``cluster_overlap`` with its neighbour, and every cluster is
reconstructed independently: by the single-program device mapper
(``mapper.mode="device"``, the default) or by the host mapper's COLMAP
schedule (``"host"``, ``engine/incremental.py``). In device mode a cluster
the device mapper registers below ``device_fallback_min_frac`` of its
members is mapped again by the host mapper, which is kept when it
registers more images. The device mapper takes the clusters through
``map_clusters_device_batch``: with ``device_batch_clusters`` as lanes of
batched runs of up to ``device_batch_size`` clusters, otherwise one cluster
a run; the host retry then goes over their results in cluster order.
``run_clustered_mapping`` then merges the submodels (``engine/merge``),
unless asked not to, as the JAX function does.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np

from scanner_colmap_tpu_torch import device as devlib
from scanner_colmap_tpu_torch.engine.correspondence import make_graph
from scanner_colmap_tpu_torch.engine import device_cluster as dc
from scanner_colmap_tpu_torch.engine.incremental import IncrementalMapper
from scanner_colmap_tpu_torch.engine.merge import merge_all
from scanner_colmap_tpu_torch.models.reconstruction import Reconstruction
from scanner_colmap_tpu_torch.utils import flops
from scanner_colmap_tpu_torch.utils.config import MapperConfig, MergeConfig
from scanner_colmap_tpu_torch.utils.metrics import span

log = logging.getLogger(__name__)

# the most recent run_clustered_mapping's stats (its docstring lists the
# keys); the mapping stage writes them into its manifest's device_stats
LAST_MAPPING_STATS: dict = {}


def make_clusters(image_ids: Sequence[int], cluster_size: int,
                  cluster_overlap: int) -> List[List[int]]:
    """Overlapping windows over the ordered image list; a 1-image tail
    folds into the last cluster."""
    if cluster_overlap >= cluster_size:
        raise ValueError("cluster_overlap must be < cluster_size")
    ids = list(image_ids)
    step = cluster_size - cluster_overlap
    if len(ids) <= cluster_size:
        return [ids]
    clusters: List[List[int]] = []
    start = 0
    while start < len(ids):
        c = ids[start:start + cluster_size]
        if len(c) >= 2:
            clusters.append(c)
        elif clusters:
            clusters[-1] = clusters[-1] + c
        if start + cluster_size >= len(ids):
            break
        start += step
    return clusters


def subgraph(graph, two_view: Dict, members: Sequence[int]):
    """Restrict the correspondence graph and two-view table to a cluster,
    carrying the per-pair match lists for track building."""
    mset = set(members)
    g = make_graph()
    for i in members:
        g.add_image(i, graph.num_keypoints(i))
    sub_pm = {}
    for (i, j), pairs in graph.pair_matches.items():
        if i in mset and j in mset and len(pairs):
            g.add_matches(i, j, pairs)
            sub_pm[(i, j)] = pairs
    g.pair_matches = sub_pm
    tv = {k: v for k, v in two_view.items() if k[0] in mset and k[1] in mset}
    return g, tv


def run_clustered_mapping(keypoints: Dict[int, np.ndarray], cameras: Dict,
                          graph, two_view: Dict,
                          config: Optional[MapperConfig] = None,
                          merge_config: Optional[MergeConfig] = None,
                          merge: bool = True, *, device=None):
    """Cluster, reconstruct each cluster on `device`, then (with ``merge``)
    merge the submodels.

    Returns (the merged model, or None with ``merge=False``; the clusters'
    reconstructions with >= 2 registered images), as the JAX function does.
    The run's stats go to ``LAST_MAPPING_STATS``: the mode and, in device
    mode, whether the clusters ran as lanes (``batched``;
    ``chunks``, the lanes of each batched run), the device mapper's
    scheduled work (``scheduled_tflop``, ``utils/flops.device_mapper_flops``
    over every cluster it took), each cluster's registered count before any
    retry (``registered``), the clusters retried on the host mapper
    (``host_retried``) and those whose retry registered more images and
    replaced the device result (``host_retry_won``)."""
    cfg = config or MapperConfig()
    device = devlib.resolve(device)
    if cfg.mode not in ("device", "host"):
        raise ValueError(f"mapper.mode must be 'device' or 'host', got {cfg.mode!r}")
    ids = sorted(keypoints.keys())
    clusters = make_clusters(ids, cfg.cluster_size, cfg.cluster_overlap)

    def inputs(ci):
        members = clusters[ci]
        g, tv = subgraph(graph, two_view, members)
        return ({i: keypoints[i] for i in members}, {i: cameras[i] for i in members},
                g, tv)

    def host_map(ci) -> Reconstruction:
        return IncrementalMapper(*inputs(ci), cfg, seed=ci, device=device).reconstruct()

    stats = {"mode": cfg.mode, "n_clusters": len(clusters)}
    if cfg.mode == "host":
        # clusters are independent; their host control loops overlap in
        # threads (numpy and the device calls release the GIL), and the
        # results are keyed by cluster index
        workers = min(cfg.cluster_workers, len(clusters)) or 1
        if workers > 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                recs = list(pool.map(host_map, range(len(clusters))))
        else:
            recs = [host_map(ci) for ci in range(len(clusters))]
    else:
        dc.SHAPE_LOG.clear()
        dc.CHUNK_LOG.clear()
        batched = bool(cfg.device_batch_clusters) and len(clusters) > 1
        recs = dc.map_clusters_device_batch(
            [inputs(ci) + (ci,) for ci in range(len(clusters))], cfg, device=device,
            batch_size=cfg.device_batch_size if batched else 1)
        sched = sum(flops.device_mapper_flops(
            M, P, T, n, cfg.device_ba_iters_per_step, cfg.device_final_ba_iters,
            cfg.device_pnp_trials) for (M, P, T, n) in dc.SHAPE_LOG)
        stats.update(batched=batched, chunks=list(dc.CHUNK_LOG),
                     scheduled_tflop=sched / 1e12,
                     registered=[r.num_registered for r in recs])
        retried, won = [], []
        for ci, rec in enumerate(recs):
            members = clusters[ci]
            if len(members) < 3 or rec.num_registered >= cfg.device_fallback_min_frac * len(members):
                continue
            retried.append(ci)
            with span("mapping.host_retry"):
                host_rec = host_map(ci)
            log.warning("cluster %d/%d: device mapper registered %d/%d, host retry %d%s",
                        ci + 1, len(clusters), rec.num_registered, len(members),
                        host_rec.num_registered,
                        " (kept)" if host_rec.num_registered > rec.num_registered else "")
            if host_rec.num_registered > rec.num_registered:
                recs[ci] = host_rec
                won.append(ci)
        stats.update(host_retried=retried, host_retry_won=won)
    for ci, rec in enumerate(recs):
        log.info("cluster %d/%d (%s): %d/%d images, %d points", ci + 1, len(clusters),
                 cfg.mode, rec.num_registered, len(clusters[ci]), len(rec.points3D))
    LAST_MAPPING_STATS.clear()
    LAST_MAPPING_STATS.update(stats)
    submodels: List[Reconstruction] = [r for r in recs if r.num_registered >= 2]
    if not merge:
        return None, submodels
    model = merge_all(submodels, merge_config) if submodels else Reconstruction()
    return model, submodels
