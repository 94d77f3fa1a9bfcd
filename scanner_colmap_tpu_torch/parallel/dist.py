"""Multi-host execution: process-group init and host-level work
partitioning for the stages (port of ``parallel/dist.py``).

Every process runs the same program. Work units (frames, scheduled pairs,
key-image clusters, reference images) are assigned by rank; results meet
in the shared artifact store (each rank writes its own shard table, rank 0
merges), so the stage-table contract carries the cross-host traffic. The
tables and ready markers are the JAX package's: ``<stage>_shard_<pid>``,
``{name}_ready_{pid}`` and the same ``meta``.

With no process group configured this is one host owning all work, so the
same code serves one process, one card shared by several ranks (gloo) and
one card per rank (NCCL).
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Optional, Sequence, TypeVar

import numpy as np
import torch
import torch.distributed as dist

from scanner_colmap_tpu_torch import device as devlib
from scanner_colmap_tpu_torch.utils.store import ArtifactStore

log = logging.getLogger(__name__)

T = TypeVar("T")


def maybe_init_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None, device=None) -> bool:
    """Initialize the default process group when one is configured.

    With ``init_method`` None it reads torchrun's MASTER_ADDR / MASTER_PORT
    / WORLD_SIZE / RANK (``env://``); with neither it returns False. The
    backend is the caller's, else it follows ``device`` (None: the card):
    ``nccl`` for CUDA, ``gloo`` for the CPU; nothing retries on another.
    Under ``nccl`` each rank takes a card of its own (``_rank_card``) as
    the current device, which ``make_mesh(device=None)`` then uses.
    Returns True when a process group is active."""
    if dist.is_initialized():
        return True
    if init_method is None:
        if not (os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT")):
            return False
        init_method = "env://"
    world_size = world_size or int(os.environ.get("WORLD_SIZE", "1"))
    rank = rank if rank is not None else int(os.environ.get("RANK", "0"))
    backend = backend or ("nccl" if devlib.resolve(device).type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(_rank_card(rank, device))
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    log.info("torch.distributed: rank %d/%d via %s (%s)", rank, world_size,
             init_method, backend)
    return True


def _rank_card(rank: int, device=None) -> int:
    """The index of this rank's card under NCCL, which refuses two ranks
    on one card: ``device``'s index when it names one, else torchrun's
    LOCAL_RANK, else the rank."""
    if device is not None and torch.device(device).index is not None:
        return torch.device(device).index
    return int(os.environ.get("LOCAL_RANK", rank))


def process_info():
    """(process_id, num_processes): (0, 1) when not distributed."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def partition_round_robin(items: Sequence[T], process_id: Optional[int] = None,
                          num_processes: Optional[int] = None) -> List[T]:
    """This host's share of a work list (deterministic round-robin, so
    adjacent clusters land on different hosts and merge trees stay local)."""
    pid, n = process_info()
    if process_id is not None:
        pid = process_id
    if num_processes is not None:
        n = num_processes
    return [x for i, x in enumerate(items) if i % n == pid]


def barrier_via_store(store, name: str, timeout_s: float = 3600.0,
                      poll_s: float = 2.0):
    """Rendezvous through the artifact store: every host writes a ready
    marker table; all hosts wait until every marker exists (a shared
    filesystem is all it needs)."""
    pid, n = process_info()
    store.write_table(f"{name}_ready_{pid}", {"pid": np.asarray([pid])},
                      meta={"barrier": name})
    t0 = time.time()
    while True:
        if all(store.has_table(f"{name}_ready_{i}") for i in range(n)):
            return
        if time.time() - t0 > timeout_s:
            raise TimeoutError(f"barrier {name}: waited {timeout_s}s")
        time.sleep(poll_s)


def merge_shard_tables(store, shard_prefix: str, out_table: str,
                       sort_col: str, ragged_cols: Sequence[str] = (),
                       stacked_cols: Sequence[str] = (), meta=None):
    """Host-0 concatenation of per-host shard tables into the canonical
    stage table, ordered by an integer key column. ragged_cols stay lists
    of per-row arrays; stacked_cols become one (N, ...) array
    (empty-safe)."""
    _, n = process_info()
    keys = []
    cols = {c: [] for c in list(ragged_cols) + list(stacked_cols)}
    for i in range(n):
        t = store.read_table(f"{shard_prefix}_{i}")
        keys.extend(int(x) for x in t[sort_col])
        for c in cols:
            cols[c].extend(t[c])
    order = np.argsort(keys)
    out = {sort_col: np.asarray(keys, np.int64)[order]}
    for c in ragged_cols:
        out[c] = [cols[c][i] for i in order]
    for c in stacked_cols:
        out[c] = (np.stack([cols[c][i] for i in order]) if len(order)
                  else np.zeros((0,)))
    store.write_table(out_table, out, meta=dict(meta or {}, num_hosts=n))


def _agree_max(value: int, dev) -> int:
    """The largest of every rank's value (a sum of one-hot rows, which both
    backends run on any device)."""
    pid, n = process_info()
    if n == 1:
        return value
    row = torch.zeros(n, dtype=torch.int64, device=dev)
    row[pid] = value
    dist.all_reduce(row)
    return int(row.max())


def run_extraction_distributed(cfg, store=None, device=None):
    """Each host extracts its round-robin share of frames into
    `extraction_shard_<pid>`; host 0 concatenates the shards (ordered by
    image_id) into `extraction`."""
    from scanner_colmap_tpu_torch.pipeline import stages

    store = store or ArtifactStore(cfg.store_path)
    pid, n = process_info()
    stages.run_extraction(cfg, store, device=device, frame_slice=(pid, n),
                          out_table=f"extraction_shard_{pid}")
    barrier_via_store(store, "extraction_done")
    if pid == 0:
        merge_shard_tables(store, "extraction_shard", "extraction", "image_id",
                           ragged_cols=("keypoints", "descriptors"),
                           stacked_cols=("camera",), meta={"stage": "extraction"})
    barrier_via_store(store, "extraction_merged")
    return store.num_rows("extraction") if pid == 0 else None


def run_matching_distributed(cfg, store=None, device=None):
    """Each host matches its round-robin slice of the pair schedule and of
    the loop-closure candidates (the 10k-image partitioned matching
    configuration) into `matching_shard_<pid>`; host 0 concatenates the
    shards into `matching`, rows sorted by (id1, id2). The hosts verify at
    one correspondence width, so every row is the one a single host
    writes."""
    from scanner_colmap_tpu_torch.pipeline import stages

    store = store or ArtifactStore(cfg.store_path)
    dev = devlib.resolve(device)
    pid, n = process_info()
    stages.run_matching(cfg, store, device=dev, schedule_slice=(pid, n),
                        out_table=f"matching_shard_{pid}",
                        verify_width=lambda p: _agree_max(p, dev))
    barrier_via_store(store, "matching_done")
    if pid == 0:
        pairs, tvgs, matches = [], [], []
        for i in range(n):
            t = store.read_table(f"matching_shard_{i}")
            pairs.extend(np.asarray(t["pair_image_ids"]).reshape(-1, 2))
            tvgs.extend(np.asarray(r) for r in t["two_view_geometry"])
            matches.extend(np.asarray(r) for r in t["matches"])
        order = sorted(range(len(pairs)), key=lambda r: tuple(pairs[r]))
        store.write_table("matching", {
            "pair_image_ids": (np.stack([pairs[r] for r in order]) if order
                               else np.zeros((0, 2), np.int64)),
            "two_view_geometry": (np.stack([tvgs[r] for r in order]) if order
                                  else np.zeros((0, 37))),
            "matches": [matches[r] for r in order],
        }, meta={"stage": "matching", "num_hosts": n})
    barrier_via_store(store, "matching_merged")
    return store.num_rows("matching") if pid == 0 else None


def run_mapping_distributed(cfg, store=None, device=None):
    """Each host reconstructs its round-robin share of clusters with the
    host mapper (seed = cluster index, whatever ``mapper.mode`` says, and
    no weak-cluster retry, as the JAX function does) into
    `mapping_shard_<pid>`; host 0 concatenates the shards into `mapping`."""
    from scanner_colmap_tpu_torch.engine.cluster import make_clusters, subgraph
    from scanner_colmap_tpu_torch.engine.incremental import IncrementalMapper
    from scanner_colmap_tpu_torch.pipeline import stages
    from scanner_colmap_tpu_torch.utils import colmap_io

    store = store or ArtifactStore(cfg.store_path)
    dev = devlib.resolve(device)
    pid, n = process_info()
    _, kp, _, cameras = stages._load_extraction(store)
    graph, two_view = stages._build_graph(store, kp)
    clusters = make_clusters(sorted(kp.keys()), cfg.mapper.cluster_size,
                             cfg.mapper.cluster_overlap)
    mine = partition_round_robin(list(enumerate(clusters)))

    rows = {"cluster_id": [], "cameras": [], "images": [], "points3d": []}
    for ci, members in mine:
        g, tv = subgraph(graph, two_view, members)
        rec = IncrementalMapper({i: kp[i] for i in members},
                                {i: cameras[i] for i in members}, g, tv,
                                cfg.mapper, seed=ci, device=dev).reconstruct()
        if rec.num_registered >= 2:
            cb, ib, pb = colmap_io.model_to_bytes(rec)
            rows["cluster_id"].append(ci)
            rows["cameras"].append(cb)
            rows["images"].append(ib)
            rows["points3d"].append(pb)
        log.info("host %d/%d: cluster %d -> %d images", pid, n, ci, rec.num_registered)
    store.write_table(f"mapping_shard_{pid}", {
        "cluster_id": np.asarray(rows["cluster_id"], np.int64),
        "cameras": rows["cameras"], "images": rows["images"],
        "points3d": rows["points3d"],
    }, meta={"stage": "mapping", "host": pid})
    barrier_via_store(store, "mapping_done")
    if pid == 0:
        merge_shard_tables(store, "mapping_shard", "mapping", "cluster_id",
                           ragged_cols=("cameras", "images", "points3d"),
                           meta={"stage": "mapping"})
    barrier_via_store(store, "mapping_merged")
    return len(mine)


def run_patch_match_distributed(cfg, store=None, device=None):
    """Each host computes a contiguous block of reference images
    (``run_patch_match(ref_slice=...)``, halo-extended for the geometric
    pass) into `patch_match_shard_<pid>`; host 0 concatenates the shards."""
    from scanner_colmap_tpu_torch.pipeline import stages

    store = store or ArtifactStore(cfg.store_path)
    pid, n = process_info()
    stages.run_patch_match(cfg, store, ref_slice=(pid, n),
                           out_table=f"patch_match_shard_{pid}", device=device)
    barrier_via_store(store, "patch_match_done")
    if pid == 0:
        merge_shard_tables(store, "patch_match_shard", "patch_match", "image_id",
                           ragged_cols=("depth_map", "normal_map", "cost_map"),
                           meta={"stage": "patch_match"})
    barrier_via_store(store, "patch_match_merged")
    return store.num_rows("patch_match") if pid == 0 else None


def run_merge_distributed(cfg, store=None, device=None):
    """Host 0 merges the concatenated `mapping` table (tree merge and
    full-graph refinement); the other hosts wait on the store barrier, so
    every process leaves with the model."""
    from scanner_colmap_tpu_torch.pipeline import stages

    store = store or ArtifactStore(cfg.store_path)
    pid, _ = process_info()
    model = stages.run_merge(cfg, store, device=device) if pid == 0 else None
    barrier_via_store(store, "merge_done")
    return model if model is not None else stages.load_model(store)
