"""Host side of the single-program cluster mapper (port of
``engine/device_cluster.py``).

Prepares the data-independent parts of one cluster's reconstruction on the
host — track structure, registration schedule, packed observation tensors
— then runs the whole incremental solve through ``ops/device_mapper`` and
unpacks the result into a Reconstruction.

Track structure: connected components of the verified-match graph (scipy
union-find); over-merges from wrong matches are demoted by the mapper's
per-step reprojection gates. Registration schedule: the initial pair by the
host engine's rule (most inliers with a triangulation-angle gate), then
COLMAP's visible-points ranking unrolled against the track structure
(``mapper.device_schedule="visible_points"``, the default) or the greedy
pair-inlier connectivity order (``"connectivity"``).

``map_clusters_device_batch`` solves many clusters as lanes of one batched
mapper run (``ops/device_mapper.map_cluster_batch``), grouped by shape.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from scanner_colmap_tpu_torch import device as devlib
from scanner_colmap_tpu_torch.engine.bundle_io import next_pow2
from scanner_colmap_tpu_torch.interop import CLUSTER_ARRAYS, cluster_inputs_from_numpy
from scanner_colmap_tpu_torch.models import cameras as camlib
from scanner_colmap_tpu_torch.models import geometry as geom
from scanner_colmap_tpu_torch.models.reconstruction import (Camera, Image,
                                                            Reconstruction)
from scanner_colmap_tpu_torch.ops import device_mapper
from scanner_colmap_tpu_torch.utils.config import MapperConfig
from scanner_colmap_tpu_torch.utils.metrics import count, span

log = logging.getLogger(__name__)

# (M, P, T, n_images) of every cluster handed to the mapper, appended per
# cluster; cleared and read by run_clustered_mapping, where
# utils/flops.device_mapper_flops turns it into scheduled FLOPs
SHAPE_LOG: List[tuple] = []
# lanes of every batched mapper run (map_clusters_device_batch), in order;
# cleared and read by run_clustered_mapping
CHUNK_LOG: List[int] = []
# a cluster's track capacity per keypoint of its fullest image: at
# PipelineConfig()'s 2048 features an image, 4 x 2048 is
# mapper.device_max_points' 8192, the JAX package's default
TRACKS_PER_FEATURE = 4


def track_capacity(cfg: MapperConfig, features: int) -> int:
    """Tracks a cluster's mapper holds when its fullest image has
    ``features`` keypoints (at most ``sift.max_num_features``):
    ``mapper.device_max_points``, or ``TRACKS_PER_FEATURE`` a keypoint
    where that is more."""
    return max(cfg.device_max_points, TRACKS_PER_FEATURE * features)


def _pair_matches(graph, i: int, j: int) -> np.ndarray:
    """(K, 2) verified matches (kp_i, kp_j) from the graph's per-pair lists
    (``graph.pair_matches``, keyed by (lo, hi))."""
    lo, hi = min(i, j), max(i, j)
    m = np.asarray(graph.pair_matches.get((lo, hi), np.zeros((0, 2), np.int64)))
    return m if i == lo else m[:, ::-1]


def build_tracks_packed(members: Sequence[int], kp: Dict[int, np.ndarray],
                        graph, max_track: int):
    """Tracks = connected components of the match graph over `members`.

    Returns (tr_img, tr_kp, tr_len): int32 arrays of shape (num_tracks,
    max_track) / (num_tracks,). Row p holds track p's observations —
    tr_img local image index, tr_kp keypoint index, -1 beyond tr_len[p].
    At most one observation per image (first match wins, like the host
    engine's first-come keypoint assignment); tracks longer than max_track
    are even-spread subsampled keeping both ends.
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = len(members)
    empty = (np.zeros((0, max_track), np.int32),
             np.zeros((0, max_track), np.int32), np.zeros(0, np.int32))
    counts = [len(kp[m]) for m in members]
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    total = int(offs[-1])
    if total == 0:
        return empty

    rows, cols = [], []
    for a in range(n):
        for b in range(a + 1, n):
            i, j = members[a], members[b]
            if graph.num_pair_inliers(i, j) <= 0:
                continue
            m = _pair_matches(graph, i, j)
            if len(m) == 0:
                continue
            rows.append(offs[a] + m[:, 0])
            cols.append(offs[b] + m[:, 1])
    if not rows:
        return empty
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    adj = coo_matrix((np.ones(len(r), np.int8), (r, c)), shape=(total, total))
    n_comp, labels = connected_components(adj, directed=False)

    # nodes that participate in at least one match
    touched = np.zeros(total, bool)
    touched[r] = True
    touched[c] = True
    node_img = (np.searchsorted(offs, np.arange(total), side="right") - 1
                ).astype(np.int64)
    node_kp = np.arange(total) - offs[node_img]

    idx = np.flatnonzero(touched)
    order = idx[np.argsort(labels[idx], kind="stable")]

    # first observation per (component, image), in member order: one global
    # unique on the composite key replaces a per-group np.unique
    composite = labels[order] * np.int64(n) + node_img[order]
    _, first = np.unique(composite, return_index=True)
    keep = np.sort(first)
    nodes = order[keep]
    labs = labels[order][keep]

    # group extents over the deduped, label-sorted node list
    starts = np.flatnonzero(np.r_[True, np.diff(labs) != 0])
    lens = np.diff(np.r_[starts, len(labs)])
    ok = lens >= 2
    starts, lens = starts[ok], lens[ok]
    P = len(starts)
    if P == 0:
        return empty

    # slot position of every kept node within its (kept) group
    Lmax = int(lens.max())
    if Lmax <= max_track:
        grp = np.repeat(np.arange(P), lens)
        pos = np.arange(lens.sum()) - np.repeat(
            np.cumsum(lens) - lens, lens)
        src = np.repeat(starts, lens) + pos
    else:
        # even spread across the span keeping BOTH ends for long tracks —
        # truncating to the first max_track images starves the span's tail
        # (a track spanning the whole cluster would never be visible to the
        # last images, killing init pairs there)
        out_len = np.minimum(lens, max_track)
        grp = np.repeat(np.arange(P), out_len)
        pos = np.arange(out_len.sum()) - np.repeat(
            np.cumsum(out_len) - out_len, out_len)
        span = np.repeat(lens - 1, out_len).astype(np.float64)
        denom = np.maximum(np.repeat(out_len, out_len) - 1, 1)
        src = np.repeat(starts, out_len) + np.round(
            pos * span / denom).astype(np.int64)
        lens = out_len
    T = min(Lmax, max_track)
    tr_img = np.full((P, T), -1, np.int32)
    tr_kp = np.full((P, T), -1, np.int32)
    tr_img[grp, pos] = node_img[nodes[src]]
    tr_kp[grp, pos] = node_kp[nodes[src]]
    return tr_img, tr_kp, lens.astype(np.int32)


def _find_initial_pair(members, graph, two_view, cfg: MapperConfig):
    """Same rule as the host engine (engine/incremental.py find_initial_pair)."""
    mset = set(members)
    min_ang = math.radians(cfg.init_min_tri_angle_deg)
    best = None
    for (i, j), tv in two_view.items():
        if i not in mset or j not in mset:
            continue
        if tv["num_inliers"] < cfg.init_min_num_inliers:
            continue
        if tv["tri_angle"] < min_ang:
            continue
        if best is None or tv["num_inliers"] > best[0]:
            best = (tv["num_inliers"], i, j)
    if best is None:
        return None
    return best[1], best[2]


def _registration_order_tracks(n: int, tr_img: np.ndarray, la: int, lb: int
                               ) -> List[int]:
    """COLMAP-style visible-points registration order, statically unrolled.

    The host engine ranks the next image by its count of VISIBLE
    triangulated points (incremental.py find_next_images, replicating
    reference incremental_mapping.cc:323-328 FindNextImages). The device
    schedule must be fixed before the solve runs, so we unroll the same
    ranking against a proxy: a track counts as "triangulated" once >= 2 of
    its observations are registered, and image x's score is the number of
    such tracks observing x, updated greedily after each registration: it
    prefers images whose 2D-3D support exists at registration time, which
    is what PnP quality depends on.
    """
    num_tracks, _ = tr_img.shape
    memb = np.zeros((num_tracks, n), bool)
    valid = tr_img >= 0
    rows = np.repeat(np.arange(num_tracks), tr_img.shape[1])[valid.reshape(-1)]
    memb[rows, tr_img.reshape(-1)[valid.reshape(-1)]] = True
    membf = memb.astype(np.float64)

    reg = np.zeros(n, bool)
    reg[la] = reg[lb] = True
    reg_count = memb[:, la].astype(np.int32) + memb[:, lb].astype(np.int32)
    out: List[int] = []
    for _ in range(n - 2):
        vis = reg_count >= 2
        score = np.where(reg, -1.0, vis @ membf)
        nxt = int(np.argmax(score))
        if score[nxt] <= 0:
            # disconnected leftovers still get a PnP attempt, in member order
            out.extend(x for x in range(n) if not reg[x] and x not in out)
            break
        out.append(nxt)
        reg[nxt] = True
        reg_count += memb[:, nxt]
    return out


def _registration_order(members, graph, a: int, b: int) -> List[int]:
    """Greedy connectivity order of LOCAL indices, starting after (a, b):
    repeatedly the unregistered image with the most verified inliers to the
    registered set."""
    n = len(members)
    W = np.zeros((n, n))
    for x in range(n):
        for y in range(x + 1, n):
            w = graph.num_pair_inliers(members[x], members[y])
            W[x, y] = W[y, x] = w
    reg = np.zeros(n, bool)
    la, lb = members.index(a), members.index(b)
    reg[la] = reg[lb] = True
    score = W[:, la] + W[:, lb]
    out = []
    for _ in range(n - 2):
        score_m = np.where(reg, -1.0, score)
        nxt = int(np.argmax(score_m))
        if score_m[nxt] <= 0:
            # disconnected leftovers still get a PnP attempt, in member order
            out.extend(x for x in range(n) if not reg[x] and x not in out)
            break
        out.append(nxt)
        reg[nxt] = True
        score = score + W[:, nxt]
    return out


def _prepare_cluster(keypoints: Dict[int, np.ndarray], cameras: Dict,
                     graph, two_view: Dict, cfg: MapperConfig):
    """Pack one cluster's device-mapper inputs (host-side, data-independent).

    Returns None when the cluster cannot seed a reconstruction (no valid
    initial pair / too few tracks), else a dict of the kernel's input arrays
    plus the unpacking metadata (members, tracks, share, M, P, T). Past
    ``track_capacity`` of the fullest member's keypoints, the shortest
    tracks are dropped; ``mapping.tracks_dropped`` counts them (0 where
    none is).
    """
    members = sorted(keypoints.keys())
    n = len(members)

    init = _find_initial_pair(members, graph, two_view, cfg)
    if init is None or n < 2:
        log.warning("device mapper: no valid initial pair")
        return None

    a, b = init
    # effective track slots: the cluster span when it fits under the cap —
    # a track can observe each member at most once, so T = n loses nothing
    max_track = min(n, cfg.device_max_track)
    tr_img, tr_kp, tr_len = build_tracks_packed(members, keypoints, graph,
                                                max_track)
    if len(tr_len) < 8:
        return None
    cap = track_capacity(cfg, max(len(keypoints[m]) for m in members))
    count("mapping.tracks_dropped", max(len(tr_len) - cap, 0))
    if len(tr_len) > cap:
        # keep the longest (most-constrained) tracks
        top = np.argsort(-tr_len, kind="stable")[:cap]
        log.info("device mapper: dropped %d shortest tracks (cap %d)",
                 len(tr_len) - cap, cap)
        tr_img, tr_kp, tr_len = tr_img[top], tr_kp[top], tr_len[top]
    num_tracks = len(tr_len)

    M = next_pow2(n, 8)
    P = next_pow2(num_tracks, 512)
    T = tr_img.shape[1]
    S = 2 * M

    # --- cameras ---------------------------------------------------------
    infos = [cameras[m] for m in members]
    share = (cfg.single_camera and all(
        (i[0], i[2], i[3]) == (infos[0][0], infos[0][2], infos[0][3])
        for i in infos))
    # shared cameras tie intrinsic columns to slot 0 inside every BA solve
    # (exact equality, ba.BundleConfig.cam_group); otherwise 22-col layout
    cam_in = np.zeros((M, 23 if share else 22), np.float32)
    cam_in[:, 0] = 1.0
    if share:
        cam_in[n:, 22] = np.arange(n, M)  # padded slots tie to themselves
    focal = np.ones(n)
    for s, m in enumerate(members):
        model_id, params, w, h, prior = cameras[m]
        params = np.asarray(params, np.float64)
        if model_id == camlib.PINHOLE:
            f = 0.5 * (params[0] + params[1])
            cam_in[s, 9:11] = params[2:4]
        else:
            f = params[0]
            cam_in[s, 9:11] = params[1:3]
            if model_id != camlib.SIMPLE_PINHOLE and len(params) > 3:
                cam_in[s, 8] = params[3]
        focal[s] = f
        cam_in[s, 7] = np.log(max(f, 1e-6))
        cam_in[s, 11] = 1.0
        cam_in[s, 12:18] = 1.0
        cam_in[s, 18] = cam_in[s, 7]
        g = n if share else 1
        cam_in[s, 20] = cfg.intr_prior_weight_f / g
        cam_in[s, 21] = cfg.intr_prior_weight_k / g

    # init pair poses + gauge (host engine: first frozen, second loses one
    # translation component)
    la, lb = members.index(a), members.index(b)
    lo, hi = min(a, b), max(a, b)
    tv = two_view[(lo, hi)]
    qrel, trel = np.asarray(tv["qvec"]), np.asarray(tv["tvec"])
    if a > b:
        qrel, trel = geom.np_pose_inverse(qrel, trel)
    cam_in[lb, 0:4] = qrel
    cam_in[lb, 4:7] = trel
    cam_in[la, 12:18] = 0.0
    cam_in[lb, 15] = 0.0

    # --- schedule ---------------------------------------------------------
    if cfg.device_schedule == "visible_points":
        rest = _registration_order_tracks(n, tr_img, la, lb)
    elif cfg.device_schedule == "connectivity":
        rest = _registration_order(members, graph, a, b)
    else:
        raise ValueError(
            f"mapper.device_schedule must be 'visible_points' or "
            f"'connectivity', got {cfg.device_schedule!r}")
    order = np.full(S, -1, np.int32)
    forced = np.zeros(S, np.float32)
    order[0] = lb
    forced[0] = 1.0
    order[1: 1 + len(rest)] = rest
    order[1 + len(rest): 1 + 2 * len(rest)] = rest    # retry pass
    reg_init = np.zeros(M, np.float32)
    reg_init[la] = 1.0

    # --- observations ------------------------------------------------------
    def _padded_params(params):
        p = np.zeros(8, np.float64)
        p[: len(params)] = np.asarray(params, np.float64)
        return p

    uv_list = [np.asarray(keypoints[m], np.float64)[:, :2] for m in members]
    xn_list = [camlib.np_image_to_cam(
        int(cameras[m][0]), _padded_params(cameras[m][1]), uv_list[s])
        for s, m in enumerate(members)]
    kp_offs = np.concatenate(
        [[0], np.cumsum([len(u) for u in uv_list])]).astype(np.int64)
    uv_all = np.concatenate(uv_list)
    xn_all = np.concatenate(xn_list)

    # one gather per tensor over the packed (num_tracks, T) track table
    present = tr_img >= 0
    li = np.where(present, tr_img, 0)
    flat = kp_offs[li] + np.where(present, tr_kp, 0)
    obs_cam = np.zeros((P, T), np.int32)
    obs_uv = np.zeros((P, T, 2), np.float32)
    obs_xn = np.zeros((P, T, 2), np.float32)
    obs_present = np.zeros((P, T), np.float32)
    tri_thr_n = np.full(P, 1e-6, np.float32)
    obs_cam[:num_tracks] = li
    obs_uv[:num_tracks] = np.where(present[..., None], uv_all[flat], 0.0)
    obs_xn[:num_tracks] = np.where(present[..., None], xn_all[flat], 0.0)
    obs_present[:num_tracks] = present
    mean_focal = (np.sum(np.where(present, focal[li], 0.0), axis=1)
                  / np.maximum(tr_len, 1))
    tri_thr_n[:num_tracks] = cfg.filter_max_reproj_error / mean_focal

    pnp_thr_n = np.full(M, 1e-6, np.float32)
    pnp_thr_n[:n] = cfg.abs_pose_max_error / focal
    scal = np.asarray([
        1.0, 1.0, cfg.filter_max_reproj_error,
        math.radians(cfg.min_tri_angle_deg),
        float(cfg.abs_pose_min_num_inliers),
        cfg.abs_pose_min_inlier_ratio,
        cfg.filter_max_reproj_error, 0.0], np.float32)
    return dict(cam_in=cam_in, order=order, forced=forced,
                reg_init=reg_init, obs_cam=obs_cam, obs_uv=obs_uv,
                obs_xn=obs_xn, obs_present=obs_present, pnp_thr_n=pnp_thr_n,
                tri_thr_n=tri_thr_n, scal=scal, members=members,
                tr_img=tr_img, tr_kp=tr_kp, tr_len=tr_len, share=share,
                M=M, P=P, T=T)


def map_cluster_device(keypoints: Dict[int, np.ndarray], cameras: Dict,
                       graph, two_view: Dict,
                       config: Optional[MapperConfig] = None,
                       seed: int = 0, device=None) -> Reconstruction:
    """Reconstruct one cluster with the single-program mapper on `device`:
    a batched run of one lane. Returns a Reconstruction (empty when no
    valid initial pair exists)."""
    return map_clusters_device_batch([(keypoints, cameras, graph, two_view, seed)],
                                     config, device=device)[0]


def map_clusters_device_batch(cluster_args: Sequence[tuple],
                              config: Optional[MapperConfig] = None,
                              device=None,
                              batch_size: Optional[int] = None) -> List[Reconstruction]:
    """Solve a collection's clusters as lanes of batched mapper runs.

    ``cluster_args``: one (keypoints, cameras, graph, two_view, seed) tuple
    per cluster. The clusters are grouped by shape (M, P, T, camera
    columns: ``_prepare_cluster`` rounds M and P up to powers of two), each
    group is cut, in input order, into chunks of at most ``batch_size``
    clusters (default ``cfg.device_batch_size``; 1 maps each cluster
    alone), and each chunk runs as one
    ``map_cluster_batch``. Returns one Reconstruction per input cluster, in
    input order (empty where the cluster cannot seed).

    The reference pads a chunk's cluster axis to a power of two by
    repeating its last cluster, to bound the shapes it compiles; eager
    torch compiles nothing, so a chunk here holds its clusters alone."""
    cfg = config or MapperConfig()
    device = devlib.resolve(device)
    cap = max(int(cfg.device_batch_size if batch_size is None else batch_size), 1)
    results: List[Optional[Reconstruction]] = [None] * len(cluster_args)
    groups: Dict[tuple, list] = {}
    for idx, (kp, cams, g, tv, seed) in enumerate(cluster_args):
        with span("mapping.prepare"):
            prep = _prepare_cluster(kp, cams, g, tv, cfg)
        if prep is None:
            results[idx] = _empty_rec(kp, cams, cfg)
            continue
        prep.update(_idx=idx, _kp=kp, _cams=cams, _seed=seed)
        key = (prep["M"], prep["P"], prep["T"], prep["cam_in"].shape[1])
        groups.setdefault(key, []).append(prep)

    for (M, P, T, _), grp in sorted(groups.items()):
        for s in range(0, len(grp), cap):
            chunk = grp[s: s + cap]
            for p in chunk:
                SHAPE_LOG.append((M, P, T, len(p["members"])))
            CHUNK_LOG.append(len(chunk))
            with span("mapping.cluster"):
                t = cluster_inputs_from_numpy(
                    {k: np.stack([p[k] for p in chunk]) for k in CLUSTER_ARRAYS}, device)
                out = device_mapper.map_cluster_batch(
                    [p["_seed"] for p in chunk], *(t[k] for k in CLUSTER_ARRAYS),
                    pnp_trials=cfg.device_pnp_trials, ba_iters=cfg.device_ba_iters_per_step,
                    final_iters=cfg.device_final_ba_iters).cpu().numpy()
                count("host_reads")
                for row, p in zip(out, chunk):
                    with span("mapping.unpack"):
                        results[p["_idx"]] = _unpack(row, p, p["_cams"], p["_kp"],
                                                     M, P, T, cfg)
    return results


def _empty_rec(keypoints, cameras, cfg) -> Reconstruction:
    rec = Reconstruction()
    _add_cams_images(rec, sorted(keypoints.keys()), cameras, keypoints,
                     cfg.single_camera)
    return rec


def _add_cams_images(rec, members, cameras, keypoints, single_camera):
    infos = [cameras[m] for m in members]
    share = (single_camera and len(infos) > 0 and all(
        (i[0], i[2], i[3]) == (infos[0][0], infos[0][2], infos[0][3])
        for i in infos))
    if share:
        model_id, params, w, h, prior = infos[0]
        rec.add_camera(Camera(-1, model_id, w, h,
                              np.array(params, np.float64), prior))
    for m in members:
        model_id, params, w, h, prior = cameras[m]
        cam_id = -1 if share else m
        if not share:
            rec.add_camera(Camera(m, model_id, w, h,
                                  np.array(params, np.float64), prior))
        kps = np.asarray(keypoints[m], np.float64)[:, :2]
        rec.add_image(Image(
            image_id=m, camera_id=cam_id, name=f"image_{m}",
            xys=kps.copy(),
            point3D_ids=np.full(len(kps), -1, np.int64)))
    return share


def _unpack(out: np.ndarray, prep, cameras, keypoints,
            M, P, T, cfg) -> Reconstruction:
    members, share = prep["members"], prep["share"]
    tr_img, tr_kp, tr_len = prep["tr_img"], prep["tr_kp"], prep["tr_len"]
    n = len(members)
    cam = out[: M * 9].reshape(M, 9).astype(np.float64)
    off = M * 9
    xyz = out[off: off + P * 3].reshape(P, 3).astype(np.float64)
    off += P * 3
    pt_valid = out[off: off + P] > 0.5
    off += P
    obs_ok = out[off: off + P * T].reshape(P, T) > 0.5
    off += P * T
    registered = out[off: off + M] > 0.5
    off += M
    stats = out[off:]

    rec = Reconstruction()
    _add_cams_images(rec, members, cameras, keypoints, cfg.single_camera)

    # intrinsics: group-average like the host path's bundle unpacking
    log_f = cam[:n, 7]
    k1 = cam[:n, 8]
    if share:
        reg_n = registered[:n]
        w = reg_n.astype(np.float64)
        denom = max(w.sum(), 1.0)
        log_f = np.full(n, float((log_f * w).sum() / denom))
        k1 = np.full(n, float((k1 * w).sum() / denom))
    for s, m in enumerate(members):
        if not registered[s]:
            continue
        im = rec.images[m]
        im.qvec = cam[s, 0:4] / max(np.linalg.norm(cam[s, 0:4]), 1e-12)
        im.tvec = cam[s, 4:7].copy()
        im.registered = True
        camera = rec.cameras[im.camera_id]
        f = float(np.exp(log_f[s]))
        if camera.model_id == camlib.SIMPLE_RADIAL:
            camera.params[0] = f
            camera.params[3] = float(k1[s])
        elif camera.model_id == camlib.SIMPLE_PINHOLE:
            camera.params[0] = f
        elif camera.model_id == camlib.PINHOLE:
            camera.params[0] = camera.params[1] = f
        else:
            camera.params[0] = f
            if len(camera.params) > 3:
                camera.params[3] = float(k1[s])

    n_pts = 0
    for p in np.flatnonzero(pt_valid[: len(tr_len)]):
        track = []
        for t in range(int(tr_len[p])):
            li, k = int(tr_img[p, t]), int(tr_kp[p, t])
            if obs_ok[p, t] and registered[li]:
                m = members[li]
                if rec.images[m].point3D_ids[k] < 0:
                    track.append((m, k))
        if len(track) >= 2:
            rec.add_point3D(xyz[p], track)
            n_pts += 1

    # images left with too little support deregister (host filter_images)
    for m in rec.registered_image_ids:
        if rec.images[m].num_points3D < 3 and rec.num_registered > 2:
            rec.deregister_image(m)

    rec.compute_reprojection_errors()
    log.info("device mapper: %d/%d images, %d points, mean err %.3f px "
             "(kernel stats: reg=%d pts=%d err=%.3f obs=%d)",
             rec.num_registered, n, len(rec.points3D),
             rec.mean_reprojection_error(), int(stats[0]), int(stats[1]),
             float(stats[2]), int(stats[3]))
    return rec
