"""Incremental Structure-from-Motion: COLMAP's ``IncrementalMapper`` control
loop (port of ``engine/incremental.py``).

``IncrementalMapper`` holds one reconstruction over a correspondence graph:
initial-pair selection and registration, next-image ranking, PnP
registration, triangulation, local refinement over the most connected
images, growth-triggered global refinement (retriangulate, global BA,
complete and merge tracks, filter) and a final global pass
(``reconstruct``, the host mapper of ``mapper.mode="host"`` and of the
device mode's weak-cluster retry). ``engine/merge.iterative_global_refinement``
drives its global refinement over a merged model.

The control loop is host numpy, as in the reference; PnP, triangulation
and the bundle adjustment (kernel 2 on the dense path, the matrix-free CG
path past ``ba_dense_max_images``) run on the mapper's ``device``. PnP
draws come from a ``torch.Generator`` keyed per (cluster seed, image id,
attempt), so they cannot equal the reference's ``jax.random`` draws.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from scanner_colmap_tpu_torch import device as devlib
from scanner_colmap_tpu_torch.engine.bundle_io import pack_bundle_flat, unpack_bundle
from scanner_colmap_tpu_torch.models import cameras as camlib
from scanner_colmap_tpu_torch.models import geometry as geom
from scanner_colmap_tpu_torch.models.reconstruction import (Camera, Image,
                                                            Reconstruction,
                                                            np_reproj_errors)
from scanner_colmap_tpu_torch.ops import ba, pnp, triangulate
from scanner_colmap_tpu_torch.ops.two_view import eigh_calls
from scanner_colmap_tpu_torch.utils.config import MapperConfig
from scanner_colmap_tpu_torch.utils.metrics import count, span

log = logging.getLogger(__name__)


def pnp_generator(device, seed: int, image_id: int, attempt: int) -> torch.Generator:
    """PnP draws keyed by (cluster seed, image id, registration attempt):
    the same draws whatever order the mapper tries its images in."""
    gen = torch.Generator(device=device)
    gen.manual_seed(((int(seed) & 0xFFFFF) << 44) | ((int(image_id) & 0xFFFFFFFF) << 12)
                    | 0x800 | (int(attempt) & 0x7FF))
    return gen


class IncrementalMapper:
    """One reconstruction over a correspondence graph.

    Inputs (host numpy):
      keypoints: {image_id: (K_i, 2+) pixel coords}
      cameras:   {image_id: (model_id, params, width, height, prior_focal)}
      graph:     correspondence graph of verified matches (the native one
                 when built, with its fast scans)
      two_view:  {(id1, id2): dict(qvec, tvec, tri_angle, num_inliers)}
                 with id1 < id2, pose maps cam(id1) -> cam(id2)
    """

    def __init__(self, keypoints, cameras, graph, two_view,
                 config: Optional[MapperConfig] = None, seed: int = 0, device=None):
        self.kp = {i: np.asarray(k, np.float64)[:, :2] for i, k in keypoints.items()}
        self.cam_info = cameras
        self.graph = graph
        self.two_view = two_view
        self.cfg = config or MapperConfig()
        self.device = devlib.resolve(device)
        self.rec = Reconstruction()
        self.seed = int(seed)
        self.num_reg_trials: Dict[int, int] = {}
        self._kp_norm_cache: Dict[int, np.ndarray] = {}
        if getattr(graph, "has_fast_scans", False):
            # mirror point assignments into the native graph's index
            self.rec.observer = graph.set_point
        self._num_total_reg_images = 0
        # growth trackers of the global-BA trigger
        self._ba_prev_num_reg = 0
        self._ba_prev_num_points = 0
        self._init_log_f: Dict[int, float] = {}
        # shared camera: every image references ONE camera (id -1) when
        # enabled and all images agree on model and size
        infos = list(self.cam_info.values())
        share = (self.cfg.single_camera and len(infos) > 0 and all(
            (i[0], i[2], i[3]) == (infos[0][0], infos[0][2], infos[0][3])
            for i in infos))
        if share:
            model_id, params, w, h, prior = infos[0]
            self.rec.add_camera(Camera(-1, model_id, w, h,
                                       np.array(params, np.float64), prior))
        for iid, kps in self.kp.items():
            model_id, params, w, h, prior = self.cam_info[iid]
            if not share:
                self.rec.add_camera(Camera(iid, model_id, w, h,
                                           np.array(params, np.float64), prior))
            self._init_log_f[iid] = float(np.log(max(params[0], 1e-6)))
            self.rec.add_image(Image(
                image_id=iid, camera_id=-1 if share else iid, name=f"image_{iid}",
                xys=kps.copy(), point3D_ids=np.full(len(kps), -1, np.int64)))

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _kp_norm(self, image_id) -> np.ndarray:
        """Normalized coords of all keypoints of an image, cached."""
        cached = self._kp_norm_cache.get(image_id)
        if cached is None:
            cam = self.rec.cameras[self.rec.images[image_id].camera_id]
            cached = camlib.np_image_to_cam(cam.model_id, cam.params_padded,
                                            self.kp[image_id])
            self._kp_norm_cache[image_id] = cached
        return cached

    def _focal(self, image_id) -> float:
        return float(self.rec.cameras[self.rec.images[image_id].camera_id].params[0])

    def point3D_of(self, image_id, kp_idx) -> int:
        return int(self.rec.images[image_id].point3D_ids[kp_idx])

    def _set_registered(self, image_id: int, registered: bool):
        self.rec.images[image_id].registered = registered
        self.graph.set_registered(image_id, registered)

    # ------------------------------------------------------------------
    # initial pair (COLMAP FindInitialImagePair / RegisterInitialImagePair)
    # ------------------------------------------------------------------
    def find_initial_pair(self) -> Optional[Tuple[int, int]]:
        """The verified pair with the most inliers among those with enough
        inliers and triangulation angle and a usable geometry (not
        undefined, degenerate or a watermark)."""
        min_ang = math.radians(self.cfg.init_min_tri_angle_deg)
        cands = []
        for (i, j) in self.graph.pairs:
            tv = self.two_view.get((i, j))
            if tv is None or tv["num_inliers"] < self.cfg.init_min_num_inliers:
                continue
            if tv["tri_angle"] < min_ang or tv.get("config", 2) in (0, 1, 7):
                continue
            cands.append((tv["num_inliers"], i, j))
        if not cands:
            return None
        cands.sort(reverse=True)
        return cands[0][1], cands[0][2]

    def register_initial_pair(self, image_id1: int, image_id2: int) -> bool:
        tv = self.two_view[(min(image_id1, image_id2), max(image_id1, image_id2))]
        if image_id1 > image_id2:
            qrel, trel = geom.np_pose_inverse(tv["qvec"], tv["tvec"])
        else:
            qrel, trel = np.asarray(tv["qvec"]), np.asarray(tv["tvec"])
        im1, im2 = self.rec.images[image_id1], self.rec.images[image_id2]
        im1.qvec, im1.tvec = np.array([1.0, 0, 0, 0]), np.zeros(3)
        im2.qvec, im2.tvec = np.asarray(qrel, np.float64).copy(), np.asarray(trel, np.float64).copy()
        self._set_registered(image_id1, True)
        self._set_registered(image_id2, True)
        self._num_total_reg_images = 2
        n = self.triangulate_image(image_id1)
        log.info("initial pair (%d, %d): %d points", image_id1, image_id2, n)
        return n >= self.cfg.init_min_num_inliers // 2

    # ------------------------------------------------------------------
    # next images and registration (COLMAP RegisterNextImage)
    # ------------------------------------------------------------------
    def find_next_images(self) -> List[int]:
        """Unregistered images with trials left and >= 3 visible points,
        most visible points first."""
        scores = []
        for iid, im in self.rec.images.items():
            if im.registered or self.num_reg_trials.get(iid, 0) >= self.cfg.max_reg_trials:
                continue
            n = self.graph.num_visible_points3D(iid, self.point3D_of)
            if n >= 3:
                scores.append((n, iid))
        scores.sort(reverse=True)
        return [iid for _, iid in scores]

    def register_next_image(self, image_id: int) -> bool:
        """PnP RANSAC on the image's 2D-3D correspondences; on success the
        pose is set and the inliers join their tracks."""
        attempt = self.num_reg_trials.get(image_id, 0)
        self.num_reg_trials[image_id] = attempt + 1
        if self.graph.has_fast_scans:
            kps_f, pids_f = self.graph.corrs_2d3d(image_id)
            corr2d3d = [(int(k), int(p)) for k, p in zip(kps_f, pids_f)
                        if int(p) in self.rec.points3D]
        else:
            corr2d3d, seen_kp = [], set()
            for kp_idx in range(len(self.kp[image_id])):
                for (j, kj) in self.graph.correspondences(image_id, kp_idx):
                    if not self.rec.images[j].registered:
                        continue
                    pid = self.point3D_of(j, kj)
                    if pid >= 0 and kp_idx not in seen_kp:
                        corr2d3d.append((kp_idx, pid))
                        seen_kp.add(kp_idx)
                        break
        if len(corr2d3d) < max(6, self.cfg.abs_pose_min_num_inliers // 2):
            return False
        kp_idx = np.array([c[0] for c in corr2d3d])
        x3d = np.stack([self.rec.points3D[c[1]].xyz for c in corr2d3d])
        xn = self._kp_norm(image_id)[kp_idx]

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float64), device=self.device)

        res = pnp.pnp_ransac(
            pnp_generator(self.device, self.seed, image_id, attempt), t(x3d), t(xn),
            torch.ones(len(corr2d3d), dtype=torch.bool, device=self.device),
            self.cfg.abs_pose_max_error / self._focal(image_id),
            min_num_inliers=min(self.cfg.abs_pose_min_num_inliers,
                                max(6, len(corr2d3d) // 2)),
            min_inlier_ratio=self.cfg.abs_pose_min_inlier_ratio)
        out = torch.cat([res.qvec, res.tvec, res.ok.to(res.tvec.dtype)[None],
                         res.inlier_mask.to(res.tvec.dtype)]).cpu().numpy()
        if out[7] < 0.5:
            return False
        im = self.rec.images[image_id]
        im.qvec, im.tvec = out[0:4].copy(), out[4:7].copy()
        self._set_registered(image_id, True)
        self._num_total_reg_images += 1
        for (k, pid), ok in zip(corr2d3d, out[8:] > 0.5):
            if ok and pid in self.rec.points3D and im.point3D_ids[k] < 0:
                self.rec.points3D[pid].track.append((image_id, int(k)))
                self.rec.set_point3D_id(image_id, int(k), pid)
        return True

    # ------------------------------------------------------------------
    # triangulation (COLMAP TriangulateImage / Retriangulate)
    # ------------------------------------------------------------------
    def triangulate_image(self, image_id: int) -> int:
        """Continue existing tracks and triangulate new points seen from
        image_id. Returns the number of new points."""
        if not self.rec.images[image_id].registered:
            return 0
        self._continue_tracks(image_id)
        return self._triangulate_tracks(self._new_track_candidates(image_id))

    def _continue_tracks(self, image_id: int) -> None:
        """Link unassigned keypoints of image_id to existing points reachable
        through correspondences (batched geometric check)."""
        im = self.rec.images[image_id]
        if self.graph.has_fast_scans:
            kps_f, pids_f = self.graph.continuations(image_id)
            if len(kps_f) == 0:
                return
            pts = self.rec.points3D
            xyz = np.zeros((len(pids_f), 3))
            valid = np.zeros(len(pids_f), bool)
            for i, pid in enumerate(pids_f):
                pt = pts.get(int(pid))
                if pt is not None and im.point3D_ids[int(kps_f[i])] < 0:
                    xyz[i] = pt.xyz
                    valid[i] = True
            fits = np.zeros(len(pids_f), bool)
            if valid.any():
                fits[valid] = self._batch_fits(np.full(int(valid.sum()), image_id),
                                               kps_f[valid], xyz[valid])
            for i in np.flatnonzero(fits):
                kp_idx, pid = int(kps_f[i]), int(pids_f[i])
                if im.point3D_ids[kp_idx] >= 0:
                    continue
                pts[pid].track.append((image_id, kp_idx))
                self.rec.set_point3D_id(image_id, kp_idx, pid)
        else:
            for kp_idx in range(len(self.kp[image_id])):
                if im.point3D_ids[kp_idx] >= 0:
                    continue
                for (j, kj) in self.graph.correspondences(image_id, kp_idx):
                    if not self.rec.images[j].registered:
                        continue
                    pid = self.point3D_of(j, kj)
                    if pid < 0:
                        continue
                    if self._observation_fits(image_id, kp_idx, pid):
                        self.rec.points3D[pid].track.append((image_id, kp_idx))
                        self.rec.set_point3D_id(image_id, kp_idx, pid)
                    break

    def _new_track_candidates(self, image_id: int):
        """Unassigned keypoints of image_id with >= 1 registered unassigned
        correspondence, as candidate tracks [(image, kp), ...]."""
        if self.graph.has_fast_scans:
            return self.graph.new_track_candidates(image_id)
        im = self.rec.images[image_id]
        tracks = []
        for kp_idx in range(len(self.kp[image_id])):
            if im.point3D_ids[kp_idx] >= 0:
                continue
            track = [(image_id, kp_idx)]
            for (j, kj) in self.graph.correspondences(image_id, kp_idx):
                if self.rec.images[j].registered and self.point3D_of(j, kj) < 0:
                    track.append((j, kj))
            if len(track) >= 2:
                tracks.append(track)
        return tracks

    def _batch_fits(self, iids, kps, xyz, thr_factor: float = 1.0) -> np.ndarray:
        """Does point xyz[i] reproject within the filter threshold (times
        ``thr_factor``) at keypoint kps[i] of image iids[i]? One batched
        projection."""
        if len(np.asarray(iids)) == 0:
            return np.zeros(0, bool)
        err, z = np_reproj_errors(self.rec, iids, kps, xyz)
        return (z > 0) & (err < self.cfg.filter_max_reproj_error * thr_factor)

    def _observation_fits(self, image_id, kp_idx, pid, thr_factor: float = 1.0) -> bool:
        return bool(self._batch_fits([image_id], [kp_idx],
                                     self.rec.points3D[pid].xyz[None], thr_factor)[0])

    def _triangulate_tracks(self, tracks) -> int:
        """Triangulate candidate tracks in one batched call on the device
        (in chunks for very large sets); add the accepted points."""
        if not tracks:
            return 0
        CHUNK = 262144
        if len(tracks) > CHUNK:
            return sum(self._triangulate_tracks(tracks[s: s + CHUNK])
                       for s in range(0, len(tracks), CHUNK))
        T = 8
        data = np.zeros((len(tracks), T, 10))
        data[..., 0] = 1.0
        thr_n = np.empty(len(tracks))
        for b, track in enumerate(tracks):
            f_sum = 0.0
            for t, (iid, kp) in enumerate(track[:T]):
                im = self.rec.images[iid]
                data[b, t, 0:4] = im.qvec
                data[b, t, 4:7] = im.tvec
                data[b, t, 7:9] = self._kp_norm(iid)[kp]
                data[b, t, 9] = 1.0
                f_sum += self._focal(iid)
            thr_n[b] = self.cfg.filter_max_reproj_error / (f_sum / min(len(track), T))
        with span("triangulate.dlt"):
            out = triangulate.triangulate_tracks_packed(
                torch.as_tensor(data, device=self.device),
                torch.as_tensor(thr_n, device=self.device),
                math.radians(self.cfg.min_tri_angle_deg)).cpu().numpy()
        count("triangulate.tracks", len(tracks))
        count("triangulate.eigh_calls", eigh_calls(len(tracks)))
        xyz, ok, view_ok = out[:, 0:3], out[:, 3] > 0.5, out[:, 4:] > 0.5

        n_new = 0
        for b, track in enumerate(tracks):
            if not ok[b]:
                continue
            kept = [te for t, te in enumerate(track[:T]) if view_ok[b, t]]
            # guard against double assignment created earlier in this batch
            kept = [(i, k) for (i, k) in kept if self.rec.images[i].point3D_ids[k] < 0]
            if len(kept) < 2:
                continue
            self.rec.add_point3D(xyz[b], kept)
            n_new += 1
        return n_new

    def retriangulate(self):
        """Continue and create tracks from every registered image, with one
        batched triangulation for all new candidates (a candidate anchored
        at both ends loses its second copy to the double-assignment guard)."""
        tracks = []
        for iid in self.rec.registered_image_ids:
            self._continue_tracks(iid)
            tracks.extend(self._new_track_candidates(iid))
        self._triangulate_tracks(tracks)

    # ------------------------------------------------------------------
    # track completion + merging (COLMAP CompleteAndMergeTracks)
    # ------------------------------------------------------------------
    def complete_tracks(self, point_ids=None) -> int:
        """Extend tracks to reachable unassigned keypoints that fit the
        point; with point_ids, only those points' tracks (the local
        refinement completes its window's points, not the model)."""
        if self.graph.has_fast_scans:
            iids, kps, pids = self.graph.complete_candidates()
            if point_ids is not None and len(pids):
                sub = np.isin(pids, np.fromiter(point_ids, np.int64, len(point_ids)))
                iids, kps, pids = iids[sub], kps[sub], pids[sub]
            if len(iids) == 0:
                return 0
            pts = self.rec.points3D
            xyz = np.zeros((len(pids), 3))
            valid = np.zeros(len(pids), bool)
            for i, pid in enumerate(pids):
                pt = pts.get(int(pid))
                if pt is not None:
                    xyz[i] = pt.xyz
                    valid[i] = True
            fits = np.zeros(len(pids), bool)
            if valid.any():
                fits[valid] = self._batch_fits(iids[valid], kps[valid], xyz[valid])
            n = 0
            for i in np.flatnonzero(fits):
                iid, kp, pid = int(iids[i]), int(kps[i]), int(pids[i])
                if self.rec.images[iid].point3D_ids[kp] >= 0:
                    continue  # a previous candidate won this keypoint
                pts[pid].track.append((iid, kp))
                self.rec.set_point3D_id(iid, kp, pid)
                n += 1
            return n
        n = 0
        for pid in list(self.rec.points3D) if point_ids is None else list(point_ids):
            pt = self.rec.points3D.get(pid)
            if pt is None:
                continue
            for (iid, kp) in list(pt.track):
                for (j, kj) in self.graph.correspondences(iid, kp):
                    im_j = self.rec.images[j]
                    if not im_j.registered or im_j.point3D_ids[kj] >= 0:
                        continue
                    if self._observation_fits(j, kj, pid):
                        pt.track.append((j, int(kj)))
                        self.rec.set_point3D_id(j, int(kj), pid)
                        n += 1
        return n

    def merge_tracks(self, point_ids=None) -> int:
        """Merge pairs of points linked by a correspondence whose
        track-weighted mean position fits both tracks; with point_ids, only
        merges that touch those points."""
        if self.graph.has_fast_scans:
            return self._merge_tracks_fast(point_ids)
        n = 0
        for pid in list(self.rec.points3D) if point_ids is None else list(point_ids):
            pt = self.rec.points3D.get(pid)
            if pt is None:
                continue
            partner = None
            for (iid, kp) in pt.track:
                for (j, kj) in self.graph.correspondences(iid, kp):
                    if not self.rec.images[j].registered:
                        continue
                    pid2 = self.point3D_of(j, kj)
                    if pid2 >= 0 and pid2 != pid:
                        partner = pid2
                        break
                if partner:
                    break
            if partner is None or partner not in self.rec.points3D:
                continue
            pt2 = self.rec.points3D[partner]
            w1, w2 = len(pt.track), len(pt2.track)
            merged_xyz = (pt.xyz * w1 + pt2.xyz * w2) / (w1 + w2)
            old_xyz = pt.xyz.copy()
            pt.xyz = merged_xyz
            fits = all(self._observation_fits(i, k, pid)
                       for (i, k) in pt.track + pt2.track
                       if self.rec.images[i].registered)
            pt.xyz = old_xyz
            if not fits:
                continue
            for (i, k) in pt2.track:
                self.rec.set_point3D_id(i, int(k), pid)
            pt.track = pt.track + pt2.track
            pt.xyz = merged_xyz
            del self.rec.points3D[partner]
            n += 1
        return n

    def _merge_tracks_fast(self, point_ids=None) -> int:
        """Native candidate scan + one batched fit check for all candidate
        merges, then sequential conflict-free application."""
        pa, pb = self.graph.merge_candidates()
        if point_ids is not None and len(pa):
            ids = np.fromiter(point_ids, np.int64, len(point_ids))
            sub = np.isin(pa, ids) | np.isin(pb, ids)
            pa, pb = pa[sub], pb[sub]
        if len(pa) == 0:
            return 0
        pts = self.rec.points3D
        cand = []           # (pid_keep, pid_gone, merged_xyz)
        f_iids, f_kps, f_xyz, f_cand = [], [], [], []
        for a, b in zip(pa, pb):
            a, b = int(a), int(b)
            pt1, pt2 = pts.get(a), pts.get(b)
            if pt1 is None or pt2 is None:
                continue
            w1, w2 = len(pt1.track), len(pt2.track)
            merged = (pt1.xyz * w1 + pt2.xyz * w2) / (w1 + w2)
            ci = len(cand)
            cand.append((a, b, merged))
            for (i, k) in pt1.track + pt2.track:
                if self.rec.images[i].registered:
                    f_iids.append(i)
                    f_kps.append(k)
                    f_xyz.append(merged)
                    f_cand.append(ci)
        if not cand:
            return 0
        fits = self._batch_fits(f_iids, f_kps, np.asarray(f_xyz))
        ok_per_cand = np.ones(len(cand), bool)
        np.logical_and.at(ok_per_cand, np.asarray(f_cand), fits)

        n = 0
        touched = set()
        for ci in np.flatnonzero(ok_per_cand):
            a, b, merged = cand[ci]
            # the check used a pre-round snapshot of both tracks: once either
            # endpoint merged this round, defer the candidate
            if a in touched or b in touched:
                continue
            pt1, pt2 = pts.get(a), pts.get(b)
            if pt1 is None or pt2 is None:
                continue
            for (i, k) in pt2.track:
                self.rec.set_point3D_id(i, int(k), a)
            pt1.track = pt1.track + pt2.track
            pt1.xyz = merged
            del pts[b]
            touched.update((a, b))
            n += 1
        return n

    # ------------------------------------------------------------------
    # filtering (COLMAP FilterPoints / FilterImages)
    # ------------------------------------------------------------------
    def filter_points(self, point_ids=None) -> int:
        """Remove points with a large reprojection error, fewer than two
        registered observations, or a widest triangulation angle below
        ``min_tri_angle_deg``; with point_ids, only those points are
        checked."""
        if not self.rec.points3D:
            return 0
        self.rec.compute_reprojection_errors(point_ids)
        min_ang = math.radians(self.cfg.min_tri_angle_deg)
        pids, xyz, obs_pt, obs_img, _, img_list = self.rec.flat_observations(point_ids)
        Np = len(pids)
        if Np == 0:
            return 0
        err = np.fromiter((self.rec.points3D[p].error for p in pids), np.float64, Np)
        bad = (err > self.cfg.filter_max_reproj_error) | (err < 0)

        reg = np.asarray([self.rec.images[i].registered for i in img_list])
        if len(obs_pt):
            keep = reg[obs_img]
            op, oi = obs_pt[keep], obs_img[keep]
        else:
            op = oi = np.zeros(0, np.int64)
        counts = np.bincount(op, minlength=Np)
        bad |= counts < 2

        if len(op) and counts.max() >= 2:
            q = np.stack([self.rec.images[i].qvec for i in img_list])
            t = np.stack([self.rec.images[i].tvec for i in img_list])
            centers = geom.np_projection_center(q, t)
            order = np.argsort(op, kind="stable")
            op_s, oi_s = op[order], oi[order]
            offsets = np.concatenate([[0], np.cumsum(counts)])
            pos = np.arange(len(op_s)) - offsets[op_s]
            T = int(counts.max())
            # at most S spread observations per point enter the pairwise
            # angle check, each track's first and last always among them:
            # an under-estimated widest angle only filters more
            S = 8
            if T > S:
                cnt = counts[op_s]
                slot = (pos * S + S - 1) // np.maximum(cnt, 1)
                first = np.ones(len(pos), bool)
                first[1:] = (op_s[1:] != op_s[:-1]) | (slot[1:] != slot[:-1])
                lastg = np.ones(len(pos), bool)
                lastg[:-1] = op_s[1:] != op_s[:-1]
                keep = (first & (slot != S - 1)) | lastg
                op_s, oi_s = op_s[keep], oi_s[keep]
                pos = slot[keep]
                T = S
            rays = np.zeros((Np, T, 3), np.float32)
            mask = np.zeros((Np, T), bool)
            rays[op_s, pos] = (centers[oi_s] - xyz[op_s]).astype(np.float32)
            mask[op_s, pos] = True
            rn = rays / np.maximum(np.linalg.norm(rays, axis=-1, keepdims=True), 1e-12)
            cosang = np.einsum("pti,psi->pts", rn, rn)
            pair = mask[:, :, None] & mask[:, None, :]
            min_cos = np.min(np.where(pair, cosang, 1.0), axis=(1, 2))
            bad |= min_cos > np.cos(min_ang)

        for i in np.flatnonzero(bad):
            self.rec.remove_point3D(int(pids[i]))
        return int(bad.sum())

    def filter_images(self) -> int:
        """Deregister images left with fewer than 3 points (once more than
        two images are registered)."""
        removed = 0
        for iid in self.rec.registered_image_ids:
            if self._num_total_reg_images > 2 and self.rec.images[iid].num_points3D < 3:
                self.rec.deregister_image(iid)
                self.graph.set_registered(iid, False)
                removed += 1
        return removed

    # ------------------------------------------------------------------
    # bundle adjustment
    # ------------------------------------------------------------------
    def _run_ba(self, image_ids, max_iterations, refine_intrinsics: bool = True):
        """One LM solve over the registered images of image_ids and their
        points (dense up to ``ba_dense_max_images`` slots, CG past it);
        writes the result back. Returns the solve's info, or None when
        there is nothing to solve."""
        cam_in, pt_in, obs_in, meta = pack_bundle_flat(self.rec, image_ids)
        if not meta["point_ids"] or len(meta["image_ids"]) < 2:
            return None
        # gauge: fully fix slot 0, fix one translation component of slot 1
        cam_in[0, 12:18] = 0.0
        cam_in[1, 15] = 0.0
        # per-slot prior weight = the physical camera's weight / group size
        group_size: Dict[int, int] = {}
        for iid in meta["image_ids"]:
            cid = self.rec.images[iid].camera_id
            group_size[cid] = group_size.get(cid, 0) + 1
        for s, iid in enumerate(meta["image_ids"]):
            cam_in[s, 18] = self._init_log_f[iid]
            g = group_size[self.rec.images[iid].camera_id]
            cam_in[s, 20] = self.cfg.intr_prior_weight_f / g
            cam_in[s, 21] = self.cfg.intr_prior_weight_k / g
        refine = float(bool(refine_intrinsics))
        scal_in = np.asarray([refine, refine, self.cfg.filter_max_reproj_error], np.float32)
        M, P = cam_in.shape[0], pt_in.shape[0]
        out = ba.bundle_adjust_flat_segmented(
            cam_in, pt_in, obs_in, scal_in, max_iterations=max_iterations,
            solver="dense" if M <= self.cfg.ba_dense_max_images else "cg",
            cg_iters=self.cfg.ba_cg_iters, device=self.device)
        cam = out[: M * 9].reshape(M, 9).astype(np.float64)
        xyz = out[M * 9: M * 9 + P * 3].reshape(P, 3).astype(np.float64)
        stats = out[M * 9 + P * 3:]
        p_out = ba.BundleParams(qvec=cam[:, 0:4], tvec=cam[:, 4:7],
                                log_f=cam[:, 7], k1=cam[:, 8], xyz=xyz)
        info = {"initial_cost": stats[0], "final_cost": stats[1],
                "iterations": stats[2], "mean_reproj_px": stats[3],
                "num_obs": stats[4], "point_ids": meta["point_ids"]}
        unpack_bundle(self.rec, p_out, meta, update_intrinsics=refine_intrinsics)
        if refine_intrinsics:
            for iid in meta["image_ids"]:   # normalized keypoints follow intrinsics
                self._kp_norm_cache.pop(iid, None)
        return info

    def local_bundle_adjustment(self, image_ids):
        """Iterative local refinement: BA over the batch and the images
        sharing the most points with it (at most 16 images), then complete,
        merge and filter the window's points; repeated while the solve and
        the point count still move. ``image_ids``: one id or the batch of
        registrations that share one refinement round."""
        if isinstance(image_ids, (int, np.integer)):
            image_ids = [int(image_ids)]
        batch = [i for i in image_ids if self.rec.images[i].registered]
        if not batch:
            return
        share: Dict[int, int] = {}
        bset = set(batch)
        for image_id in batch:
            for pid in self.rec.images[image_id].point3D_ids:
                if pid < 0:
                    continue
                for (j, _) in self.rec.points3D[int(pid)].track:
                    if j not in bset and self.rec.images[j].registered:
                        share[j] = share.get(j, 0) + 1
        n_neighbors = min(7 * len(batch), 16 - len(batch))
        neighbors = sorted(share, key=share.get, reverse=True)[:n_neighbors]
        # the gauge (_run_ba fixes slots 0 and 1) goes to the most
        # established images: the ones observing the most points
        anchors = sorted(neighbors, key=lambda j: self.rec.images[j].num_points3D,
                         reverse=True)[:2]
        window = anchors + [j for j in neighbors if j not in anchors] + batch
        if len(window) < 2:
            return
        prev_points = None
        for _ in range(self.cfg.ba_local_max_refinements):
            info = self._run_ba(window, self.cfg.ba_local_max_num_iterations,
                                refine_intrinsics=True)
            if info is None:
                return
            touched = info["point_ids"]
            self.complete_tracks(touched)
            self.merge_tracks(touched)
            self.filter_points(touched)
            rel_drop = (info["initial_cost"] - info["final_cost"]) / max(
                float(info["initial_cost"]), 1e-12)
            if rel_drop < 10 * self.cfg.ba_local_max_refinement_change:
                break
            num_points = len(self.rec.points3D)
            if prev_points is not None and abs(num_points - prev_points) / max(
                    prev_points, 1) < self.cfg.ba_local_max_refinement_change:
                break
            prev_points = num_points

    def global_bundle_adjustment(self):
        """Iterative global refinement: retriangulate, BA over all
        registered images, complete and merge tracks, filter; repeated until
        the observation count or the cost stops changing."""
        reg = self.rec.registered_image_ids
        if len(reg) < 2:
            return
        for it in range(self.cfg.ba_global_max_refinements):
            with span("refine.retriangulate"):
                self.retriangulate()
            prev_obs = sum(p.track_length for p in self.rec.points3D.values())
            # stricter solve for tiny models
            iters = self.cfg.ba_global_max_num_iterations
            if len(reg) < 10:
                iters *= 2
            with span("refine.ba"):
                info = self._run_ba(reg, iters)
            if info is None:
                return
            with span("refine.track_ops"):
                self.complete_tracks()
                self.merge_tracks()
                self.filter_points()
                self.filter_images()
            log.info("global refine round %d: cost %.0f -> %.0f", it + 1,
                     float(info["initial_cost"]), float(info["final_cost"]))
            reg = self.rec.registered_image_ids
            num_obs = sum(p.track_length for p in self.rec.points3D.values())
            change = abs(num_obs - prev_obs) / max(prev_obs, 1)
            rel_drop = (info["initial_cost"] - info["final_cost"]) / max(
                float(info["initial_cost"]), 1e-12)
            if (change < self.cfg.ba_global_max_refinement_change
                    or rel_drop < self.cfg.ba_global_max_refinement_change):
                break

    def _check_global_ba_trigger(self) -> bool:
        """Global refinement is due when the registered images or points
        grew by the configured ratio or count since the last one."""
        n_reg, n_pts = self._num_total_reg_images, len(self.rec.points3D)
        prev_reg, prev_pts = self._ba_prev_num_reg, self._ba_prev_num_points
        if prev_reg == 0:
            return True
        if (n_reg >= self.cfg.ba_global_images_ratio * prev_reg
                or n_reg >= prev_reg + self.cfg.ba_global_images_freq):
            return True
        return bool(prev_pts) and (n_pts >= self.cfg.ba_global_points_ratio * prev_pts
                                   or n_pts >= prev_pts + self.cfg.ba_global_points_freq)

    def _mark_global_ba(self):
        self._ba_prev_num_reg = self._num_total_reg_images
        self._ba_prev_num_points = len(self.rec.points3D)

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------
    def reconstruct(self, init_pair: Optional[Tuple[int, int]] = None) -> Reconstruction:
        """Initial pair, then rounds of up to ``register_batch_size``
        registrations (candidates re-ranked after every success) each
        followed by one local refinement and, when due, a global one; a
        final global refinement closes the run."""
        if init_pair is None:
            init_pair = self.find_initial_pair()
        if init_pair is None:
            log.warning("no valid initial pair")
            return self.rec
        if not self.register_initial_pair(*init_pair):
            log.warning("initial pair registration weak")
        self.global_bundle_adjustment()
        self._mark_global_ba()
        while True:
            batch: List[int] = []
            while len(batch) < max(1, self.cfg.register_batch_size):
                image_id = next((i for i in self.find_next_images()
                                 if self.register_next_image(i)), None)
                if image_id is None:
                    break
                self.triangulate_image(image_id)
                batch.append(image_id)
            if not batch:
                break
            self.local_bundle_adjustment(batch)
            if self._check_global_ba_trigger():
                self.global_bundle_adjustment()
                self._mark_global_ba()
        self.global_bundle_adjustment()
        self.rec.compute_reprojection_errors()
        log.info("reconstruction: %d images, %d points, mean err %.3f px",
                 self.rec.num_registered, len(self.rec.points3D),
                 self.rec.mean_reprojection_error())
        return self.rec
