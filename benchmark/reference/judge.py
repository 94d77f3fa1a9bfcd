"""The plain reference that decides ``correct``: the scene's ground truth
from the benchmark's generator, and numpy arithmetic in float64 that judges
the program's outputs against it.

It imports no part of the program. The harness hands it plain arrays: the
merged sparse model as the program wrote it (poses, cameras, keypoints,
points and their observations), and for a traffic with the dense stages
the fused cloud and the mesh's vertices. Every number here is lower-better:

- ``unregistered_share``: offered images the model left out, over those
  offered;
- ``rpe_rms``: the relative position error of consecutive frames after the
  model's Sim(3) alignment to the truth, over the true baseline, as a root
  mean square over every consecutive pair of offered frames; a pair with a
  frame the model left out counts as an error of one baseline;
- ``rpe_rms_trim1``: the same root mean square over every consecutive pair
  but the worst one, so that one weak pair (as at a track's end, where a
  frame has matches on one side only) does not decide it alone; a single
  altered pose still moves two pairs;
- ``rot_rms_deg``: the rotation error of each registered camera after the
  same alignment, root mean square, in degrees;
- ``reproj_rms_px``: every observation of the model reprojected through its
  own camera and pose, against its keypoint, root mean square in pixels;
- ``fused_p90_rel``, ``fused_p99_rel`` and ``mesh_p90_rel``: the 90th and
  99th percentile of the fused points' and the 90th of the mesh vertices'
  distance to the true surface along z, after the model's Sim(3), over
  the scene depth.
"""

from __future__ import annotations

import numpy as np

# COLMAP camera model ids, as the program's tables store them
SIMPLE_PINHOLE, PINHOLE, SIMPLE_RADIAL, RADIAL, OPENCV = range(5)


def quat_to_rotmat(q):
    """(..., 4) wxyz unit quaternions -> (..., 3, 3) rotation matrices."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def centres(qvecs, tvecs):
    """Projection centres -R^T t of world-to-camera poses."""
    R = quat_to_rotmat(qvecs)
    return -np.einsum("nji,nj->ni", R, np.asarray(tvecs, np.float64))


def align(q_est, t_est, q_true, t_true):
    """The Sim(3) (s, R, t) that takes the model's world to the truth's:
    R from the cameras' orientations (the rotation nearest to the sum of
    R_true^T R_est), then s and t by least squares on the centres. Centres
    alone leave the rotation about a straight track undetermined."""
    Re, Rt = quat_to_rotmat(q_est), quat_to_rotmat(q_true)
    U, _, Vt = np.linalg.svd(np.einsum("nji,njk->ik", Rt, Re))
    R = U @ np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))]) @ Vt
    c_est, c_true = centres(q_est, t_est), centres(q_true, t_true)
    mu_e, mu_t = c_est.mean(0), c_true.mean(0)
    ce = (c_est - mu_e) @ R.T
    s = float((ce * (c_true - mu_t)).sum() / max((ce * ce).sum(), 1e-300))
    return s, R, mu_t - s * R @ mu_e


def surface_z(x, y, depth0, depth_spread):
    return depth0 + depth_spread * (
        0.5 * np.sin(0.45 * x) * np.cos(0.35 * y) + 0.25 * np.sin(0.9 * y))


def project(model_id, params, R, t, xyz):
    """COLMAP's projection of world points through one camera (the models
    the program writes: SIMPLE_PINHOLE, PINHOLE, SIMPLE_RADIAL, RADIAL,
    OPENCV)."""
    p = np.asarray(params, np.float64)
    xc = xyz @ R.T + t
    x, y = xc[:, 0] / xc[:, 2], xc[:, 1] / xc[:, 2]
    k1 = k2 = p1 = p2 = 0.0
    if model_id in (SIMPLE_PINHOLE, SIMPLE_RADIAL, RADIAL):
        fx = fy = p[0]
        cx, cy = p[1], p[2]
        if model_id in (SIMPLE_RADIAL, RADIAL):
            k1 = p[3]
        if model_id == RADIAL:
            k2 = p[4]
    elif model_id in (PINHOLE, OPENCV):
        fx, fy, cx, cy = p[:4]
        if model_id == OPENCV:
            k1, k2, p1, p2 = p[4:8]
    else:
        raise ValueError(f"unknown camera model {model_id}")
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * k2)
    dx = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return np.stack([fx * dx + cx, fy * dy + cy], -1)


def _rms(a):
    a = np.asarray(a, np.float64)
    return float(np.sqrt(np.mean(a * a))) if a.size else float("inf")


def judge_sparse(model: dict, truth: dict) -> dict:
    """The sparse numbers of one reconstruction.

    model: ``image_ids`` (R,), ``qvecs`` (R, 4), ``tvecs`` (R, 3),
    ``cameras`` {image_id: (model_id, params)}, ``obs_image`` (N,),
    ``obs_xy`` (N, 2) the observed keypoints, ``obs_point`` (N,) rows into
    ``points`` (P, 3). truth: ``qvecs`` and ``tvecs`` of every offered
    frame, in image-id order."""
    n_off = len(truth["qvecs"])
    ids = np.asarray(model["image_ids"], np.int64)
    out = {"unregistered_share": 1.0 - len(ids) / n_off}
    if len(ids) < 3:
        out.update(rpe_rms=float("inf"), rpe_rms_trim1=float("inf"),
                   rot_rms_deg=float("inf"), reproj_rms_px=float("inf"))
        return out
    order = np.argsort(ids)
    ids = ids[order]
    q_est, t_est = np.asarray(model["qvecs"])[order], np.asarray(model["tvecs"])[order]
    c_est = centres(q_est, t_est)
    c_true = centres(truth["qvecs"][ids], truth["tvecs"][ids])
    s, R, t = align(q_est, t_est, truth["qvecs"][ids], truth["tvecs"][ids])
    aligned = s * c_est @ R.T + t
    consecutive = np.nonzero(np.diff(ids) == 1)[0]
    d_est = aligned[consecutive + 1] - aligned[consecutive]
    d_true = c_true[consecutive + 1] - c_true[consecutive]
    rel = np.ones(n_off - 1)
    rel[ids[consecutive]] = np.linalg.norm(d_est - d_true, axis=1) / np.linalg.norm(d_true, axis=1)
    out["rpe_rms"] = _rms(rel)
    out["rpe_rms_trim1"] = _rms(np.sort(rel)[:-1])
    # camera-to-world rotations: aligned estimate R R_est^T against R_true^T
    rel = np.einsum("nij,jk,nlk->nil", quat_to_rotmat(truth["qvecs"][ids]), R,
                    quat_to_rotmat(q_est))
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    out["rot_rms_deg"] = _rms(np.degrees(np.arccos(cos)))
    obs_img = np.asarray(model["obs_image"], np.int64)
    obs_xy = np.asarray(model["obs_xy"], np.float64)
    pts = np.asarray(model["points"], np.float64)[np.asarray(model["obs_point"], np.int64)]
    err = []
    R_est = quat_to_rotmat(q_est)
    for n, iid in enumerate(ids):
        sel = obs_img == iid
        if sel.any():
            mid, prm = model["cameras"][int(iid)]
            uv = project(int(mid), prm, R_est[n], t_est[n], pts[sel])
            err.append(np.linalg.norm(uv - obs_xy[sel], axis=1))
    out["reproj_rms_px"] = _rms(np.concatenate(err)) if err else float("inf")
    return out


def surface_dz(model: dict, truth: dict, xyz):
    """|z - surface(x, y)| over the scene depth of points in the model's
    frame after the model's Sim(3) to the truth; None where the model or
    the points are too few."""
    xyz = np.asarray(xyz, np.float64).reshape(-1, 3)
    ids = np.asarray(model["image_ids"], np.int64)
    if len(ids) < 3 or len(xyz) == 0:
        return None
    s, R, t = align(model["qvecs"], model["tvecs"], truth["qvecs"][ids], truth["tvecs"][ids])
    p = s * xyz @ R.T + t
    dz = np.abs(p[:, 2] - surface_z(p[:, 0], p[:, 1], truth["depth0"], truth["depth_spread"]))
    return dz / truth["depth0"]


def surface_quantiles(model: dict, truth: dict, xyz, qs) -> list:
    """Percentiles ``qs`` of ``surface_dz``."""
    dz = surface_dz(model, truth, xyz)
    return [float("inf")] * len(qs) if dz is None else np.percentile(dz, qs).tolist()


def judge(model: dict, truth: dict, fused_xyz=None, mesh_verts=None) -> dict:
    """Every number of one reconstruction; the dense ones where the cloud
    and the mesh are given."""
    out = judge_sparse(model, truth)
    if fused_xyz is not None:
        out["fused_p90_rel"], out["fused_p99_rel"] = surface_quantiles(
            model, truth, fused_xyz, [90, 99])
    if mesh_verts is not None:
        out["mesh_p90_rel"], = surface_quantiles(model, truth, mesh_verts, [90])
    return out


def to_bf16(a):
    """Round float64 values to the nearest bfloat16 (ties to even) and back:
    the control's precision."""
    a = np.asarray(a, np.float32)
    bits = a.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, number, limit)]): every number at or under its
    limit; a number that is missing or not finite fails."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and np.isfinite(v) and v <= limit
        ok &= bool(good)
        rows.append((name, v, limit))
    return ok, rows
