"""Single-program incremental mapper for one cluster (port of
``ops/device_mapper.py``).

The cluster's whole incremental reconstruction runs over device tensors
with a registration schedule fixed beforehand (engine/device_cluster.py):

  for step in order:                   # fixed schedule + retry pass
      PnP-RANSAC the step's image against the current point set
      triangulate every pending track with >= 2 registered views
      masked LM bundle adjustment (ops/ba.bundle_adjust)
      demote observations/points that stopped fitting

The reference expresses the loop as ``fori_loop`` + ``lax.cond``; here it
is a host loop whose two branches (does the step need work, did PnP
succeed) each cost one device->host read. Track structure is
data-independent: membership is pure masking over the padded (P, T)
observation tensors.

``map_cluster_batch`` runs C clusters of one shape as lanes of one loop
(the reference's ``jax.vmap`` of the single-cluster program): every
tensor operation, kernel 2 and PnP take all lanes at once, each lane runs
its own schedule, and a lane that does not need a step, or whose PnP
fails, keeps its state. The two branch reads of a step cover all lanes.
One cluster alone is the batch of one.
"""

from __future__ import annotations

import torch

from scanner_colmap_tpu_torch.models import geometry as geom
from scanner_colmap_tpu_torch.ops import ba, pnp
from scanner_colmap_tpu_torch.ops.linalg3 import det33, solve33
from scanner_colmap_tpu_torch.utils.metrics import count, span

NUM_CAM_IN_TIED = 23


def _obs_errors(cam, xyz, obs_cam, obs_uv, cc):
    """Pixel reprojection error (P, T) and camera-frame depth under cam
    rows [qvec(4), tvec(3), log_f, k1]."""
    ci = obs_cam.long()
    q = cam[ci, 0:4]
    t = cam[ci, 4:7]
    f = torch.exp(cam[ci, 7])
    k1 = cam[ci, 8]
    xc = geom.quat_rotate(q, xyz[:, None, :]) + t
    z = xc[..., 2]
    tiny = torch.where(z < 0, -1e-8, 1e-8).to(z.dtype)
    zs = torch.where(torch.abs(z) < 1e-8, tiny, z)
    xn = xc[..., :2] / zs[..., None]
    r2 = torch.sum(xn * xn, dim=-1)
    proj = f[..., None] * xn * (1.0 + k1[..., None] * r2[..., None]) + cc[ci]
    return torch.linalg.norm(proj - obs_uv, dim=-1), z


def _triangulate_all(cam, registered, obs_cam, obs_xn, obs_present,
                     tri_thr_n, min_tri_angle):
    """Masked inhomogeneous multi-view DLT for every track at once (closed
    form 3x3 normal equations). Returns (xyz (P,3), ok (P,), view_ok (P,T))."""
    ci = obs_cam.long()
    R = geom.quat_to_rotmat(cam[ci, 0:4])
    t = cam[ci, 4:7]
    m = (obs_present & registered[ci]).to(cam.dtype)
    u = obs_xn[..., 0]
    v = obs_xn[..., 1]
    r1 = u[..., None] * R[..., 2, :] - R[..., 0, :]
    r2 = v[..., None] * R[..., 2, :] - R[..., 1, :]
    b1 = -(u * t[..., 2] - t[..., 0])
    b2 = -(v * t[..., 2] - t[..., 1])
    A = torch.cat([r1 * m[..., None], r2 * m[..., None]], dim=1)
    bb = torch.cat([b1 * m, b2 * m], dim=1)
    AtA = torch.einsum("pki,pkj->pij", A, A)
    Atb = torch.einsum("pki,pk->pi", A, bb)
    eye3 = torch.eye(3, dtype=A.dtype, device=A.device)
    xyz = solve33(AtA + 1e-12 * eye3, Atb)
    nondegen = torch.abs(det33(AtA)) > 1e-12

    xc = torch.einsum("ptij,pj->pti", R, xyz) + t
    z = xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    err_n = torch.linalg.norm(xc[..., :2] / zs[..., None] - obs_xn, dim=-1)
    view_ok = (m > 0) & (z > 1e-6) & (err_n < tri_thr_n[:, None])

    centers = -torch.einsum("ptji,ptj->pti", R, t)
    rays = centers - xyz[:, None, :]
    rn = rays / torch.clamp(torch.linalg.norm(rays, dim=-1, keepdim=True), min=1e-12)
    cosang = torch.einsum("pti,psi->pts", rn, rn)
    pair_ok = view_ok[:, :, None] & view_ok[:, None, :]
    ang = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
    max_ang = torch.amax(torch.where(pair_ok, ang, torch.zeros_like(ang)), dim=(1, 2))
    ok = nondegen & (view_ok.sum(-1) >= 2) & (max_ang >= min_tri_angle)
    return xyz, ok, view_ok


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """RANSAC draws keyed by (cluster seed, schedule step): independent of
    every other step and cluster."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) << 24) + 0x5F3D00 + int(step))
    return gen


def map_cluster_batch(seeds, cam_in, order, forced, reg_init, obs_cam, obs_uv,
                      obs_xn, obs_present, pnp_thr_n, tri_thr_n, scal,
                      pnp_trials: int = 256, ba_iters: int = 8,
                      final_iters: int = 40) -> torch.Tensor:
    """Run C clusters of one shape as lanes, each lane one cluster's
    incremental reconstruction (inputs as the reference's
    ``_map_cluster_impl`` with a leading lane axis: cam_in (C, M, W),
    order (C, S), obs_cam (C, P, T), ...; int32 order/obs_cam, the rest
    f32), ``seeds`` one per lane. The lanes share ``scal`` (one
    MapperConfig). A lane's PnP draws are its own (``step_generator`` of
    its seed), and its arithmetic differs from a one-lane run's only in
    the order of a few sums (kernel 2's split, the batched Cholesky).

    Returns flat f32 rows (C, M*9 + P*3 + P + P*T + M + 4), one a lane:
      [cam (M,9) | xyz (P,3) | pt_valid (P) | obs_ok (P,T) | registered (M)
       | stats (n_registered, n_points, mean_err_px, n_obs)]"""
    C, M = cam_in.shape[:2]
    P, T = obs_cam.shape[1:]
    S = order.shape[1]
    f32 = cam_in.dtype
    dev = cam_in.device
    if C > 1:
        count("host_reads")
        if not torch.equal(scal, scal[:1].expand_as(scal)):
            raise ValueError("the lanes of a batch share the mapper's scalars (scal)")

    lanes = ba.Lanes.of(obs_cam, M)
    lane = torch.arange(C, device=dev)
    cam_flat = cam_in.reshape(C * M, -1)
    cc = cam_flat[:, 9:11]
    cam_valid_in = cam_flat[:, 11] > 0.5
    pose_free = cam_flat[:, 12:18]
    cam_group = ((cam_in[..., 22].to(torch.int32)
                  + (lane * M).to(torch.int32)[:, None]).reshape(C * M)
                 if cam_in.shape[2] >= NUM_CAM_IN_TIED else None)
    s0 = scal[0]
    refine_focal = s0[0] > 0.5
    refine_dist = s0[1] > 0.5
    loss_scale = s0[2]
    min_tri_angle = s0[3]
    abs_min_inl = s0[4]
    abs_min_ratio = s0[5]
    filter_px = s0[6]
    # the lanes laid end to end: C*M camera slots, C*P tracks
    obs_g = lanes.cam_idx()
    obs_uv = obs_uv.reshape(C * P, T, 2)
    obs_xn = obs_xn.reshape(C * P, T, 2)
    obs_present_b = (obs_present > 0.5).reshape(C * P, T)
    tri_thr = tri_thr_n.reshape(C * P)
    ci = obs_g.long()

    def ok_mask(cam, xyz, registered, pt_valid):
        err, z = _obs_errors(cam, xyz, obs_g, obs_uv, cc)
        return (obs_present_b & registered[ci] & pt_valid[:, None]
                & (z > 1e-6) & (err < filter_px))

    def run_ba(cam, xyz, registered, pt_valid, iters, active):
        params = ba.BundleParams(qvec=cam[:, 0:4], tvec=cam[:, 4:7],
                                 log_f=cam[:, 7], k1=cam[:, 8], xyz=xyz)
        obs = ba.BundleObs(cam_idx=obs_g, uv=obs_uv,
                           valid=ok_mask(cam, xyz, registered, pt_valid))
        cfgb = ba.BundleConfig(
            cc=cc, cam_valid=cam_valid_in & registered, pose_free=pose_free,
            pt_valid=pt_valid, refine_focal=refine_focal,
            refine_distortion=refine_dist, loss_scale=loss_scale,
            prior_log_f=cam_flat[:, 18], prior_k1=cam_flat[:, 19],
            prior_weight_f=cam_flat[:, 20], prior_weight_k=cam_flat[:, 21],
            cam_group=cam_group)
        with span("mapping.ba"):
            p2 = ba.bundle_adjust_lanes(params, obs, cfgb, lanes, active,
                                        max_iterations=iters)
        cam2 = torch.cat([p2.qvec, p2.tvec, p2.log_f[:, None], p2.k1[:, None]],
                         dim=1).to(f32)
        vm2 = ok_mask(cam2, p2.xyz, registered, pt_valid)
        return cam2, p2.xyz.to(f32), pt_valid & (vm2.sum(1) >= 2)

    def grow_and_refine(cam, xyz, pt_valid, registered, iters, active):
        """Triangulate, then BA, on the lanes with ``active`` (C,) True;
        the other lanes keep their state."""
        with span("mapping.triangulate"):
            xyz_new, new_ok, _ = _triangulate_all(cam, registered, obs_g, obs_xn,
                                                  obs_present_b, tri_thr, min_tri_angle)
        take = (~pt_valid) & new_ok
        xyz2 = torch.where(take[:, None], xyz_new, xyz)
        cam2, xyz2, pt_valid2 = run_ba(cam, xyz2, registered, pt_valid | take, iters,
                                       active)
        am, ap = active.repeat_interleave(M), active.repeat_interleave(P)
        return (torch.where(am[:, None], cam2, cam), torch.where(ap[:, None], xyz2, xyz),
                torch.where(ap, pt_valid2, pt_valid))

    cam = cam_flat[:, 0:9].clone()
    xyz = torch.zeros((C * P, 3), dtype=f32, device=dev)
    pt_valid = torch.zeros((C * P,), dtype=torch.bool, device=dev)
    registered = reg_init.reshape(C * M) > 0.5
    order_h = order.tolist()
    forced_h = (forced > 0.5).tolist()
    count("host_reads", 2)

    for s in range(S):
        imgs = [order_h[c][s] for c in range(C)]
        if max(imgs) < 0:
            continue
        img_c = torch.as_tensor([min(max(i, 0), M - 1) for i in imgs], device=dev)
        slot = lane * M + img_c                  # the step's camera slot per lane
        on = torch.as_tensor([i >= 0 for i in imgs], device=dev)
        frc = torch.as_tensor([forced_h[c][s] for c in range(C)], device=dev)
        # weak-support re-registration (the reference's retry pass): a slot
        # registered on few valid points is re-attempted once the point set
        # has grown; init-pair slots (forced) carry the gauge and are kept
        sees = (obs_g == slot.repeat_interleave(P)[:, None]).view(C, P, T)
        sup = (ok_mask(cam, xyz, registered, pt_valid).view(C, P, T) & sees).sum((1, 2))
        needs = on & (~registered[slot] | ((sup < 3) & ~frc))
        needs_h = needs.tolist()
        count("host_reads")
        if not any(needs_h):
            continue
        ok = needs & frc
        pnp_lanes = [c for c in range(C) if needs_h[c] and not forced_h[c][s]]
        if pnp_lanes:
            # PnP on the lanes that need it (the others draw nothing)
            with span("mapping.pnp"):
                sel = torch.as_tensor(pnp_lanes, device=dev)
                has = (obs_present_b.view(C, P, T) & sees)[sel]
                has_any = has.any(dim=2) & pt_valid.view(C, P)[sel]
                tsel = torch.argmax(has.to(torch.int8), dim=2)
                xn_i = torch.gather(obs_xn.view(C, P, T, 2)[sel], 2,
                                    tsel[..., None, None].expand(-1, -1, 1, 2))[:, :, 0]
                n_corr = has_any.sum(1).to(f32)
                min_inl = torch.minimum(abs_min_inl, torch.clamp(n_corr / 2.0, min=6.0))
                res = pnp.pnp_ransac([step_generator(dev, seeds[c], s) for c in pnp_lanes],
                                     xyz.view(C, P, 3)[sel], xn_i, has_any,
                                     pnp_thr_n[sel, img_c[sel]], min_num_inliers=min_inl,
                                     min_inlier_ratio=0.0, num_trials=pnp_trials)
                ratio_ok = (res.num_inliers.to(f32)
                            >= abs_min_ratio * torch.clamp(n_corr, min=1.0))
                pnp_ok = res.ok & ratio_ok
                ok = ok.clone()
                ok[sel] = pnp_ok
                rows = slot[sel]
                cam[rows, 0:4] = torch.where(pnp_ok[:, None], res.qvec.to(f32),
                                             cam[rows, 0:4])
                cam[rows, 4:7] = torch.where(pnp_ok[:, None], res.tvec.to(f32),
                                             cam[rows, 4:7])
                ok_h = ok.tolist()
                count("host_reads")
        else:
            ok_h = [bool(n and f) for n, f in zip(needs_h, (forced_h[c][s] for c in range(C)))]
        if any(ok_h):
            registered = registered.clone()
            registered[slot] = registered[slot] | ok
            cam, xyz, pt_valid = grow_and_refine(cam, xyz, pt_valid, registered,
                                                 ba_iters, ok)

    every = torch.ones(C, dtype=torch.bool, device=dev)
    for _ in range(2):
        cam, xyz, pt_valid = grow_and_refine(cam, xyz, pt_valid, registered,
                                             final_iters, every)

    vmask = ok_mask(cam, xyz, registered, pt_valid)
    pt_valid = pt_valid & (vmask.sum(1) >= 2)
    vmask = vmask & pt_valid[:, None]
    err, _ = _obs_errors(cam, xyz, obs_g, obs_uv, cc)
    n_obs = vmask.view(C, -1).sum(1)
    mean_err = (torch.where(vmask, err, torch.zeros_like(err)).view(C, -1).sum(1)
                / torch.clamp(n_obs, min=1))
    stats = torch.stack([(registered & cam_valid_in).view(C, M).sum(1).to(f32),
                         pt_valid.view(C, P).sum(1).to(f32), mean_err.to(f32),
                         n_obs.to(f32)], dim=1)
    return torch.cat([cam.reshape(C, M * 9), xyz.reshape(C, P * 3),
                      pt_valid.to(f32).view(C, P), vmask.to(f32).reshape(C, P * T),
                      registered.to(f32).view(C, M), stats], dim=1)
