"""The benchmark's copy of the port's blob-field generator
(``scanner_colmap_tpu_torch/pipeline/synth.py``: ``render_dataset``,
``render_blob_frames``, ``_camera_exif``), frozen here so that a change to
the program cannot move the traffic.

A scene is a wall of Gaussian-blob constellations on an undulating surface
z(x, y), seen from a translating, yawing camera track. ``make_scene`` draws
it from the seed with the same random stream as ``synth.render_dataset``;
``blob_size_scale`` (1 in the synth generator) scales every blob's size, so
that a configuration can set the scene's density in blob count and size.
``render_frames`` is the plain numpy renderer; ``render_torch`` renders
the same frames on the card. Everything here is numpy, Pillow (for the
JPEGs) and the standard library: it imports no part of the program.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# quaternion helpers (wxyz, the world-to-camera rotation)
# ---------------------------------------------------------------------------

def angle_axis_to_quat(aa):
    aa = np.asarray(aa, np.float64)
    sq = np.sum(aa * aa, axis=-1, keepdims=True)
    angle = np.sqrt(sq + 1e-24)
    half = 0.5 * angle
    k = np.sin(half) / angle
    return np.concatenate([np.cos(half), aa * k], axis=-1)


def quat_rotate(q, v):
    q = np.asarray(q)
    v = np.asarray(v)
    qv = q[..., 1:]
    uv = np.cross(qv, v)
    uuv = np.cross(qv, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def pose_transform(q, t, pts):
    return quat_rotate(q, pts) + t


def surface_z(x, y, depth0, depth_spread):
    """The scene's analytic surface."""
    return depth0 + depth_spread * (
        0.5 * np.sin(0.45 * x) * np.cos(0.35 * y) + 0.25 * np.sin(0.9 * y))


def make_scene(num_images: int, seed: int, num_blobs: int, depth0: float = 8.0,
               depth_spread: float = 2.5, track: str = "arc",
               blob_size_scale: float = 1.0) -> dict:
    """The blob field and the camera track: ``synth.render_dataset``'s
    random stream and geometry. Returns a dict with the sub-blobs (pts,
    sizes, amps, signs), the poses (qvecs, tvecs: world to camera), the
    constellation centres and the surface's parameters."""
    rng = np.random.default_rng(seed)
    step = 0.055 * depth0
    n_span = max(num_images - 1, 1)
    if track == "out_and_back":
        n_span = max((num_images - 1) / 2.0, 1.0)
    track_half = 0.5 * step * n_span
    span = track_half + 0.9 * depth0
    num_blobs = int(num_blobs * span / (0.9 * depth0))
    cx_ = rng.uniform(-span, span, num_blobs)
    cy_ = rng.uniform(-depth0 * 0.675, depth0 * 0.675, num_blobs)
    centers = np.stack([cx_, cy_, surface_z(cx_, cy_, depth0, depth_spread)], axis=1)
    sub_pts, sub_sizes, sub_amps = [], [], []
    for c in centers:
        k = rng.integers(2, 5)
        offs = np.zeros((k, 3))
        offs[1:, :2] = rng.uniform(-0.12, 0.12, size=(k - 1, 2)) * depth0 / 8.0
        amp0 = rng.uniform(0.5, 1.0)
        for m in range(k):
            p = c + offs[m]
            p[2] = surface_z(p[0], p[1], depth0, depth_spread)
            sub_pts.append(p)
            sub_sizes.append(rng.uniform(3.0, 7.0) if m == 0
                             else rng.uniform(1.8, 4.0))
            sub_amps.append(amp0 if m == 0
                            else rng.uniform(0.3, 0.9) * rng.choice([-1.0, 1.0]))
    amps = np.asarray(sub_amps)

    qs, ts = [], []
    for i in range(num_images):
        u = i / max(num_images - 1, 1)
        if track == "out_and_back":
            u2 = 2.0 * u
            frac = (u2 if u2 <= 1.0 else 2.0 - u2) - 0.5
            yaw = -frac * 0.5 + 0.03 * np.sin(u2 * 2.3)
            bob = 0.15 * np.sin(u2 * 3.7)
        else:
            frac = u - 0.5
            yaw = -frac * 0.5
            bob = 0.15 * np.sin(frac * 6)
        q = angle_axis_to_quat(np.array([0.0, yaw, 0.0]))
        C = np.array([frac * 2 * track_half, bob, 0.0])
        qs.append(q)
        ts.append(-np.asarray(quat_rotate(q, C)))
    return {"pts": np.asarray(sub_pts), "sizes": np.asarray(sub_sizes) * blob_size_scale,
            "amps": np.abs(amps), "signs": np.sign(amps),
            "qvecs": np.asarray(qs), "tvecs": np.asarray(ts), "centers": centers,
            "depth0": float(depth0), "depth_spread": float(depth_spread)}


def project_blobs(scene: dict, i: int, width: int, height: int, focal: float):
    """Frame i's view of the sub-blobs: (u, v, s, candidate mask), as
    ``synth.render_blob_frames`` computes them (s already clamped at 1.2)."""
    x_cam = np.asarray(pose_transform(scene["qvecs"][i], scene["tvecs"][i], scene["pts"]))
    vis = x_cam[:, 2] > 1.0
    z = np.where(vis, x_cam[:, 2], 1.0)
    u = focal * x_cam[:, 0] / z + width / 2.0
    v = focal * x_cam[:, 1] / z + height / 2.0
    s_px = scene["sizes"] * focal / z / 40.0
    cand = vis & (u >= -20) & (u <= width + 20) & (v >= -20) & (v <= height + 20)
    return u, v, np.maximum(s_px, 1.2), cand


def render_frames(scene: dict, width: int, height: int, focal: float):
    """The plain renderer: ``synth.render_blob_frames``, blob by blob in
    float64. Returns a list of (height, width) uint8 frames."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    frames = []
    for i in range(len(scene["qvecs"])):
        u, v, s_all, cand = project_blobs(scene, i, width, height, focal)
        img = np.full((height, width), 0.15)
        for b in np.nonzero(cand)[0]:
            s = s_all[b]
            r = int(4 * s) + 1
            y0, y1 = max(int(v[b]) - r, 0), min(int(v[b]) + r + 1, height)
            x0, x1 = max(int(u[b]) - r, 0), min(int(u[b]) + r + 1, width)
            if y1 <= y0 or x1 <= x0:
                continue
            patch = np.exp(-((xx[y0:y1, x0:x1] - u[b]) ** 2
                             + (yy[y0:y1, x0:x1] - v[b]) ** 2) / (2 * s * s))
            img[y0:y1, x0:x1] += scene["signs"][b] * scene["amps"][b] * patch
        frames.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
    return frames


def camera_exif(focal: float, width: int):
    """The EXIF block a real camera writes (``synth._camera_exif``):
    FocalLength (mm) and the FocalPlane resolution tags of a virtual 36 mm
    sensor, plus the integer FocalLengthIn35mmFilm fallback."""
    from PIL import Image as PILImage

    exif = PILImage.Exif()
    exif[0x920A] = round(focal * 36.0 / width, 4)   # FocalLength (mm)
    exif[0xA20E] = round(width / 3.6, 4)            # FocalPlaneXResolution
    exif[0xA210] = 3                                # unit: cm
    exif[0xA002] = width                            # ExifImageWidth
    exif[0xA405] = int(round(focal * 36.0 / width))  # FocalLengthIn35mmFilm
    return exif


def write_jpegs(out_dir: str, frames, focal: float, width: int, quality: int = 95,
                workers: int = 4):
    """Frames as EXIF-tagged RGB JPEGs image_0000.jpg, ... (a grayscale
    frame written as RGB, as the synth generator writes it), ``workers``
    at a time (Pillow encodes without the interpreter lock)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image as PILImage

    exif = camera_exif(focal, width)

    def write(i):
        PILImage.fromarray(frames[i], "L").convert("RGB").save(
            os.path.join(out_dir, f"image_{i:04d}.jpg"), quality=quality, exif=exif)

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(write, range(len(frames))))
