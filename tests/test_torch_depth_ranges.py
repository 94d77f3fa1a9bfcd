"""The depth ranges of the port's ``run_prepare_patch_match``, on the CPU.

A store written directly (tiny in-memory frames, an extraction table with
the cameras, a ``models`` table) holds four registered images with a few
hundred observations each: ids of -1, ids missing from ``points3D``,
points behind the camera, and one image with fewer than 5 points in
front. The stage's ``depth_min``/``depth_max`` are held bitwise
(``np.array_equal``) to the per-point formula, and its
``prepare_patch_match.depth_points`` counter to the points in front.
"""

import numpy as np
import pytest

from scanner_colmap_tpu_torch.models import cameras as camlib
from scanner_colmap_tpu_torch.models import geometry as geom
from scanner_colmap_tpu_torch.models.reconstruction import (Camera, Image, Point3D,
                                                               Reconstruction)
from scanner_colmap_tpu_torch.pipeline import ArtifactStore, PipelineConfig
from scanner_colmap_tpu_torch.pipeline import stages as tstages
from scanner_colmap_tpu_torch.utils import colmap_io
from scanner_colmap_tpu_torch.utils import metrics as tmetrics

WIDTH, HEIGHT, N_OBS, N_POINTS = 32, 24, 400, 600
SPARSE = 3      # the image with fewer than 5 points in front


def random_model(seed):
    """Four registered images over ``N_POINTS`` points; of each image's
    ``N_OBS`` keypoints about a quarter are unobserved (-1) and a tenth
    name ids that ``points3D`` lacks. Points straddle the cameras' planes,
    so many lie behind; image ``SPARSE`` sees 3 points in front."""
    rng = np.random.default_rng(seed)
    rec = Reconstruction()
    rec.add_camera(Camera(1, camlib.SIMPLE_RADIAL, WIDTH, HEIGHT,
                          np.array([30.0, WIDTH / 2, HEIGHT / 2, 0.0]), True))
    xyz = rng.normal(0.0, 3.0, (N_POINTS, 3))
    pids = rng.choice(10 ** 6, N_POINTS, replace=False)
    missing = pids.max() + 1 + np.arange(50)
    for i in range(4):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        t = rng.normal(0.0, 1.0, 3)
        ids = rng.choice(pids, N_OBS)
        ids[rng.random(N_OBS) < 0.25] = -1
        lost = rng.random(N_OBS) < 0.1
        ids[lost] = rng.choice(missing, int(lost.sum()))
        if i == SPARSE:
            z = geom.np_pose_transform(q, t, xyz)[:, 2]
            front = pids[z > 0][:3]
            ids = np.where(np.isin(ids, pids[z > 0]), -1, ids)
            ids[rng.choice(N_OBS, 3, replace=False)] = front
        rec.add_image(Image(i, 1, f"image_{i:04d}.png", q, t,
                            rng.uniform(0, WIDTH, (N_OBS, 2)), ids.astype(np.int64),
                            registered=True))
    rec.points3D = {int(p): Point3D(x, np.zeros(3, np.uint8), -1.0, [])
                    for p, x in zip(pids, xyz)}
    return rec


def reference_depths(model, im):
    """The per-point formula: each observed point present in ``points3D``
    transformed alone, its depth kept where it is in front."""
    depths = []
    for pid in im.point3D_ids:
        if pid >= 0 and int(pid) in model.points3D:
            x_cam = geom.np_pose_transform(im.qvec, im.tvec, model.points3D[int(pid)].xyz)
            if x_cam[2] > 0:
                depths.append(x_cam[2])
    return np.asarray(depths)


def write_store(root, model):
    store = ArtifactStore(root)
    cfg = PipelineConfig(store_path=root)
    cfg.patch_match.max_image_size = WIDTH     # a small canvas for the bitmaps
    rng = np.random.default_rng(0)
    tstages.prepare_images(cfg, store, frames=[
        (rng.integers(0, 256, (HEIGHT, WIDTH), dtype=np.uint8), 30.0) for _ in model.images])
    cam = model.cameras[1]
    n = len(model.images)
    store.write_table("extraction", {
        "image_id": np.arange(n, dtype=np.int64),
        "keypoints": [np.zeros((0, 4), np.float32)] * n,
        "descriptors": [np.zeros((0, 128), np.uint8)] * n,
        "camera": np.stack([np.concatenate([[cam.model_id, WIDTH, HEIGHT, 1.0, 1.0],
                                            cam.params])] * n),
    }, meta={"stage": "extraction"})
    cb, ib, pb = colmap_io.model_to_bytes(model)
    store.write_table("models", {"model_id": np.zeros(1, np.int64), "cameras": [cb],
                                 "images": [ib], "points3d": [pb]}, meta={"stage": "merge"})
    return cfg, store


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_depth_ranges_bitwise_the_per_point_formula(tmp_path, seed):
    cfg, store = write_store(str(tmp_path / "store"), random_model(seed))
    model = tstages.load_model(store)     # the model as the stage reads it
    ims = [model.images[i] for i in sorted(model.registered_image_ids)]
    assert all(len(im.point3D_ids) == N_OBS for im in ims)
    assert all((im.point3D_ids == -1).any() for im in ims)
    assert all(any(int(p) >= 0 and int(p) not in model.points3D for p in im.point3D_ids)
               for im in ims)
    ref = {im.image_id: reference_depths(model, im) for im in ims}
    behind = [sum(int(p) in model.points3D for p in im.point3D_ids) - len(ref[im.image_id])
              for im in ims]
    assert all(b > 0 for b in behind) and len(ref[SPARSE]) == 3

    assert tstages.run_prepare_patch_match(cfg, store) == 3
    tab = store.read_table("prepare_patch_match")
    kept = [i for i in sorted(ref) if len(ref[i]) >= 5]
    assert SPARSE not in kept and tab["image_id"].tolist() == kept
    pm = cfg.patch_match
    assert np.array_equal(tab["depth_min"], np.array(
        [float(np.percentile(ref[i], 2) * pm.depth_min_factor) for i in kept]))
    assert np.array_equal(tab["depth_max"], np.array(
        [float(np.percentile(ref[i], 98) * pm.depth_max_factor) for i in kept]))


def test_depth_points_counts_the_points_in_front(tmp_path):
    cfg, store = write_store(str(tmp_path / "store"), random_model(5))
    model = tstages.load_model(store)
    in_front = sum(len(reference_depths(model, model.images[i]))
                   for i in model.registered_image_ids)
    was = tmetrics.set_tracing(True)
    tmetrics.GLOBAL_METRICS.reset()
    try:
        assert tstages.run_prepare_patch_match(cfg, store) == 3
        run = tmetrics.GLOBAL_METRICS.stage(tmetrics.RUN)
    finally:
        tmetrics.set_tracing(was)
        tmetrics.GLOBAL_METRICS.reset()
    assert run["count.prepare_patch_match.depth_points"] == in_front
    assert run["span.prepare_patch_match.depth_ranges.n"] == 4
