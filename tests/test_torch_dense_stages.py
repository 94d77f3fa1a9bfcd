"""The port's dense stages against the JAX package's, on one store, on the
CPU.

The store (built as tests/test_meshing.py:116 builds its own: tables
written directly) holds 4 synthetic 160x120 JPEGs of the real-texture
scene (a photograph on a relief, ``synth.generate_real_texture_dataset``),
an extraction table with their cameras, and a merged model made from the
ground truth (its 3D points lie on the scene's surface, observed where
they project into an image). The dense stages run at 96 px with 2
sources, 3 sweeps and radius 3.

- ``run_prepare_patch_match``: the port's table equals the JAX table.
- ``run_undistort``: the same pinhole parameters; the PNGs within one
  8-bit level on every pixel (f32 rounding before the uint8 cast).
- fusion and meshing of the port on the JAX stage's ``patch_match`` table:
  the fused count equal and xyz within 1e-5; the mesh's face count equal
  and its vertices within 1e-5.
- the port's ``run_patch_match`` (coarse to fine): the fused cloud's
  median surface error within the JAX stage's on the same store + 0.01.
- the port writes f32 maps; the same maps rounded through f16 (as the JAX
  stage writes them) fuse to within 1% of the count.
- a geometric pass with row-band tiling, as a ``ref_slice`` run and a full
  run: the slice's core maps are bitwise the full run's.
- test_meshing.py's stage cases on the port.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from test_mvs import _plane_fusion_input

from scanner_colmap_tpu.pipeline import stages as jstages
from scanner_colmap_tpu.utils.config import PipelineConfig as JConfig
from scanner_colmap_tpu.utils.store import ArtifactStore as JStore
from scanner_colmap_tpu_torch.models import cameras as camlib
from scanner_colmap_tpu_torch.models import geometry as geom
from scanner_colmap_tpu_torch.models.reconstruction import Camera, Image, Reconstruction
from scanner_colmap_tpu_torch.pipeline import ArtifactStore, PipelineConfig, synth
from scanner_colmap_tpu_torch.pipeline import stages as tstages
from scanner_colmap_tpu_torch.utils import colmap_io
from scanner_colmap_tpu_torch.utils import metrics as tmetrics

CPU = torch.device("cpu")
N_IMAGES, WIDTH, HEIGHT = 4, 160, 120


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: the tier-1 run has six
    workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dense_config(cfg):
    pm = cfg.patch_match
    pm.max_image_size, pm.overlap, pm.num_iterations = 96, 2, 3
    pm.fine_iterations, pm.window_radius, pm.sigma_spatial = 1, 3, 2.0
    cfg.meshing.resolution = 32
    return cfg


def gt_model(gt):
    """A merged model from the ground truth: points on a grid over the
    surface, each observed where it lies in front of a camera and inside
    its frame."""
    rec = Reconstruction()
    f = gt["focal"]
    rec.add_camera(Camera(1, camlib.SIMPLE_RADIAL, WIDTH, HEIGHT,
                          np.array([f, WIDTH / 2, HEIGHT / 2, 0.0]), True))
    x, y = np.meshgrid(np.linspace(-2.0, 2.0, 21), np.linspace(-1.5, 1.5, 15))
    x, y = x.ravel(), y.ravel()
    pts = np.stack([x, y, synth.gt_surface_z(gt, x, y)], axis=1)
    for i in range(N_IMAGES):
        q, t = np.asarray(gt["qvecs"][i]), np.asarray(gt["tvecs"][i])
        x = geom.np_pose_transform(q, t, pts)
        uv = f * x[:, :2] / x[:, 2:] + np.array([WIDTH / 2, HEIGHT / 2])
        rec.add_image(Image(i, 1, f"image_{i:04d}.jpg", q, t, uv,
                            np.full(len(pts), -1, np.int64), registered=True))
    for p in range(len(pts)):
        track = []
        for i in range(N_IMAGES):
            u, v = rec.images[i].xys[p]
            x = geom.np_pose_transform(rec.images[i].qvec, rec.images[i].tvec, pts[p][None])[0]
            if x[2] > 0 and 0 <= u < WIDTH and 0 <= v < HEIGHT:
                track.append((i, p))
        if track:
            rec.add_point3D(pts[p], track)
    return rec


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """(store root, gt, model): frames, extraction and models tables."""
    root = str(tmp_path_factory.mktemp("dense") / "store")
    img_dir = os.path.join(os.path.dirname(root), "images")
    gt = synth.generate_real_texture_dataset(img_dir, num_images=N_IMAGES, width=WIDTH,
                                             height=HEIGHT, focal=150.0, seed=1, num_bumps=2)
    gt = {**gt, "qvecs": np.asarray(gt["qvecs"]), "tvecs": np.asarray(gt["tvecs"])}
    cfg = PipelineConfig(image_path=img_dir, store_path=root)
    store = ArtifactStore(root)
    tstages.prepare_images(cfg, store)
    model = gt_model(gt)
    cam = model.cameras[1]
    store.write_table("extraction", {
        "image_id": np.arange(N_IMAGES, dtype=np.int64),
        "keypoints": [np.zeros((0, 4), np.float32)] * N_IMAGES,
        "descriptors": [np.zeros((0, 128), np.uint8)] * N_IMAGES,
        "camera": np.stack([np.concatenate([[cam.model_id, WIDTH, HEIGHT, 1.0, 1.0],
                                            cam.params])] * N_IMAGES),
    }, meta={"stage": "extraction"})
    cb, ib, pb = colmap_io.model_to_bytes(model)
    store.write_table("models", {"model_id": np.zeros(1, np.int64), "cameras": [cb],
                                 "images": [ib], "points3d": [pb]}, meta={"stage": "merge"})
    return root, gt, model


def copy_store(src, dst, tables):
    os.makedirs(dst, exist_ok=True)
    for t in tables:
        shutil.copytree(os.path.join(src, t), os.path.join(dst, t))
    return dst


@pytest.fixture(scope="module")
def jax_dense(base, tmp_path_factory):
    """The JAX stages' prepare, patch_match and fusion tables on the store."""
    root = copy_store(base[0], str(tmp_path_factory.mktemp("jax") / "store"),
                      ("frames", "extraction", "models"))
    cfg = dense_config(JConfig(store_path=root))
    store = JStore(root)
    jstages.run_prepare_patch_match(cfg, store)
    jstages.run_patch_match(cfg, store)
    jstages.run_fusion(cfg, store)
    jstages.run_meshing(cfg, store)
    return root


@pytest.fixture(scope="module")
def port_dense(base, tmp_path_factory):
    """The port's prepare and patch_match tables on the store."""
    root = copy_store(base[0], str(tmp_path_factory.mktemp("port") / "store"),
                      ("frames", "extraction", "models"))
    cfg = dense_config(PipelineConfig(store_path=root))
    store = ArtifactStore(root)
    tstages.run_prepare_patch_match(cfg, store)
    tstages.run_patch_match(cfg, store, device=CPU)
    return root


def test_prepare_tables_equal(jax_dense, port_dense):
    a = JStore(jax_dense).read_table("prepare_patch_match")
    b = ArtifactStore(port_dense).read_table("prepare_patch_match")
    assert set(a) == set(b) and len(a["image_id"]) == N_IMAGES
    for k in a:
        if k == "bitmap":
            for x, y in zip(a[k], b[k]):
                assert np.asarray(x).dtype == np.asarray(y).dtype
                assert np.array_equal(np.asarray(x), np.asarray(y))
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_undistort_matches_jax(base, tmp_path):
    roots = [copy_store(base[0], str(tmp_path / n), ("frames", "extraction", "models"))
             for n in ("j", "t")]
    assert jstages.run_undistort(JConfig(store_path=roots[0]), JStore(roots[0])) == N_IMAGES
    assert tstages.run_undistort(PipelineConfig(store_path=roots[1]), ArtifactStore(roots[1]),
                                 device=CPU) == N_IMAGES
    from PIL import Image as PILImage

    a = JStore(roots[0]).read_table("undistorted")
    b = ArtifactStore(roots[1]).read_table("undistorted")
    assert np.array_equal(a["image_id"], b["image_id"])
    assert np.array_equal(a["new_params"], b["new_params"])
    for pa, pb in zip(a["path"], b["path"]):
        ia = np.asarray(PILImage.open(pa.decode()), np.int16)
        ib = np.asarray(PILImage.open(pb.decode()), np.int16)
        assert ia.shape == ib.shape == (HEIGHT, WIDTH)
        assert np.abs(ia - ib).max() <= 1
    from scanner_colmap_tpu.utils import colmap_io as jio

    ma = jio.read_model(os.path.join(roots[0], "undistort_ws", "sparse"))
    mb = jio.read_model(os.path.join(roots[1], "undistort_ws", "sparse"))
    assert mb.cameras[1].model_id == camlib.PINHOLE
    assert np.array_equal(ma.cameras[1].params, mb.cameras[1].params)


def test_fusion_and_meshing_on_the_jax_patch_match_table(jax_dense, tmp_path):
    root = copy_store(jax_dense, str(tmp_path / "store"),
                      ("frames", "extraction", "models", "prepare_patch_match", "patch_match"))
    cfg = dense_config(PipelineConfig(store_path=root))
    store = ArtifactStore(root)
    n = tstages.run_fusion(cfg, store, device=CPU)
    a = JStore(jax_dense).read_table("fused")
    b = store.read_table("fused")
    assert n == len(a["xyz"]) > 100
    np.testing.assert_allclose(b["xyz"], a["xyz"], atol=1e-5)
    assert np.array_equal(b["num_consistent"], a["num_consistent"])
    assert np.array_equal(b["visibility"], a["visibility"])
    assert np.abs(b["rgb"].astype(int) - a["rgb"].astype(int)).max() <= 1
    faces = tstages.run_meshing(cfg, store, device=CPU)
    ma, mb = JStore(jax_dense).read_table("mesh"), store.read_table("mesh")
    assert faces == len(ma["faces"][0]) > 100
    np.testing.assert_allclose(mb["verts"][0], ma["verts"][0], atol=1e-5)
    assert np.array_equal(mb["faces"][0], ma["faces"][0])


def test_port_patch_match_surface_error(base, jax_dense, port_dense, tmp_path):
    _, gt, model = base
    tab = ArtifactStore(port_dense).read_table("patch_match")
    assert len(tab["image_id"]) == N_IMAGES
    for d, nm, c in zip(tab["depth_map"], tab["normal_map"], tab["cost_map"]):
        assert d.dtype == nm.dtype == c.dtype == np.float32
        assert d.shape == (72, 96) and nm.shape == (72, 96, 3)
    root = copy_store(port_dense, str(tmp_path / "store"),
                      ("frames", "extraction", "models", "prepare_patch_match", "patch_match"))
    cfg = dense_config(PipelineConfig(store_path=root))
    assert tstages.run_fusion(cfg, ArtifactStore(root), device=CPU) > 100
    port = synth.evaluate_dense(model, gt, ArtifactStore(root).read_table("fused")["xyz"])
    ref = synth.evaluate_dense(model, gt, JStore(jax_dense).read_table("fused")["xyz"])
    assert port["median_rel"] <= ref["median_rel"] + 0.01, (port, ref)


def test_f16_maps_fuse_like_f32(port_dense, tmp_path):
    """The divergence the port keeps: f32 maps, where the JAX stage writes
    depth, two normal components and cost through f16."""
    counts = []
    for name in ("f32", "f16"):
        root = copy_store(port_dense, str(tmp_path / name),
                          ("frames", "extraction", "models", "prepare_patch_match",
                           "patch_match"))
        store = ArtifactStore(root)
        if name == "f16":
            tab = store.read_table("patch_match")
            normals = []
            for nm in tab["normal_map"]:
                nx, ny = (nm[..., k].astype(np.float16).astype(np.float32) for k in (0, 1))
                nz = -np.sqrt(np.maximum(1.0 - nx ** 2 - ny ** 2, 0.0))
                normals.append(np.stack([nx, ny, nz], -1))
            store.write_table("patch_match", {
                "image_id": tab["image_id"],
                "depth_map": [d.astype(np.float16).astype(np.float32) for d in tab["depth_map"]],
                "normal_map": normals,
                "cost_map": [c.astype(np.float16).astype(np.float32) for c in tab["cost_map"]],
            }, meta={"stage": "patch_match"})
        counts.append(tstages.run_fusion(dense_config(PipelineConfig(store_path=root)), store,
                                         device=CPU))
    assert counts[0] > 100 and abs(counts[1] - counts[0]) <= 0.01 * counts[0], counts


def test_ref_slice_core_is_bitwise_the_full_run(port_dense):
    """One pass and a geometric pass, over row bands, as the full run and
    as the second of two slices (its halo recomputed)."""
    cfg = dense_config(PipelineConfig(store_path=port_dense))
    pm = cfg.patch_match
    pm.geom_consistency, pm.coarse_to_fine, pm.num_iterations = True, False, 1
    pm.window_radius, pm.tile_rows, pm.tile_halo = 2, 48, 8
    store = ArtifactStore(port_dense)
    assert tstages.run_patch_match(cfg, store, out_table="pm_full", device=CPU) == N_IMAGES
    assert tstages.run_patch_match(cfg, store, ref_slice=(1, 2), out_table="pm_slice",
                                   device=CPU) == 2
    full, part = store.read_table("pm_full"), store.read_table("pm_slice")
    assert list(part["image_id"]) == [2, 3]
    for k in ("depth_map", "normal_map", "cost_map"):
        for n, iid in enumerate(part["image_id"]):
            assert np.array_equal(part[k][n], full[k][int(iid)]), (k, iid)
    # the geometric pass's costs carry the geometric term's range
    assert max(float(c.max()) for c in full["cost_map"]) <= np.float32(2.0 + 0.3 * 3.0)


def test_run_meshing_stage_on_written_tables(tmp_path):
    """test_meshing.py::test_run_meshing_stage on the port."""
    inp = _plane_fusion_input(5, H=24, W=32, depth0=4.0)
    store = ArtifactStore(str(tmp_path / "store"))
    n = inp.depths.shape[0]
    store.write_table("patch_match", {
        "image_id": np.arange(n, dtype=np.int64),
        "depth_map": [np.asarray(inp.depths[i], np.float32) for i in range(n)],
        "normal_map": [np.asarray(inp.normals[i], np.float32) for i in range(n)],
        "cost_map": [np.zeros(inp.depths[i].shape, np.float32) for i in range(n)]})
    Rs = [geom.np_quat_to_rotmat(np.asarray(inp.qvecs[i])).reshape(-1) for i in range(n)]
    store.write_table("prepare_patch_match", {
        "image_id": np.arange(n, dtype=np.int64), "R": np.stack(Rs),
        "T": np.stack([np.asarray(inp.tvecs[i], np.float64) for i in range(n)]),
        "K": np.stack([np.asarray(inp.Ks[i]).reshape(-1) for i in range(n)]),
        "bitmap": [np.full(inp.depths[i].shape, 128, np.uint8) for i in range(n)]})
    rng = np.random.default_rng(0)
    store.write_table("fused", {"xyz": np.stack([
        rng.uniform(-1.5, 2.0, 400), rng.uniform(-1.2, 1.2, 400),
        np.full(400, 4.0)], axis=1).astype(np.float32)})
    cfg = PipelineConfig(store_path=str(tmp_path / "store"))
    cfg.meshing.resolution = 48
    mesh_path = str(tmp_path / "mesh.ply")
    was = tmetrics.set_tracing(True)     # the TSDF's time: the meshing.tsdf span
    tmetrics.GLOBAL_METRICS.reset()
    try:
        nfaces = tstages.run_meshing(cfg, store, mesh_path=mesh_path, device=CPU)
        spans = tmetrics.GLOBAL_METRICS.stage(tmetrics.RUN)
    finally:
        tmetrics.set_tracing(was)
        tmetrics.GLOBAL_METRICS.reset()
    assert nfaces > 100
    verts = np.asarray(store.read_table("mesh")["verts"][0])
    assert np.abs(verts[:, 2] - 4.0).max() < 0.1 and os.path.exists(mesh_path)
    meta = store.read_manifest("mesh")["meta"]
    assert meta["stage"] == "meshing"
    assert spans["span.meshing.tsdf.n"] == 1 and spans["span.meshing.tsdf.s"] >= 0


def test_dense_stages_on_an_empty_store(tmp_path):
    store = ArtifactStore(str(tmp_path / "store"))
    cfg = PipelineConfig(store_path=str(tmp_path / "store"))
    store.write_table("prepare_patch_match", {"image_id": np.zeros(0, np.int64)})
    assert tstages.run_patch_match(cfg, store, device=CPU) == 0
    assert tstages.run_fusion(cfg, store, device=CPU) == 0
    assert tstages.run_meshing(cfg, store, device=CPU) == 0
    assert len(store.read_table("mesh")["verts"][0]) == 0
