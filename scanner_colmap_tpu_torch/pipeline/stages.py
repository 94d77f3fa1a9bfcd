"""The pipeline stages on torch (port of ``pipeline/stages.py``):

  1 prepare_images          -> frames
  2 run_extraction          -> extraction
  3 run_matching            -> matching
  4 run_mapping             -> mapping (one row per submodel)
  5 run_merge               -> models (+ optional COLMAP export)
  5b run_undistort          -> undistorted (+ a PINHOLE workspace)
  6 run_prepare_patch_match -> prepare_patch_match
  7 run_patch_match         -> patch_match (depth, normal, cost maps)
  8 run_fusion              -> fused (+ optional PLY)
  9 run_meshing             -> mesh (+ optional PLY)

``run_all`` runs them in order (with ``resume``, skipping each stage whose
table exists) and ``load_model`` reads the merged model back;
``import_colmap_db`` and ``export_colmap_db`` exchange the frames,
extraction and matching tables with a COLMAP ``database.db``.

Every stage reads and writes the same ``ArtifactStore`` tables, with the
same columns and byte formats, as the JAX stages, so a stage of either
package can consume the other's output table. Each stage takes a
``device``; ``None`` means the card, and raises where none is visible:
a caller asks for the CPU with ``device="cpu"``.

Matching runs the resident or the banked plan at bf16 or f32 precision,
with loop closure (bag-of-words candidates past the window, decided by a
revisit probe in "auto" mode), then verifies the candidate pairs in chunks
of ``matching.verify_batch_pairs`` through the batched two-view estimator,
and optionally runs the guided pass 16 pairs a call and multiple two-view
models. Mapping runs the device or the host mapper per cluster; the merge
folds any number of submodels and refines the result on the device, with
the matrix-free CG solver past the dense bound. PatchMatch runs kernel 4
(``kernels/plane_cost.py``) once per sweep on the card; fusion's
voting and the TSDF run as tensor operations on the device, marching
tetrahedra on the host.
"""

from __future__ import annotations

import collections
import hashlib
import itertools
import logging
import math
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from scanner_colmap_tpu_torch import device as devlib
from scanner_colmap_tpu_torch.engine import cluster as cluster_lib
from scanner_colmap_tpu_torch.engine.correspondence import make_graph
from scanner_colmap_tpu_torch.engine.merge import (global_refine,
                                                   iterative_global_refinement,
                                                   merge_all)
from scanner_colmap_tpu_torch.models import cameras as camlib
from scanner_colmap_tpu_torch.models import geometry as geom
from scanner_colmap_tpu_torch.models.reconstruction import Reconstruction
from scanner_colmap_tpu_torch.ops import fusion as fusion_ops
from scanner_colmap_tpu_torch.ops import image as image_ops
from scanner_colmap_tpu_torch.ops import matching as matching_ops
from scanner_colmap_tpu_torch.ops import meshing as meshing_ops
from scanner_colmap_tpu_torch.ops import patch_match as pm_ops
from scanner_colmap_tpu_torch.ops import sift as sift_ops
from scanner_colmap_tpu_torch.ops import two_view as tv_ops
from scanner_colmap_tpu_torch.ops import undistort as ud_ops
from scanner_colmap_tpu_torch.utils import colmap_io
from scanner_colmap_tpu_torch.utils import metrics as metrics_lib
from scanner_colmap_tpu_torch.utils.config import PipelineConfig
from scanner_colmap_tpu_torch.utils.metrics import count, span
from scanner_colmap_tpu_torch.utils.store import ArtifactStore

log = logging.getLogger(__name__)

MEMORY_PREFIX = "memory://"


def _round_up(n, m):
    return ((n + m - 1) // m) * m


# ---------------------------------------------------------------------------
# stage 1: prepare_images
# ---------------------------------------------------------------------------

def prepare_images(cfg: PipelineConfig, store: Optional[ArtifactStore] = None,
                   frames: Optional[Sequence] = None, stride: int = 1,
                   frame_range: Optional[tuple] = None) -> int:
    """Ingest the collection; image ids follow the input order.

    With ``frames=None`` the images come from ``cfg.image_path``, as in
    the JAX stage: a directory (sorted listing, then [range], then
    [::stride]), or a video file, whose frames are taken by their absolute
    index (every ``stride``-th within ``frame_range``) and written as PNGs
    under ``<store>/video_frames/`` (``extract_video_frames``). Otherwise ``frames`` is a sequence of in-memory
    ``(pixels, focal_px)`` pairs: pixels is a uint8 (H, W) grayscale or
    (H, W, 3) RGB array, focal_px the focal length in pixels (what the
    directory route reads from EXIF). In-memory frames never touch PIL;
    they are stored as 8-bit grayscale in the frames table and must fit
    ``cfg.sift.max_image_size`` (no resize)."""
    store = store or ArtifactStore(cfg.store_path)
    if frames is None:
        src = cfg.image_path
        if os.path.isfile(src):
            paths = image_ops.list_images(extract_video_frames(
                src, os.path.join(store.root, "video_frames"), stride, frame_range))
        else:
            paths = image_ops.list_images(src)
            if frame_range is not None:
                paths = paths[frame_range[0]:frame_range[1]]
            if stride > 1:
                paths = paths[::stride]
        if not paths:
            raise FileNotFoundError(f"no images under {src}")
        from PIL import Image as PILImage

        widths, heights = [], []
        for p in paths:
            with PILImage.open(p) as im:
                w, h = im.size
            widths.append(w)
            heights.append(h)
        store.write_table("frames", {
            "image_id": np.arange(len(paths), dtype=np.int64),
            "path": [p.encode() for p in paths],
            "width": np.asarray(widths, np.int32),
            "height": np.asarray(heights, np.int32),
        }, meta={"stage": "prepare_images", "image_path": src, "stride": stride})
        log.info("prepare_images: %d frames", len(paths))
        return len(paths)

    grays, focals, widths, heights = [], [], [], []
    for n, (pixels, focal_px) in enumerate(frames):
        pixels = np.asarray(pixels)
        if pixels.dtype != np.uint8 or pixels.ndim not in (2, 3):
            raise ValueError(f"frame {n}: expected uint8 (H, W) or (H, W, 3), "
                             f"got {pixels.dtype} {pixels.shape}")
        h, w = pixels.shape[:2]
        if max(h, w) > cfg.sift.max_image_size:
            raise ValueError(f"frame {n} is {w}x{h}, larger than "
                             f"sift.max_image_size={cfg.sift.max_image_size}; "
                             "in-memory frames are not resized")
        gray = (image_ops.to_grayscale(pixels) if pixels.ndim == 3
                else pixels.astype(np.float32) / 255.0)
        grays.append(np.clip(np.round(gray * 255.0), 0, 255).astype(np.uint8).reshape(-1))
        focals.append(float(focal_px))
        widths.append(w)
        heights.append(h)
    if not grays:
        raise ValueError("no frames given")
    store.write_table("frames", {
        "image_id": np.arange(len(grays), dtype=np.int64),
        "path": [f"{MEMORY_PREFIX}{n:06d}".encode() for n in range(len(grays))],
        "width": np.asarray(widths, np.int32),
        "height": np.asarray(heights, np.int32),
        "pixels": grays,
        "focal_px": np.asarray(focals, np.float64),
    }, meta={"stage": "prepare_images", "image_path": "memory"})
    log.info("prepare_images: %d in-memory frames", len(grays))
    return len(grays)


def extract_video_frames(video_path: str, out_dir: str, stride: int = 1,
                         frame_range: Optional[tuple] = None) -> str:
    """Decode a video's frames with Pillow (a multi-frame container it
    reads: GIF, APNG, TIFF, WebP), keep those whose absolute index i lies
    in ``frame_range`` and is a multiple of ``stride``, and write each as
    ``out_dir/frame_{i:06d}.png`` in RGB. Returns out_dir. A container
    Pillow cannot open (an ffmpeg one such as MP4) raises RuntimeError:
    pre-extract its frames to a directory."""
    from PIL import Image as PILImage
    from PIL import ImageSequence

    os.makedirs(out_dir, exist_ok=True)
    n_out = 0
    try:
        with PILImage.open(video_path) as im:
            for i, frame in enumerate(ImageSequence.Iterator(im)):
                if frame_range is not None and not frame_range[0] <= i < frame_range[1]:
                    continue
                if i % stride:
                    continue
                frame.convert("RGB").save(os.path.join(out_dir, f"frame_{i:06d}.png"))
                n_out += 1
    except Exception as e:
        raise RuntimeError(
            f"cannot decode video {video_path!r}: {e}. Pillow reads multi-frame "
            "images (GIF, APNG, TIFF, WebP), not ffmpeg containers; pre-extract "
            "the frames to a directory instead.") from e
    log.info("video: extracted %d frames (stride %d)", n_out, stride)
    return out_dir


def _frame_decoder(store: ArtifactStore, max_image_size: int, canvas):
    """A function (frame row) -> the frame's extraction input (uint8 canvas,
    valid (h, w), downscale factor, EXIF-or-given focal in original
    pixels), from one read of the frames table."""
    frames = store.read_table("frames")
    paths = [p.decode() for p in frames["path"]]
    in_memory = "pixels" in frames

    def decode(n: int) -> dict:
        if not in_memory:
            return image_ops.load_for_extraction(paths[n], max_image_size, canvas)
        h, w = int(frames["height"][n]), int(frames["width"][n])
        gray = np.asarray(frames["pixels"][n]).reshape(h, w)
        return {"image": image_ops.pad_to_canvas(gray, canvas),
                "valid_hw": np.array([h, w], np.int32), "scale": 1.0,
                "exif_focal_px": float(frames["focal_px"][n])}
    return decode


def _prefetch(pool, fn, jobs, ahead: int):
    """fn(job) for each job, in order, computed on ``pool`` up to ``ahead``
    jobs before the caller takes it."""
    jobs = iter(jobs)
    futs = collections.deque(pool.submit(fn, j) for j in itertools.islice(jobs, ahead))
    try:
        while futs:
            out = futs.popleft().result()
            futs.extend(pool.submit(fn, j) for j in itertools.islice(jobs, 1))
            yield out
    finally:
        for f in futs:
            f.cancel()


def _to_host(x: torch.Tensor):
    """(host tensor, CUDA event or None): on the card a non-blocking copy
    into pinned memory, complete once the event is."""
    if x.device.type != "cuda":
        return x, None
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    buf.copy_(x, non_blocking=True)
    evt = torch.cuda.Event()
    evt.record()
    return buf, evt


def _host_numpy(copied) -> np.ndarray:
    buf, evt = copied
    if evt is not None:
        evt.synchronize()
    return buf.numpy()


# ---------------------------------------------------------------------------
# stage 2: extraction
# ---------------------------------------------------------------------------

def run_extraction(cfg: PipelineConfig, store: Optional[ArtifactStore] = None,
                   batch_size: int = 4, frame_slice: Optional[tuple] = None,
                   out_table: str = "extraction", *, device=None):
    """SIFT + EXIF camera init per image, ``batch_size`` images a device
    step.

    Canvases share one size, so a batch is one (B, H, W) tensor through
    ``sift.extract_batch``. Keypoints come back valid-first, so each
    image's table row is the [:count] prefix of its slots: per batch the
    host reads one count vector, then copies the batch's [:, :kmax] rows
    (kmax its largest count) into pinned memory without blocking. At most
    max(2, ``parallel.inflight_batches``) batches are in flight, and a
    host thread decodes the next batches meanwhile (Pillow, for image
    files), so decode, device work and downloads overlap. Unlike the JAX
    stage the last batch is not padded to ``batch_size``: there is no
    compiled signature to keep. Each image's row is bitwise its row with
    ``batch_size=1`` on the same device, in any batch.

    frame_slice=(k, n): extract only every n-th frame from k (the shard of
    ``parallel/dist.run_extraction_distributed``); each image's row is the
    one the whole run writes."""
    store = store or ArtifactStore(cfg.store_path)
    dev = devlib.resolve(device)
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    s = cfg.sift
    canvas = (_round_up(s.max_image_size, 128),) * 2
    frame_ids = np.asarray(store.read_table("frames", ["image_id"])["image_id"], np.int64)
    rows = range(len(frame_ids))
    if frame_slice is not None:
        rows = rows[frame_slice[0]::frame_slice[1]]
        frame_ids = frame_ids[np.asarray(rows, np.int64)]
    decode = _frame_decoder(store, s.max_image_size, canvas)
    window = max(2, int(cfg.parallel.inflight_batches))
    keypoints, descriptors, cam_rows, num_feats = [], [], [], []
    pending = collections.deque()   # dispatched: counts on their way to the host
    ready = collections.deque()     # counts read: [:, :kmax] rows on their way

    def dispatch(items):
        imgs = torch.from_numpy(np.stack([it["image"] for it in items]))
        vhw = torch.from_numpy(np.stack([it["valid_hw"] for it in items]))
        if dev.type == "cuda":
            imgs, vhw = imgs.pin_memory(), vhw.pin_memory()
        imgs = imgs.to(dev, non_blocking=True).to(torch.float32) * (1.0 / 255.0)
        feats = sift_ops.extract_batch(
            imgs, vhw.to(dev, non_blocking=True), max_features=s.max_num_features,
            num_octaves=s.num_octaves, num_scales=s.scales_per_octave,
            init_sigma=s.init_sigma, peak_threshold=s.peak_threshold,
            edge_threshold=s.edge_threshold, upright=s.upright)
        meta = torch.cat([feats.xy, feats.scale[..., None], feats.ori[..., None]], dim=-1)
        pending.append((items, _to_host(feats.valid.sum(1)), meta,
                        sift_ops.descriptors_to_uint8(feats.desc)))

    def slice_oldest():
        items, counts, meta, desc = pending.popleft()
        counts = _host_numpy(counts)
        kmax = int(counts.max())
        ready.append((items, counts, _to_host(meta[:, :kmax]), _to_host(desc[:, :kmax])))

    def convert_oldest():
        items, counts, meta, desc = ready.popleft()
        meta, desc = _host_numpy(meta), _host_numpy(desc)
        for b, item in enumerate(items):
            nv = int(counts[b])
            h, w = int(item["valid_hw"][0]), int(item["valid_hw"][1])
            exif_f = item["exif_focal_px"]
            exif_scaled = exif_f * item["scale"] if exif_f else None
            model_id, params, prior = camlib.camera_from_exif(w, h, exif_scaled)
            keypoints.append(meta[b, :nv].astype(np.float32))
            descriptors.append(desc[b, :nv])
            cam_rows.append(np.concatenate(
                [[model_id, w, h, 1.0 if prior else 0.0, item["scale"]], params]))
            num_feats.append(nv)

    batches = [rows[i:i + batch_size] for i in range(0, len(rows), batch_size)]
    with ThreadPoolExecutor(max_workers=1) as pool:
        for items in _prefetch(pool, lambda b: [decode(n) for n in b], batches, window):
            dispatch(items)
            if len(pending) >= window:
                slice_oldest()
            if len(ready) >= window:
                convert_oldest()
    while pending:
        slice_oldest()
    while ready:
        convert_oldest()
    n = len(num_feats)
    store.write_table(out_table, {
        "image_id": frame_ids,
        "keypoints": keypoints,
        "descriptors": descriptors,
        "camera": np.stack(cam_rows) if cam_rows else np.zeros((0, 9), np.float64),
    }, meta={"stage": "extraction", "config": vars(s), "device": str(dev)})
    log.info("extraction: %d images, mean %.0f feats", n,
             np.mean(num_feats) if num_feats else 0.0)
    return num_feats


def _load_extraction(store: ArtifactStore):
    ext = store.read_table("extraction")
    image_ids = [int(i) for i in ext["image_id"]]
    kp, desc, cameras = {}, {}, {}
    for n, iid in enumerate(image_ids):
        kp[iid] = np.asarray(ext["keypoints"][n], np.float64)
        desc[iid] = np.asarray(ext["descriptors"][n])
        row = ext["camera"][n]
        model_id = int(row[0])
        w, h = int(row[1]), int(row[2])
        params = row[5:5 + camlib.MODEL_NUM_PARAMS[model_id]]
        cameras[iid] = (model_id, list(params), w, h, row[3] > 0)
    return image_ids, kp, desc, cameras


# ---------------------------------------------------------------------------
# stage 3: feature matching + two-view geometry
# ---------------------------------------------------------------------------

def _cam_K(caminfo):
    model_id, params, w, h, prior = caminfo
    if model_id == camlib.PINHOLE:
        return np.array([[params[0], 0, params[2]], [0, params[1], params[3]],
                         [0, 0, 1.0]])
    return np.array([[params[0], 0, params[1]], [0, params[0], params[2]],
                     [0, 0, 1.0]])


def pair_generator(device, row_a: int, row_b: int,
                   model_round: int = 0) -> torch.Generator:
    """RANSAC draws keyed by the pair's (row_a, row_b) and, with multiple
    models, the estimation round (< 4), so banks, chunking and scheduling
    never change a pair's draws. Rows must be below 2**30."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(model_round) << 62) | (int(row_a) << 32) | int(row_b))
    return gen


# ---- loop closure: host-numpy bag-of-words helpers (the JAX stage's own,
# kept here under the same names; the same descriptors give bitwise the
# same arrays) -----------------------------------------------------------

def _kmeans_pp(samp: np.ndarray, k: int, iters: int, rng) -> np.ndarray:
    """k-means++ seeding (a running min-distance vector) and Lloyd
    iterations (one (n, d) @ (d, k) matmul and a scatter-add each)."""
    n, d = samp.shape
    cent = np.empty((k, d), np.float32)
    cent[0] = samp[rng.integers(n)]
    d2 = ((samp - cent[0]) ** 2).sum(1)
    for j in range(1, k):
        tot = float(d2.sum())
        if tot <= 1e-12:          # fewer distinct points than centers
            cent[j:] = samp[rng.integers(n, size=k - j)]
            break
        cent[j] = samp[rng.choice(n, p=d2 / tot)]
        d2 = np.minimum(d2, ((samp - cent[j]) ** 2).sum(1))
    sq = (samp ** 2).sum(1)
    for _ in range(iters):
        dist = (sq[:, None] - 2.0 * (samp @ cent.T)
                + (cent ** 2).sum(1)[None, :])
        lab = np.argmin(dist, axis=1)
        sums = np.zeros((k, d), np.float32)
        np.add.at(sums, lab, samp)
        cnt = np.bincount(lab, minlength=k).astype(np.float32)
        cent = np.where((cnt == 0)[:, None], cent,
                        sums / np.maximum(cnt, 1.0)[:, None])
    return cent


def _bow_embedding(image_ids, desc, vocab_size: int = 128,
                   sample_cap: int = 20000, per_image_cap: int = 512,
                   seed: int = 1):
    """(N, k) L2-normalized TF-IDF bag-of-words embeddings over a k-means
    vocabulary of the collection's own SIFT descriptors (the k-means sample
    scales with N); the similarity of images a, b is ``Hw[a] @ Hw[b]``.
    None when there are too few descriptors for a vocabulary."""
    n_img = len(image_ids)
    sample_cap = int(min(sample_cap, max(4096, 96 * n_img)))
    rng = np.random.default_rng(seed)
    per_img = []
    for r in range(n_img):
        d = desc[image_ids[r]].astype(np.float32)[:per_image_cap]
        n = np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-8)
        per_img.append(d / n)
    all_d = (np.concatenate(per_img) if per_img
             else np.zeros((0, 128), np.float32))
    if len(all_d) < 16:
        return None
    samp = all_d[rng.permutation(len(all_d))[:sample_cap]]
    k = int(min(vocab_size, max(8, len(samp) // 4)))
    cent = _kmeans_pp(samp, k, iters=12, rng=rng)
    cent /= np.maximum(np.linalg.norm(cent, axis=1, keepdims=True), 1e-8)
    H = np.zeros((n_img, k), np.float32)
    for r in range(n_img):
        if len(per_img[r]):
            w = np.argmax(per_img[r] @ cent.T, axis=1)
            H[r] = np.bincount(w, minlength=k)
    df = (H > 0).sum(axis=0)
    Hw = H * np.log(n_img / np.maximum(df, 1))
    Hw /= np.maximum(np.linalg.norm(Hw, axis=1, keepdims=True), 1e-8)
    return Hw


def _bow_similarity(image_ids, desc, **kw):
    """Dense (N, N) similarity, for small collections and tests."""
    Hw = _bow_embedding(image_ids, desc, **kw)
    if Hw is None:  # too few descriptors to build a vocabulary
        return np.zeros((len(image_ids), len(image_ids)), np.float32)
    return Hw @ Hw.T


def _loop_candidates(Hw, sep: int, top_k: int, min_sim: float,
                     block: int = 256):
    """Top-k partners past the window per image, in row blocks (O(block*N)
    memory): a set of (a, b) pairs with a < b and |a - b| > sep."""
    n_img = Hw.shape[0]
    pairs: set = set()
    floor = max(min_sim, -1.5)
    cols = np.arange(n_img)
    for s in range(0, n_img, block):
        e = min(s + block, n_img)
        sim = Hw[s:e] @ Hw.T                      # (block, N)
        off = np.abs(np.arange(s, e)[:, None] - cols[None, :])
        sim[off <= sep] = -2.0                    # window + self excluded
        k = min(top_k, n_img)
        idx = np.argpartition(-sim, k - 1, axis=1)[:, :k]
        for r in range(e - s):
            a = s + r
            for b in idx[r]:
                if sim[r, b] > floor:
                    pairs.add((min(a, int(b)), max(a, int(b))))
    return pairs


def _revisit_probe(image_ids, desc, sep: int, n_img: int, ratio: float,
                   probe_images: int = 64):
    """The auto-closure signal on an evenly spaced <= ``probe_images``
    subset, with the separation scaled to subset units. Returns (frac,
    coherence, Hw, full); with full=True the subset is the whole collection,
    so the signal is exact and Hw is the full embedding."""
    n_sub = min(probe_images, n_img)
    idx = np.linspace(0, n_img - 1, n_sub).astype(np.int64)
    stride = max(1, (n_img - 1) // max(n_sub - 1, 1))
    sub_ids = [image_ids[int(i)] for i in idx]
    Hw = _bow_embedding(sub_ids, desc)
    if Hw is None:
        return None, None, None, n_sub == n_img
    sep_sub = max(1, int(np.ceil(sep / stride)))
    frac, coh = _revisit_signal(Hw, sep_sub, ratio)
    return frac, coh, Hw, n_sub == n_img


def _revisit_signal(Hw, sep: int, ratio: float, block: int = 256):
    """(revisit_fraction, partner_coherence): the share of images whose best
    similarity past the window reaches ``ratio`` x their best window
    similarity, and, among consecutive such images, the share whose top far
    partners move together (|b(a+1) - b(a)| <= 4): a true revisit's partner
    map is locally smooth, appearance aliasing scatters it."""
    n_img = Hw.shape[0]
    if n_img < 3:
        return 0.0, 0.0
    cols = np.arange(n_img)
    passed = np.zeros(n_img, bool)
    partner = np.zeros(n_img, np.int64)
    for s in range(0, n_img, block):
        e = min(s + block, n_img)
        sim = Hw[s:e] @ Hw.T
        off = np.abs(np.arange(s, e)[:, None] - cols[None, :])
        near = np.where((off > 0) & (off <= sep), sim, -2.0).max(axis=1)
        far = np.where(off > sep, sim, -2.0)
        far_top = far.max(axis=1)
        partner[s:e] = np.argmax(far, axis=1)
        passed[s:e] = (far_top > -1.5) & (far_top >= ratio * near)
    frac = float(np.mean(passed))
    both = passed[:-1] & passed[1:]
    if not both.any():
        return frac, 0.0
    coh = float(np.mean(
        np.abs(partner[1:][both] - partner[:-1][both]) <= 4))
    return frac, coh


class _LoopClosure:
    """The loop-closure decision of ``run_matching``. ``start`` launches the
    auto probe on a host thread, so it overlaps phase-1 matching; after
    phase 1, ``candidates`` decides and returns the loop pairs past the
    window (an empty set when closure stays off). ``meta`` carries the JAX
    stage's manifest keys."""

    def __init__(self, m, image_ids, desc):
        lc = m.loop_closure
        lc = lc.lower() if isinstance(lc, str) else lc
        self.m, self.image_ids, self.desc = m, image_ids, desc
        self.auto = lc == "auto"
        self.on = lc in (True, 1, "on", "true")
        self.sep = m.loop_min_separation or 2 * m.overlap
        self.meta: Dict = {"mode": "auto" if self.auto else ("on" if self.on else "off")}
        self.probe: Dict = {}
        self.thread = None

    def start(self):
        n_img, m = len(self.image_ids), self.m
        if self.auto and n_img <= self.sep + 1:
            # no pair can pass the |a - b| > sep gate
            self.auto = self.on = False
            self.meta["skipped"] = f"n_img {n_img} <= sep+1 ({self.sep + 1})"
        elif self.auto and n_img > 2:
            def worker():
                try:
                    f, c, hw, full = _revisit_probe(self.image_ids, self.desc, self.sep,
                                                    n_img, m.loop_auto_ratio,
                                                    m.loop_probe_images)
                    self.probe.update(frac=f, coh=c, Hw=hw, full=full)
                except Exception as e:  # fall back to the full prepass
                    self.probe["error"] = repr(e)

            self.thread = threading.Thread(target=worker, daemon=True)
            self.thread.start()

    def candidates(self, sched) -> set:
        n_img, m, meta, probe = len(self.image_ids), self.m, self.meta, self.probe
        on, Hw = self.on, None
        if (self.on or self.auto) and n_img > 2:
            t0 = time.perf_counter()
            if self.thread is not None:
                self.thread.join()
            if "error" in probe:
                meta["probe_error"] = probe["error"]
            need_full = self.auto
            if self.auto and probe.get("frac") is not None:
                frac_p, coh_p = probe["frac"], probe["coh"]
                meta["probe_frac"] = round(float(frac_p), 4)
                meta["probe_coherence"] = round(float(coh_p), 4)
                if probe["full"]:
                    # the collection fits the probe: its signal is exact
                    on = (frac_p >= m.loop_auto_min_frac
                          and coh_p >= m.loop_auto_min_coherence)
                    meta["revisit_frac"] = meta.pop("probe_frac")
                    meta["partner_coherence"] = meta.pop("probe_coherence")
                    Hw, need_full = probe["Hw"], False
                elif (frac_p < 0.5 * m.loop_auto_min_frac
                        or coh_p < 0.5 * m.loop_auto_min_coherence):
                    # a subset probe skips the full prepass only on a clear
                    # off signal
                    on = need_full = False
                    meta["skipped"] = "probe: no revisit structure"
            elif self.auto and probe.get("full") and "error" not in probe:
                on = need_full = False   # too few descriptors to embed
            if on and Hw is None:
                Hw = _bow_embedding(self.image_ids, self.desc)
                on = Hw is not None
            if need_full:
                Hw = Hw if Hw is not None else _bow_embedding(self.image_ids, self.desc)
                if Hw is None:
                    on = False
                else:
                    frac, coh = _revisit_signal(Hw, self.sep, m.loop_auto_ratio)
                    on = frac >= m.loop_auto_min_frac and coh >= m.loop_auto_min_coherence
                    meta["revisit_frac"] = round(float(frac), 4)
                    meta["partner_coherence"] = round(float(coh), 4)
                    log.info("matching: loop-closure prepass: revisit fraction %.3f, "
                             "partner coherence %.3f -> %s", frac, coh,
                             "on" if on else "off")
            meta["prepass_s"] = round(time.perf_counter() - t0, 3)
        meta["enabled"] = bool(on and n_img > 2)
        if not meta["enabled"]:
            return set()
        return _loop_candidates(Hw, self.sep, m.loop_top_k, m.loop_min_similarity) - set(sched)


def _bank_rows(image_ids, desc, rows, K_max: int, dtype):
    """Raw descriptors of the given collection rows, zero-padded to
    (len(rows), K_max, 128) in ``dtype``, and their (len(rows), K_max)
    validity."""
    raw = np.zeros((len(rows), K_max, 128), dtype)
    valid = np.zeros((len(rows), K_max), bool)
    for n, r in enumerate(rows):
        d = desc[image_ids[r]]
        raw[n, :len(d)] = d
        valid[n, :len(d)] = True
    return raw, valid


def run_matching(cfg: PipelineConfig, store: Optional[ArtifactStore] = None,
                 device=None, out_table: str = "matching",
                 schedule_slice: Optional[tuple] = None,
                 verify_width: Optional[Callable[[int], int]] = None):
    """Overlap-window matching, then loop-closure candidates, then
    two-view verification of every pair with enough matches (with the real
    intrinsics), then optionally the guided second pass.

    Two plans, chosen as in the JAX stage: the resident plan keeps the
    whole collection as one normalized bf16 pool on the device (kernel 1,
    one launch per pair chunk); the banked plan streams [bank + window]
    images at a time in the descriptors' native dtype, normalizes them on
    the device, and matches each bank's pairs with one launch (kernel 1 for
    bf16, kernel 3 forward and reverse for f32). precision="f32" always
    banks. The resident pool and a bf16 bank hold the same rows, so the two
    plans write the same table. Every pair's RANSAC draws are keyed by its
    (row_a, row_b), so banks never change them.

    Loop closure (``matching.loop_closure``: on, off, or "auto", where a
    revisit probe on a host thread, overlapped with the window matching,
    decides) adds bag-of-words partners past the window: on the resident
    plan they are more pool chunks, on the banked plan mini-banks of the
    pairs' rows; they go through the same verification gate.

    schedule_slice=(k, n): match only every n-th scheduled window pair from
    k, and every n-th loop-closure candidate from k (the shard of
    ``parallel/dist.run_matching_distributed``). The candidates are found
    over the whole schedule, so every shard decides alike and the shards'
    rows hold each pair once (the JAX stage slices the window pairs alone
    and matches every loop pair on every shard, stages.py:915-923).
    ``verify_width`` maps this run's padded correspondence width P to the
    one all shards verify at (their largest; every shard must call it), so
    a pair's row does not depend on its shard."""
    store = store or ArtifactStore(cfg.store_path)
    dev = devlib.resolve(device)
    image_ids, kp, desc, cameras = _load_extraction(store)
    m = cfg.matching
    n_img = len(image_ids)
    K_max = _round_up(max(max((len(d) for d in desc.values()), default=1), 1), 128)
    loop = _LoopClosure(m, image_ids, desc)
    loop.start()

    if m.quadratic_overlap:
        offsets = sorted({1 << i for i in range(max(m.overlap, 1))})
    else:
        offsets = list(range(1, m.overlap + 1))
    sched_all = [(a, a + off) for off in offsets for a in range(n_img) if a + off < n_img]
    k_sh, n_sh = schedule_slice or (0, 1)
    sched = sched_all[k_sh::n_sh]

    # bank geometry: auto bank = ~256 MB of f32 descriptors, less the window
    W = max(offsets) if offsets else 1
    B = m.bank_images
    if B <= 0:
        B = max((256 << 20) // (K_max * 128 * 4) - W, 8)
    n_bank = min(B + W, n_img)
    pool_bytes = n_img * K_max * 128 * 4
    resident = (m.execution == "resident"
                or (m.execution == "auto" and pool_bytes <= m.resident_pool_mb << 20)) \
        and m.precision == "bf16"
    # pairs grouped by the bank that owns their first row; within a bank
    # every partner row b <= a + W is resident
    by_bank: Dict[int, list] = {}
    for a, b in sched:
        by_bank.setdefault(a // B, []).append((a, b))
    bank_dtype = desc[image_ids[0]].dtype if n_img else np.uint8
    match_kw = dict(max_ratio=m.max_ratio, max_distance=m.max_distance,
                    cross_check=m.cross_check, precision=m.precision)

    # ---- phase 1: matching -----------------------------------------------
    cand = []

    def drain(pairs, idx):
        for n, (a, b) in enumerate(pairs):
            sel = np.nonzero(idx[n] >= 0)[0]
            if len(sel) >= m.min_num_inliers:
                cand.append((a, b, sel, idx[n]))

    def rows_tensor(pairs, base):
        ab = np.asarray(pairs, np.int32).reshape(-1, 2) - base
        ab = torch.as_tensor(ab, device=dev)
        return ab[:, 0].contiguous(), ab[:, 1].contiguous()

    def match_rows(rows, pairs):
        """Match ``pairs`` (collection rows) in one bank of ``rows``."""
        raw, valid = _bank_rows(image_ids, desc, rows, K_max, bank_dtype)
        bank = matching_ops.normalize_bank(torch.as_tensor(raw, device=dev), m.precision)
        row_of = {r: n for n, r in enumerate(rows)}
        idx = matching_ops.match_bank(
            bank, torch.as_tensor(valid, device=dev),
            *rows_tensor([(row_of[a], row_of[b]) for a, b in pairs], 0), **match_kw)
        drain(pairs, idx.cpu().numpy())

    with span("matching.window"):
        if resident:
            raw, valid = _bank_rows(image_ids, desc, range(n_img), K_max, bank_dtype)
            pool = matching_ops.normalize_pool(torch.as_tensor(raw, device=dev))
            valid_pool = torch.as_tensor(valid, device=dev)
            NPC = max(int(m.resident_pair_chunk), 1)

            def match_pool(pairs):
                for c0 in range(0, len(pairs), NPC):
                    chunk = pairs[c0:c0 + NPC]
                    idx = matching_ops.match_pairs_pool(
                        pool, valid_pool, *rows_tensor(chunk, 0), **match_kw)
                    drain(chunk, idx.cpu().numpy())

            match_pool(sched)
        else:
            for blk in sorted(by_bank):
                s0 = blk * B
                match_rows(list(range(s0, min(s0 + n_bank, n_img))), by_bank[blk])

    # ---- phase 1b: loop-closure candidates, through the same matcher ------
    with span("matching.loop_closure"):
        loop_all = sorted(loop.candidates(sched_all))
        loop_pairs = loop_all[k_sh::n_sh]
        if resident:
            match_pool(loop_pairs)
            del pool, valid_pool
        else:
            # mini-banks of the pairs' rows, at most n_bank rows each
            batch, rows = [], set()
            for p in loop_pairs:
                if len(rows | set(p)) > n_bank:
                    match_rows(sorted(rows), batch)
                    batch, rows = [], set()
                batch.append(p)
                rows |= set(p)
            if batch:
                match_rows(sorted(rows), batch)
    loop_meta = dict(loop.meta, n_candidates=len(loop_pairs))
    if schedule_slice is not None:
        # every shard probes and embeds every image, so all decide alike
        loop_meta.update(candidates_total=len(loop_all),
                         decided_on="every image, on every shard")
    if loop_pairs:
        # a digest of the candidate set, so that runs can be compared
        loop_meta["candidates_digest"] = hashlib.sha256(
            np.asarray(loop_pairs, np.int64).tobytes()).hexdigest()[:16]
        log.info("matching: %d loop-closure candidates past the window",
                 len(loop_pairs))

    # ---- phase 2: two-view geometries in chunks; one table row per model -----
    pair_ids, tvg_rows, match_lists = [], [], []
    P = _round_up(max(max((len(c[2]) for c in cand), default=0), 8), 256)
    if verify_width is not None:
        P = verify_width(P)
    if cand:
        pair_ids, tvg_rows, match_lists = verify_candidates(
            m, image_ids, kp, cameras, cand, P, dev)
        if m.guided_matching and pair_ids:
            with span("matching.guided"):
                match_lists = _guided_rematch(m, image_ids, kp, desc, pair_ids,
                                              tvg_rows, match_lists, B, n_bank,
                                              K_max, dev)

    store.write_table(out_table, {
        "pair_image_ids": np.asarray(pair_ids, np.int64).reshape(-1, 2),
        "two_view_geometry": np.stack(tvg_rows) if tvg_rows else np.zeros((0, 37)),
        "matches": match_lists,
    }, meta={"stage": "matching", "config": vars(m),
             "execution": "resident" if resident else "banked",
             "bank_images": B, "num_banks": len(by_bank),
             "device": str(dev), "scheduled_pairs": len(sched), "k_max": K_max,
             "schedule_slice": [k_sh, n_sh],
             "loop_closure": loop_meta})
    log.info("matching: %d verified pairs of %d scheduled", len(pair_ids), len(sched))
    return len(pair_ids)


VERIFY_BUDGET_BYTES = 1 << 30   # device working set of one verification call
VERIFY_MAX_SUB = 64             # pairs per verification call, at most


def verify_sub_batch(P: int, device) -> int:
    """Pairs per device call of two-view verification at padded width P. On
    the card, a power of two in [8, VERIFY_MAX_SUB] whose working set (per
    pair about TOP residual rows and the watermark's 128 candidate rows of P
    f32, a few temporaries each) fits VERIFY_BUDGET_BYTES: the more pairs a
    call holds, the fewer launches each pays. On the CPU, which launches
    nothing, 8 (the JAX stage's map width), so padding costs little. It
    depends on P and the device alone, so every call of a stage has one
    shape, whatever the chunk."""
    if torch.device(device).type == "cpu":
        return 8
    per_pair = 4 * P * (8 * tv_ops.TOP + 4 * 128)
    s = 8
    while s < VERIFY_MAX_SUB and 2 * s * per_pair <= VERIFY_BUDGET_BYTES:
        s *= 2
    return s


def verify_chunk(n_cand: int, verify_batch_pairs: int) -> int:
    """Pairs per verification chunk (one download each), as the JAX stage
    sets it: a power of two, at least 8 and at least min(n_cand,
    verify_batch_pairs)."""
    vc = 8
    while vc < min(n_cand, max(verify_batch_pairs, 8)):
        vc *= 2
    return vc


def _pack_tvg(g) -> torch.Tensor:
    """(C, 37 + N) f32 rows of a batched geometry: [:37] the table's
    two_view_geometry layout [config, n_inl, tri_angle, qvec(4), tvec(3),
    E(9), F(9), H(9)], [37:] the inlier mask."""
    C = g.config.shape[0]
    return torch.cat([torch.stack([g.config.float(), g.num_inliers.float(),
                                   g.tri_angle.float()], -1),
                      g.qvec.float(), g.tvec.float(), g.E.reshape(C, 9).float(),
                      g.F.reshape(C, 9).float(), g.H.reshape(C, 9).float(),
                      g.inlier_mask.float()], -1)


def _verify_call(m, image_ids, kp, cameras, pairs, S: int, P: int, n_models: int, dev):
    """One device call: the pairs (a, b, sel, idx_row) padded to S slots of
    P correspondences through the batched estimator. Padded slots get a
    benign K = 100 I and size 100 (as in the JAX stage) and are not live.
    Returns (S, n_models, 37 + P) f32 on the device."""
    uv1 = np.zeros((S, P, 2), np.float32)
    uv2 = np.zeros((S, P, 2), np.float32)
    vm = np.zeros((S, P), bool)
    K1 = np.tile(np.eye(3, dtype=np.float32) * 100.0, (S, 1, 1))
    K2 = K1.copy()
    sz1 = np.full((S, 2), 100.0, np.float32)
    sz2 = sz1.copy()
    gens = [None] * S
    live = np.zeros(S, bool)
    for n, (a, b, sel, idx_row) in enumerate(pairs):
        ia, ib = image_ids[a], image_ids[b]
        k_n = min(len(sel), P)
        uv1[n, :k_n] = kp[ia][sel[:k_n], :2]
        uv2[n, :k_n] = kp[ib][idx_row[sel[:k_n]], :2]
        vm[n, :k_n] = True
        K1[n], K2[n] = _cam_K(cameras[ia]), _cam_K(cameras[ib])
        sz1[n] = cameras[ia][2], cameras[ia][3]          # (width, height)
        sz2[n] = cameras[ib][2], cameras[ib][3]
        gens[n] = ([pair_generator(dev, a, b, r) for r in range(n_models)]
                   if n_models > 1 else pair_generator(dev, a, b))
        live[n] = True
    t = lambda x: torch.as_tensor(x, device=dev)     # noqa: E731
    kw = dict(calibrated=True, max_error=m.max_error,
              min_num_inliers=m.min_num_inliers,
              min_inlier_ratio=m.min_inlier_ratio,
              num_trials=min(m.max_num_trials, 4096),
              min_num_trials=m.min_num_trials, confidence=m.confidence,
              watermark_detection=m.detect_watermark,
              size1=t(sz1), size2=t(sz2), live=live)
    args = (t(uv1), t(uv2), t(vm), t(K1), t(K2))
    if n_models > 1:
        models = tv_ops.estimate_two_view_geometry_multiple(
            gens, *args, max_models=n_models, **kw)
    else:
        models = [tv_ops.estimate_two_view_geometry(gens, *args, **kw)]
    return torch.stack([_pack_tvg(g) for g in models], 1)


def verify_candidates(m, image_ids, kp, cameras, cand, P: int, dev, chunk=None):
    """Two-view verification of the candidate pairs (phase 2 of
    ``run_matching``; the JAX stage's ``_verify_all_fn`` loop).

    cand: (a, b, sel, idx_row) per pair, in collection rows. ``chunk``
    pairs at a time (default: ``verify_chunk`` of
    ``matching.verify_batch_pairs``), each chunk in device calls of
    ``verify_sub_batch(P, dev)`` pairs padded to P correspondences; the host takes
    one download per chunk and drains its rows in candidate order, one table
    row per model found. Every pair draws from its own generators
    (``pair_generator``), and only while it is still active, and every call
    has one shape, so a pair's rows are bitwise the same alone, in any chunk
    and in any slot. Returns (pair_ids, tvg_rows, match_lists)."""
    n_models = 3 if m.multiple_models else 1
    VC = chunk or verify_chunk(len(cand), m.verify_batch_pairs)
    S = verify_sub_batch(P, dev)
    pair_ids, tvg_rows, match_lists = [], [], []
    for c0 in range(0, len(cand), VC):
        with span("matching.verify"):
            pairs = cand[c0:c0 + VC]
            packed = torch.cat([_verify_call(m, image_ids, kp, cameras, pairs[s0:s0 + S],
                                             S, P, n_models, dev)
                                for s0 in range(0, len(pairs), S)]).cpu().numpy()
            for n, (a, b, sel, idx_row) in enumerate(pairs):
                found = [r for r in range(n_models)
                         if int(packed[n, r, 0]) not in (tv_ops.DEGENERATE, tv_ops.UNDEFINED)
                         and int(packed[n, r, 1]) >= m.min_num_inliers]
                k_n = min(len(sel), P)
                for r in found:
                    row = packed[n, r, :37].astype(np.float64)
                    if len(found) > 1:
                        row[0] = tv_ops.MULTIPLE
                    inl = packed[n, r, 37:37 + k_n] > 0.5
                    pair_ids.append((image_ids[a], image_ids[b]))
                    tvg_rows.append(row)
                    match_lists.append(np.stack(
                        [sel[:k_n][inl], idx_row[sel[:k_n][inl]]], axis=1).astype(np.int32))
    return pair_ids, tvg_rows, match_lists


GUIDED_MAX_GROUP = 16     # pairs per guided-matching call, as the JAX stage


def guided_group(K: int) -> int:
    """Pairs per guided-matching call at K descriptor slots: up to 16, fewer
    where the (G, K, K) similarity and its gates would pass the budget."""
    g = 1
    while g < GUIDED_MAX_GROUP and 2 * g * 48 * K * K <= VERIFY_BUDGET_BYTES:
        g *= 2
    return g


def _guided_rematch(m, image_ids, kp, desc, pair_ids, tvg_rows, match_lists,
                    B: int, n_bank: int, K_max: int, dev):
    """Second matching pass constrained by each verified pair's F (JAX
    ``_guided_rematch``), ``guided_group(K_max)`` pairs a call. Banked like
    phase 1, and upgrade-only: a pair keeps its verified inliers unless the
    guided pass finds at least as many matches. A pair whose partner lies
    outside its first row's bank keeps its matches. F is read from the
    row's columns 19:28 (``_pack_tvg``); the JAX stage reads 17:26, E's
    last two entries and F's first seven."""
    id_to_row = {iid: n for n, iid in enumerate(image_ids)}
    n_img = len(image_ids)
    by_bank: Dict[int, list] = {}
    for n, (ia, ib) in enumerate(pair_ids):
        blk = id_to_row[ia] // B
        if id_to_row[ib] - blk * B < n_bank:
            by_bank.setdefault(blk, []).append(n)
    out = list(match_lists)
    G = guided_group(K_max)
    for blk in sorted(by_bank):
        s0 = blk * B
        rows = range(s0, min(s0 + n_bank, n_img))
        raw, valid = _bank_rows(image_ids, desc, rows, K_max, np.float32)
        uv = np.zeros((len(rows), K_max, 2))
        for n, r in enumerate(rows):
            k = kp[image_ids[r]]
            uv[n, :len(k)] = k[:, :2]
        bank = torch.as_tensor(raw, device=dev)       # the matcher normalizes
        valid = torch.as_tensor(valid, device=dev)
        uv = torch.as_tensor(uv, device=dev)
        todo = by_bank[blk]
        for g0 in range(0, len(todo), G):
            grp = todo[g0:g0 + G]
            a = torch.as_tensor([id_to_row[pair_ids[n][0]] - s0 for n in grp], device=dev)
            b = torch.as_tensor([id_to_row[pair_ids[n][1]] - s0 for n in grp], device=dev)
            F = torch.as_tensor(np.stack([tvg_rows[n][19:28].reshape(3, 3) for n in grp]),
                                device=dev)
            idx, _ = matching_ops.match_descriptors_guided(
                bank[a], bank[b], valid[a], valid[b], uv[a], uv[b], F,
                max_epipolar_error=m.max_error, max_distance=m.max_distance,
                cross_check=m.cross_check, precision=m.precision)
            idx = idx.cpu().numpy()
            for k, n in enumerate(grp):
                ia = pair_ids[n][0]
                sel = np.nonzero(idx[k, :len(kp[ia])] >= 0)[0]
                if len(sel) >= len(match_lists[n]):
                    out[n] = np.stack([sel, idx[k, sel]], axis=1).astype(np.int32)
    return out


def _build_graph(store: ArtifactStore, kp: Dict[int, np.ndarray]):
    """Correspondence graph + two-view table from the matching table."""
    mt = store.read_table("matching")
    graph = make_graph()
    for iid, k in kp.items():
        graph.add_image(iid, len(k))
    two_view = {}
    pair_ids = np.asarray(mt["pair_image_ids"]).reshape(-1, 2)
    by_pair: Dict[tuple, list] = {}
    for n in range(len(pair_ids)):
        by_pair.setdefault((int(pair_ids[n][0]), int(pair_ids[n][1])), []).append(n)
    pair_matches = {}
    for (i, j), rows in by_pair.items():
        all_pairs = np.concatenate(
            [np.asarray(mt["matches"][n]).reshape(-1, 2) for n in rows])
        if len(rows) > 1:
            all_pairs = np.unique(all_pairs, axis=0)
        graph.add_matches(i, j, all_pairs)
        lo, hi = min(i, j), max(i, j)
        pair_matches[(lo, hi)] = all_pairs if i < j else all_pairs[:, ::-1].copy()
        best = max(rows, key=lambda n: mt["two_view_geometry"][n][1])
        row = np.asarray(mt["two_view_geometry"][best])
        if i > j:
            q, t = geom.np_pose_inverse(row[3:7], row[7:10])
        else:
            q, t = row[3:7].copy(), row[7:10].copy()
        two_view[(lo, hi)] = {"config": int(row[0]), "num_inliers": int(row[1]),
                              "tri_angle": float(row[2]), "qvec": q, "tvec": t}
    graph.pair_matches = pair_matches
    return graph, two_view


# ---------------------------------------------------------------------------
# stage 4: mapping (clustered, device mapper)
# ---------------------------------------------------------------------------

def run_mapping(cfg: PipelineConfig, store: Optional[ArtifactStore] = None,
                device=None) -> int:
    """Clustered incremental SfM; one table row per non-empty submodel."""
    store = store or ArtifactStore(cfg.store_path)
    dev = devlib.resolve(device)
    image_ids, kp, desc, cameras = _load_extraction(store)
    graph, two_view = _build_graph(store, kp)
    _, submodels = cluster_lib.run_clustered_mapping(kp, cameras, graph, two_view,
                                                     cfg.mapper, merge=False, device=dev)
    stats = dict(cluster_lib.LAST_MAPPING_STATS)
    blobs = [colmap_io.model_to_bytes(rec) for rec in submodels]
    n_reg = sum(r.num_registered for r in submodels)
    store.write_table("mapping", {
        "cluster_id": np.arange(len(submodels), dtype=np.int64),
        "cameras": [b[0] for b in blobs],
        "images": [b[1] for b in blobs],
        "points3d": [b[2] for b in blobs],
    }, meta={"stage": "mapping", "config": vars(cfg.mapper), "device": str(dev),
             "num_submodels": len(submodels), "device_stats": stats,
             "graph": graph.kind})
    log.info("mapping: %d submodels, %d registrations", len(submodels), n_reg)
    return len(submodels)


# ---------------------------------------------------------------------------
# stage 5: merge
# ---------------------------------------------------------------------------

def run_merge(cfg: PipelineConfig, store: Optional[ArtifactStore] = None,
              export_path: Optional[str] = None, device=None) -> Reconstruction:
    """Tree-merge the submodels into one model (Sim(3) fold), then, with
    more than one submodel and ``merge.final_ba``, refine it on ``device``:
    full-graph iterative refinement when the matching table exists and
    ``merge.iterative_refine`` is set, else one global BA. One submodel
    passes through unrefined, as in the reference."""
    store = store or ArtifactStore(cfg.store_path)
    dev = devlib.resolve(device)
    with span("merge.load"):
        tab = store.read_table("mapping")
        submodels = [colmap_io.model_from_bytes(c, i, p)
                     for c, i, p in zip(tab["cameras"], tab["images"], tab["points3d"])]
    with span("merge.fold"):
        model = merge_all(submodels, cfg.merge)
    if cfg.merge.final_ba and len(submodels) > 1:
        if cfg.merge.iterative_refine and store.has_table("matching"):
            with span("merge.graph"):
                _, kp_r, _, cameras_r = _load_extraction(store)
                graph_r, two_view_r = _build_graph(store, kp_r)
            m_cfg = cfg.matching
            win_max = (1 << max(m_cfg.overlap - 1, 0) if m_cfg.quadratic_overlap
                       else m_cfg.overlap)
            with span("merge.refine"):
                model = iterative_global_refinement(
                    model, kp_r, cameras_r, graph_r, two_view_r, cfg.mapper,
                    window=win_max, loop_gate_factor=cfg.merge.loop_refine_gate_factor,
                    loop_separation=m_cfg.loop_min_separation or 2 * m_cfg.overlap,
                    device=dev)
        else:
            with span("merge.refine"):
                info = global_refine(
                    model, max_iterations=cfg.merge.final_ba_iterations,
                    filter_max_reproj_error=cfg.mapper.filter_max_reproj_error,
                    intr_prior_weight_f=cfg.mapper.intr_prior_weight_f,
                    intr_prior_weight_k=cfg.mapper.intr_prior_weight_k,
                    dense_max_images=cfg.merge.final_ba_max_images, device=dev)
            if info:
                log.info("merge: final BA cost %.1f -> %.1f",
                         info["initial_cost"], info["final_cost"])
    model.compute_reprojection_errors()
    cb, ib, pb = colmap_io.model_to_bytes(model)
    store.write_table("models", {
        "model_id": np.zeros(1, np.int64),
        "cameras": [cb], "images": [ib], "points3d": [pb],
    }, meta={"stage": "merge", "num_registered": model.num_registered,
             "num_points": len(model.points3D),
             "mean_reproj_error": model.mean_reprojection_error(),
             "device": str(dev)})
    if export_path:
        colmap_io.write_model(model, export_path)
    log.info("merge: %d images, %d points", model.num_registered, len(model.points3D))
    return model


def load_model(store: ArtifactStore) -> Reconstruction:
    """The merged model of the ``models`` table."""
    tab = store.read_table("models")
    return colmap_io.model_from_bytes(tab["cameras"][0], tab["images"][0],
                                      tab["points3d"][0])


def cam_scales(store: ArtifactStore) -> Dict[int, float]:
    """Extraction downscale factor per image id (the camera's resolution
    basis), from one read of the extraction table."""
    ext = store.read_table("extraction", columns=["image_id", "camera"])
    return {int(i): float(row[4]) for i, row in zip(ext["image_id"], ext["camera"])}


def cam_scale_of(store: ArtifactStore, iid: int) -> float:
    """Extraction downscale factor of image ``iid``."""
    return cam_scales(store)[iid]


# ---------------------------------------------------------------------------
# COLMAP database interchange
# ---------------------------------------------------------------------------

def _has_pose(q, t) -> bool:
    """Whether a database row carries a relative pose. Stock COLMAP writes
    the identity rotation with a zero translation where it has none, so
    that placeholder, a missing or non-finite pose, and an all-zero qvec
    count as no pose (the JAX stage takes any non-zero qvec as a pose)."""
    if q is None or t is None:
        return False
    q, t = np.asarray(q, np.float64), np.asarray(t, np.float64)
    if q.shape != (4,) or t.shape != (3,) or not (np.isfinite(q).all() and np.isfinite(t).all()):
        return False
    identity = abs(abs(q[0]) - 1.0) <= 1e-9 and np.abs(q[1:]).max() <= 1e-9
    return bool(np.any(q != 0)) and not (identity and np.linalg.norm(t) <= 1e-9)


POSE_REBUILD_CHUNK = 64     # pairs per batched pose_from_essential call


def import_colmap_db(cfg: PipelineConfig, store: Optional[ArtifactStore] = None,
                     database_path: str = "", recompute_pose: bool = True,
                     device=None) -> int:
    """Import a COLMAP SQLite ``database.db`` as the ``frames``,
    ``extraction`` and ``matching`` tables, as stages 1-3 write them, so a
    dataset COLMAP has processed replays through mapping and merge. Images
    are ordered by name; their ids are kept. ``frames.path`` joins each
    name onto ``cfg.image_path``.

    The database stores no triangulation angle, and older schemas no
    relative pose; with ``recompute_pose`` both are rebuilt from E by
    cheirality voting (``pose_from_essential``, batched over the pairs, on
    ``device``) for every pair with a usable E. A stored pose is kept
    unless it is no pose (``_has_pose``: COLMAP's identity placeholder
    counts as none). Returns the number of imported pairs."""
    from scanner_colmap_tpu_torch.utils import colmap_db

    store = store or ArtifactStore(cfg.store_path)
    db = colmap_db.read_database(database_path)
    order = sorted(db["images"], key=lambda i: db["images"][i]["name"])
    max_np = max([camlib.MODEL_NUM_PARAMS[camlib.PINHOLE]]
                 + [camlib.MODEL_NUM_PARAMS.get(colmap_db._DOWNGRADE.get(c["model"], c["model"]), 4)
                    for c in db["cameras"].values()])
    downgraded = []
    kp_by_id: Dict[int, np.ndarray] = {}
    keypoints, descriptors, cam_rows = [], [], []
    widths, heights, names = [], [], []
    for iid in order:
        im = db["images"][iid]
        cam = db["cameras"][im["camera_id"]]
        model, params = cam["model"], np.asarray(cam["params"], np.float64)
        if model in colmap_db._DOWNGRADE:
            downgraded.append(im["name"])
            model = colmap_db._DOWNGRADE[model]
            params = params[:camlib.MODEL_NUM_PARAMS[model]]
        if model not in camlib.MODEL_NUM_PARAMS:
            raise ValueError(f"unsupported COLMAP camera model {model} for {im['name']}")
        kp4 = colmap_db._keypoints_to_xyso(
            np.asarray(db["keypoints"].get(iid, np.zeros((0, 2), np.float32))))
        kp_by_id[iid] = kp4
        keypoints.append(kp4)
        descriptors.append(np.asarray(
            db["descriptors"].get(iid, np.zeros((0, 128), np.uint8)), np.uint8))
        row = np.zeros(5 + max_np)
        row[0], row[1], row[2] = model, cam["width"], cam["height"]
        row[3] = 1.0 if cam["prior_focal_length"] else 0.0
        row[4] = 1.0                       # features at native resolution
        row[5:5 + len(params)] = params
        cam_rows.append(row)
        widths.append(cam["width"])
        heights.append(cam["height"])
        names.append(os.path.join(cfg.image_path or "", im["name"]).encode())

    store.write_table("frames", {
        "image_id": np.asarray(order, np.int64), "path": names,
        "width": np.asarray(widths, np.int32), "height": np.asarray(heights, np.int32),
    }, meta={"stage": "prepare_images", "image_path": cfg.image_path,
             "source": {"colmap_db": database_path}, "stride": 1})
    store.write_table("extraction", {
        "image_id": np.asarray(order, np.int64), "keypoints": keypoints,
        "descriptors": descriptors,
        "camera": np.stack(cam_rows) if cam_rows else np.zeros((0, 5 + max_np)),
    }, meta={"stage": "extraction",
             "source": {"colmap_db": database_path, "distortion_dropped": downgraded}})

    def K_of(iid):
        c = db["cameras"][db["images"][iid]["camera_id"]]
        p = np.asarray(c["params"])
        if c["model"] in (camlib.PINHOLE, colmap_db._OPENCV, colmap_db._FULL_OPENCV):
            return np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1.0]])
        return np.array([[p[0], 0, p[1]], [0, p[0], p[2]], [0, 0, 1.0]])

    pair_ids, tvg_rows, match_lists, rebuild = [], [], [], []
    n_identity = 0
    for (i1, i2), g in sorted(db["two_view_geometries"].items()):
        inl = np.asarray(g["inlier_matches"], np.int64).reshape(-1, 2)
        if len(inl) == 0 or g["config"] in (tv_ops.UNDEFINED, tv_ops.DEGENERATE):
            continue
        row = np.zeros(37)
        row[0], row[1] = g["config"], len(inl)
        has_pose = _has_pose(g.get("qvec"), g.get("tvec"))
        if has_pose:
            row[3:7], row[7:10] = g["qvec"], g["tvec"]
        elif g.get("qvec") is not None and np.any(np.asarray(g["qvec"]) != 0):
            n_identity += 1
        for sl, M in ((slice(10, 19), g["E"]), (slice(19, 28), g["F"]),
                      (slice(28, 37), g["H"])):
            if M is not None:
                row[sl] = np.asarray(M).ravel()
        if (recompute_pose and g["E"] is not None
                and np.linalg.norm(np.asarray(g["E"])) > 1e-8
                and g["config"] not in (tv_ops.UNDEFINED, tv_ops.DEGENERATE,
                                        tv_ops.UNCALIBRATED, tv_ops.WATERMARK)
                and len(inl) >= 5):
            rebuild.append((len(tvg_rows), i1, i2, inl, has_pose))
        pair_ids.append((i1, i2))
        tvg_rows.append(row)
        match_lists.append(inl.astype(np.int32))

    n_pose_rebuilt = 0
    if rebuild:
        dev = devlib.resolve(device)
        P = _round_up(max(len(r[3]) for r in rebuild), 256)
        C = POSE_REBUILD_CHUNK
        for c0 in range(0, len(rebuild), C):
            part = rebuild[c0:c0 + C]
            E = np.tile(np.eye(3), (C, 1, 1))
            x1n, x2n = np.zeros((C, P, 2)), np.zeros((C, P, 2))
            mask = np.zeros((C, P), bool)
            for n, (r, i1, i2, inl, _) in enumerate(part):
                E[n] = tvg_rows[r][10:19].reshape(3, 3)
                for x, iid, col in ((x1n, i1, 0), (x2n, i2, 1)):
                    h = np.concatenate([kp_by_id[iid][inl[:, col], :2],
                                        np.ones((len(inl), 1))], 1) @ np.linalg.inv(K_of(iid)).T
                    x[n, :len(inl)] = h[:, :2] / h[:, 2:]
                mask[n, :len(inl)] = True
            t = lambda a: torch.as_tensor(a, device=dev)     # noqa: E731
            q, tv, tri, _ = tv_ops.pose_from_essential(t(E), t(x1n), t(x2n), t(mask))
            q, tv, tri = q.cpu().numpy(), tv.cpu().numpy(), tri.cpu().numpy()
            for n, (r, _, _, _, has_pose) in enumerate(part):
                tvg_rows[r][2] = tri[n]
                if not has_pose:
                    tvg_rows[r][3:7], tvg_rows[r][7:10] = q[n], tv[n]
                    n_pose_rebuilt += 1

    store.write_table("matching", {
        "pair_image_ids": np.asarray(pair_ids, np.int64).reshape(-1, 2),
        "two_view_geometry": np.stack(tvg_rows) if tvg_rows else np.zeros((0, 37)),
        "matches": match_lists,
    }, meta={"stage": "matching",
             "source": {"colmap_db": database_path, "raw_match_pairs": len(db["matches"]),
                        "poses_rebuilt": n_pose_rebuilt,
                        "identity_poses_as_none": n_identity}})
    log.info("import_colmap_db: %d images, %d verified pairs (%d poses rebuilt from E)%s",
             len(order), len(pair_ids), n_pose_rebuilt,
             f", distortion dropped for {len(downgraded)} OPENCV images" if downgraded else "")
    return len(pair_ids)


def export_colmap_db(cfg: PipelineConfig, store: Optional[ArtifactStore] = None,
                     database_path: str = "") -> int:
    """Write the store's extraction and matching tables as a COLMAP
    ``database.db`` (the inverse of :func:`import_colmap_db`). With several
    rows for one pair (multiple models) the strongest row's geometry stands
    and the inlier matches are united. Returns the number of pairs."""
    from scanner_colmap_tpu_torch.utils import colmap_db

    store = store or ArtifactStore(cfg.store_path)
    image_ids, kp, desc, cams = _load_extraction(store)
    frames = store.read_table("frames", columns=["image_id", "path"])

    def db_name(p):
        # names are relative to the image directory, where the path lies in it
        p = p.decode() if isinstance(p, bytes) else str(p)
        base = cfg.image_path or ""
        if base and os.path.abspath(p).startswith(os.path.abspath(base) + os.sep):
            return os.path.relpath(p, base)
        return os.path.basename(p)

    name_of = {int(i): db_name(p) for i, p in zip(frames["image_id"], frames["path"])}
    cameras, images, keypoints, descriptors = {}, {}, {}, {}
    for iid in image_ids:
        model_id, params, w, h, prior = cams[iid]
        cameras[iid] = {"model": model_id, "width": w, "height": h,
                        "params": np.asarray(params, np.float64),
                        "prior_focal_length": prior}
        images[iid] = {"name": name_of.get(iid, f"image_{iid}"), "camera_id": iid}
        keypoints[iid] = np.asarray(kp[iid], np.float32)
        descriptors[iid] = np.asarray(desc[iid], np.uint8)

    mt = store.read_table("matching")
    pids = np.asarray(mt["pair_image_ids"], np.int64).reshape(-1, 2)
    matches, tvgs, strength = {}, {}, {}
    for n in range(len(pids)):
        key = (int(pids[n, 0]), int(pids[n, 1]))
        row = np.asarray(mt["two_view_geometry"][n], np.float64)
        inl = np.asarray(mt["matches"][n], np.uint32).reshape(-1, 2)
        if key in tvgs:
            inl = np.unique(np.concatenate([tvgs[key]["inlier_matches"], inl]), axis=0)
            if row[1] <= strength[key]:
                tvgs[key]["inlier_matches"] = matches[key] = inl
                continue
        matches[key] = inl
        strength[key] = row[1]
        tvgs[key] = {"config": int(row[0]), "inlier_matches": inl,
                     "qvec": row[3:7], "tvec": row[7:10], "E": row[10:19].reshape(3, 3),
                     "F": row[19:28].reshape(3, 3), "H": row[28:37].reshape(3, 3)}
    colmap_db.write_database(database_path, cameras, images, keypoints, descriptors,
                             matches, tvgs)
    log.info("export_colmap_db: %d images, %d pairs -> %s", len(image_ids), len(tvgs),
             database_path)
    return len(tvgs)


# ---------------------------------------------------------------------------
# the dense stages: undistort, prepare_patch_match, patch_match, fusion,
# meshing
# ---------------------------------------------------------------------------

def _frame_loader(store: ArtifactStore):
    """A function (image_id, max_image_size, canvas) -> the frame as
    extraction loads it (uint8 canvas, valid (h, w), downscale factor):
    from its file, or for in-memory frames downscaled from the table's
    pixels the same way (PIL bilinear, then 8-bit levels)."""
    frames = store.read_table("frames")
    rows = {int(i): n for n, i in enumerate(frames["image_id"])}
    in_memory = "pixels" in frames

    def load(iid: int, max_image_size: int, canvas):
        n = rows[iid]
        if not in_memory:
            return image_ops.load_for_extraction(frames["path"][n].decode(),
                                                 max_image_size, canvas)
        h, w = int(frames["height"][n]), int(frames["width"][n])
        with span("image.decode"):
            gray = np.asarray(frames["pixels"][n]).reshape(h, w).astype(np.float32) / 255.0
            gray, scale = image_ops.resize_max(gray, max_image_size)
        out = image_ops.pad_to_canvas(gray, canvas)
        return {"image": np.clip(np.round(out * 255.0), 0, 255).astype(np.uint8),
                "valid_hw": np.array(gray.shape[:2], np.int32), "scale": scale}
    return load


def run_undistort(cfg: PipelineConfig, store: Optional[ArtifactStore] = None,
                  output_path: Optional[str] = None, device=None) -> int:
    """Undistort every registered image to an ideal pinhole camera and write
    a dense workspace: PNGs under ``<output_path>/images`` and the PINHOLE
    model under ``<output_path>/sparse`` (default ``<store>/undistort_ws``).
    Images are remapped 8 a batch on ``device``, with one uint8 download
    per batch."""
    from PIL import Image as PILImage

    store = store or ArtifactStore(cfg.store_path)
    dev = devlib.resolve(device)
    model = load_model(store)
    load = _frame_loader(store)
    # not "<root>/undistorted": that is the stage's table directory
    out_root = output_path or os.path.join(store.root, "undistort_ws")
    img_dir = os.path.join(out_root, "images")
    os.makedirs(img_dir, exist_ok=True)

    reg = sorted(model.registered_image_ids)
    if not reg:
        store.write_table("undistorted", {
            "image_id": np.zeros(0, np.int64), "path": [],
            "new_params": np.zeros((0, 4), np.float64)}, meta={"stage": "undistort"})
        return 0
    canvas = (_round_up(cfg.sift.max_image_size, 32),) * 2
    new_model = model.copy()
    scale_of = cam_scales(store)
    batch, out_paths, out_ids, out_params = [], [], [], []

    def flush():
        if not batch:
            return
        imgs, mids, prms, nprm = (np.stack([b[k] for b in batch]) for k in range(4))
        out, _ = ud_ops.undistort_batch(
            torch.as_tensor(imgs, device=dev), torch.as_tensor(mids, device=dev),
            torch.as_tensor(prms, device=dev), torch.as_tensor(nprm, device=dev))
        # one uint8 download per batch
        out = torch.clamp(out * 255.0, 0.0, 255.0).to(torch.uint8).cpu().numpy()
        for k, (_, _, _, new_p, iid, h, w) in enumerate(batch):
            p = os.path.join(img_dir, f"image_{iid:06d}.png")
            PILImage.fromarray(out[k][:h, :w]).save(p)
            out_paths.append(p.encode())
            out_ids.append(iid)
            out_params.append(new_p)
        batch.clear()

    for iid in reg:
        im = model.images[iid]
        cam = model.cameras[im.camera_id]
        item = load(iid, cfg.sift.max_image_size, canvas)
        # params live at extraction resolution; rescale to this load's scale
        s = item["scale"] / scale_of[iid]
        scaled = np.asarray(cam.params_padded, np.float64).copy()
        n_f = 1 if cam.model_id in (camlib.SIMPLE_PINHOLE, camlib.SIMPLE_RADIAL,
                                    camlib.RADIAL) else 2
        scaled[:n_f + 2] *= s  # focal(s) and principal point scale together
        new_p = ud_ops.undistorted_pinhole_params(cam.model_id, scaled)
        h, w = int(item["valid_hw"][0]), int(item["valid_hw"][1])
        batch.append((item["image"].astype(np.float32) / 255.0, np.int32(cam.model_id),
                      scaled, new_p, iid, h, w))
        # the exported model's camera is per image: resolutions may differ
        new_model.cameras[im.camera_id] = type(cam)(
            cam.camera_id, camlib.PINHOLE, w, h, np.asarray(new_p, np.float64), cam.prior_focal)
        if len(batch) >= 8:
            flush()
    flush()
    colmap_io.write_model(new_model, os.path.join(out_root, "sparse"))
    store.write_table("undistorted", {
        "image_id": np.asarray(out_ids, np.int64), "path": out_paths,
        "new_params": np.stack(out_params),
    }, meta={"stage": "undistort", "output_path": out_root})
    log.info("undistort: %d images -> %s", len(out_ids), out_root)
    return len(out_ids)


def run_prepare_patch_match(cfg: PipelineConfig, store: Optional[ArtifactStore] = None) -> int:
    """Per registered image the MVS geometry: R, T, K (rescaled to the
    bitmap), the bitmap at ``patch_match.max_image_size``, and the depth
    range from the 2nd and 98th percentiles of its sparse points' depths
    (widened by the config's factors); images with fewer than 5 points in
    front are left out. Host work only."""
    store = store or ArtifactStore(cfg.store_path)
    model = load_model(store)
    load = _frame_loader(store)
    pm = cfg.patch_match
    canvas = (_round_up(pm.max_image_size, 32),) * 2
    rows = {"image_id": [], "R": [], "T": [], "K": [], "width": [],
            "height": [], "bitmap": [], "depth_min": [], "depth_max": []}
    scale_of = cam_scales(store)
    for iid in sorted(model.registered_image_ids):
        im = model.images[iid]
        cam = model.cameras[im.camera_id]
        with span("prepare_patch_match.depth_ranges"):
            # the observed points in keypoint order, in one pose transform:
            # each depth is bitwise the per-point transform's
            ids = np.asarray(im.point3D_ids)
            pts = model.points3D
            xyz = np.array([pts[p].xyz for p in ids[ids >= 0].tolist() if p in pts],
                           np.float64).reshape(-1, 3)
            z = geom.np_pose_transform(im.qvec, im.tvec, xyz)[:, 2]
            d = z[z > 0]
            count("prepare_patch_match.depth_points", len(d))
        if len(d) < 5:
            continue
        item = load(iid, pm.max_image_size, canvas)
        h, w = int(item["valid_hw"][0]), int(item["valid_hw"][1])
        # the camera was built at extraction resolution
        s_mvs = item["scale"] / scale_of[iid]
        K = _cam_K((cam.model_id, list(cam.params), cam.width, cam.height, cam.prior_focal))
        K = K * np.array([[s_mvs], [s_mvs], [1.0]])
        rows["image_id"].append(iid)
        rows["R"].append(geom.np_quat_to_rotmat(im.qvec).astype(np.float32).ravel())
        rows["T"].append(np.asarray(im.tvec, np.float32))
        rows["K"].append(K.astype(np.float32).ravel())
        rows["width"].append(w)
        rows["height"].append(h)
        rows["bitmap"].append(item["image"].astype(np.float32) / 255.0)
        rows["depth_min"].append(float(np.percentile(d, 2) * pm.depth_min_factor))
        rows["depth_max"].append(float(np.percentile(d, 98) * pm.depth_max_factor))

    def stack(key, width):
        return np.stack(rows[key]) if rows[key] else np.zeros((0, width), np.float32)

    store.write_table("prepare_patch_match", {
        "image_id": np.asarray(rows["image_id"], np.int64),
        "R": stack("R", 9), "T": stack("T", 3), "K": stack("K", 9),
        "width": np.asarray(rows["width"], np.int32),
        "height": np.asarray(rows["height"], np.int32),
        "bitmap": rows["bitmap"],
        "depth_min": np.asarray(rows["depth_min"], np.float64),
        "depth_max": np.asarray(rows["depth_max"], np.float64),
    }, meta={"stage": "prepare_patch_match", "canvas": list(canvas)})
    log.info("prepare_patch_match: %d images", len(rows["image_id"]))
    return len(rows["image_id"])


def _half(bm: np.ndarray) -> np.ndarray:
    """2x2 box downsample (the coarse pass's bitmaps)."""
    h2, w2 = bm.shape[0] // 2, bm.shape[1] // 2
    return 0.25 * (bm[: 2 * h2: 2, : 2 * w2: 2] + bm[1: 2 * h2: 2, : 2 * w2: 2]
                   + bm[: 2 * h2: 2, 1: 2 * w2: 2] + bm[1: 2 * h2: 2, 1: 2 * w2: 2])


def run_patch_match(cfg: PipelineConfig, store: Optional[ArtifactStore] = None,
                    ref_slice: Optional[tuple] = None, out_table: str = "patch_match",
                    device=None) -> int:
    """PatchMatch depth, normal and cost maps per reference image, with a
    symmetric window of ``patch_match.overlap`` source views, on ``device``.

    With ``coarse_to_fine``, a half-resolution pass with the full sweep
    budget, then ``fine_iterations`` sweeps at full resolution from the
    upsampled field; with ``geom_consistency``, a second pass with the
    geometric term, warm-started from the first and fed the neighbours'
    depth maps. Large canvases are solved in row bands (``tile_rows``,
    ``tile_auto_px``). The fields stay on the device between passes, and
    the maps are written as f32.

    ref_slice=(k, nproc) computes the k-th contiguous block of reference
    images and writes only the block; with the geometric pass, the block is
    extended by the source window (the halo), so the pass has its
    neighbours' first-pass maps. Each
    (pass, ref, band) draws from its own generator, seeded from those
    indices alone, so a depth map is bitwise the same in a full run, a
    ``ref_slice`` run and a rerun. A failure raises: no image is dropped."""
    store = store or ArtifactStore(cfg.store_path)
    dev = devlib.resolve(device)
    tab = store.read_table("prepare_patch_match")
    pm = cfg.patch_match
    n = len(tab["image_id"])
    if n == 0:
        store.write_table(out_table, {
            "image_id": np.zeros(0, np.int64), "depth_map": [],
            "normal_map": [], "cost_map": []}, meta={"stage": "patch_match"})
        return 0
    canvas_h = _round_up(max(int(h) for h in tab["height"]), 32)
    canvas_w = _round_up(max(int(w) for w in tab["width"]), 32)
    Rm = np.asarray(tab["R"], np.float32).reshape(n, 3, 3)
    Tm = np.asarray(tab["T"], np.float32).reshape(n, 3)
    Km = np.asarray(tab["K"], np.float32).reshape(n, 3, 3)
    S = pm.overlap

    if ref_slice is not None:
        k_blk, nproc = ref_slice
        bounds = np.linspace(0, n, nproc + 1).astype(int)
        core = set(range(bounds[k_blk], bounds[k_blk + 1]))
        # the geometric pass needs the neighbours' first-pass maps
        halo = max(0, S // 2 + S % 2) if pm.geom_consistency else 0
        compute = set(range(max(0, bounds[k_blk] - halo), min(n, bounds[k_blk + 1] + halo)))
    else:
        core = compute = set(range(n))

    def window(ref):
        # the symmetric stencil around ref
        return [s for s in range(max(0, ref - S // 2), min(n, ref + S // 2 + S % 2 + 1))
                if s != ref][:S]

    # the coarse canvas (half resolution, 32-aligned)
    ch2 = _round_up((canvas_h + 1) // 2, 32)
    cw2 = _round_up((canvas_w + 1) // 2, 32)

    def bitmap(i, ds):
        h, w = int(tab["height"][i]), int(tab["width"][i])
        bm = np.asarray(tab["bitmap"][i])[:h, :w]     # stored canvas-padded
        return _half(bm) if ds == 2 else bm

    def build_problem(ref, ds):
        CH, CW = (canvas_h, canvas_w) if ds == 1 else (ch2, cw2)
        src_imgs = np.zeros((S, CH, CW), np.float32)
        Ks = np.tile(np.eye(3, dtype=np.float32), (S, 1, 1))
        Rs = np.tile(np.eye(3, dtype=np.float32), (S, 1, 1))
        ts = np.zeros((S, 3), np.float32)
        src_valid = np.zeros(S, bool)
        for si, s in enumerate(window(ref)):
            bm = bitmap(s, ds)
            src_imgs[si, :bm.shape[0], :bm.shape[1]] = bm
            Ks[si] = Km[s]
            if ds == 2:
                Ks[si][:2, :] *= 0.5
            # relative pose ref camera -> source camera
            Rs[si] = Rm[s] @ Rm[ref].T
            ts[si] = Tm[s] - Rs[si] @ Tm[ref]
            src_valid[si] = True
        ref_bm = bitmap(ref, ds)
        ref_img = np.zeros((CH, CW), np.float32)
        ref_img[:ref_bm.shape[0], :ref_bm.shape[1]] = ref_bm
        K_ref = Km[ref].copy()
        if ds == 2:
            K_ref[:2, :] *= 0.5
        up = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        return pm_ops.PatchMatchProblem(
            ref_image=up(ref_img), src_images=up(src_imgs), K_ref=up(K_ref), K_src=up(Ks),
            R=up(Rs), t=up(ts), depth_min=float(np.float32(tab["depth_min"][ref])),
            depth_max=float(np.float32(tab["depth_max"][ref])), src_valid=up(src_valid))

    def run_pass(refs, pass_idx=0, ds=1, iters=None, init=None, banks=None):
        """One sweep over ``refs``; ``init`` (depths, normals) warm-starts
        each ref, ``banks`` (depths, normals) runs the geometric pass."""
        CH, CW = (canvas_h, canvas_w) if ds == 1 else (ch2, cw2)
        if pm.tile_rows < 0:
            tile = 0
        elif pm.tile_rows > 0:
            tile = pm.tile_rows
        else:
            tile = pm.tile_auto_rows if CH * CW > pm.tile_auto_px else 0
        out = {}
        for ref in sorted(refs):
            kwargs = {}
            if banks is not None:
                if ref not in banks[0]:
                    continue
                src_d = torch.zeros((S, canvas_h, canvas_w), dtype=torch.float32, device=dev)
                for si, s in enumerate(window(ref)):
                    if s in banks[0]:
                        src_d[si] = banks[0][s]
                kwargs = dict(src_depths=src_d, geom_weight=pm.geom_weight,
                              max_geom_error=pm.max_geom_error,
                              init_depth=banks[0][ref], init_normal=banks[1][ref])
            elif init is not None and ref in init[0]:
                kwargs = dict(init_depth=init[0][ref], init_normal=init[1][ref])
            with span("patch_match.map"):
                out[ref] = pm_ops.patch_match_tiled(
                    build_problem(ref, ds), tile_rows=tile, halo_rows=pm.tile_halo,
                    seed=(pass_idx, ref), num_iterations=iters or pm.num_iterations,
                    window_radius=pm.window_radius, sigma_spatial=pm.sigma_spatial,
                    sigma_color=pm.sigma_color, sampling=pm.sampling, **kwargs)
        return ({r: o[0] for r, o in out.items()}, {r: o[1] for r, o in out.items()},
                {r: o[2] for r, o in out.items()})

    if pm.coarse_to_fine:
        # half resolution with the full sweep budget (each sweep reaches
        # twice as far in full-resolution pixels), then a short full
        # resolution refinement from the upsampled field
        dc, nc, _ = run_pass(compute, pass_idx=2, ds=2)

        def up2(a):
            return a.repeat_interleave(2, 0).repeat_interleave(2, 1)[:canvas_h, :canvas_w]

        init = ({r: up2(d).contiguous() for r, d in dc.items()},
                {r: up2(nm).contiguous() for r, nm in nc.items()})
        d_bank, n_bank, c_bank = run_pass(compute, iters=pm.fine_iterations, init=init)
    else:
        d_bank, n_bank, c_bank = run_pass(compute)
    if pm.geom_consistency:
        # COLMAP's second pass: photometric and geometric cost
        d_bank, n_bank, c_bank = run_pass(core, pass_idx=1, banks=(d_bank, n_bank))

    depth_maps, normal_maps, cost_maps, out_ids = [], [], [], []
    for ref in sorted(core):
        if ref not in d_bank:
            continue
        h, w = int(tab["height"][ref]), int(tab["width"][ref])
        depth_maps.append(d_bank[ref][:h, :w].cpu().numpy())
        normal_maps.append(n_bank[ref][:h, :w].cpu().numpy())
        cost_maps.append(c_bank[ref][:h, :w].cpu().numpy())
        out_ids.append(int(tab["image_id"][ref]))
    store.write_table(out_table, {
        "image_id": np.asarray(out_ids, np.int64), "depth_map": depth_maps,
        "normal_map": normal_maps, "cost_map": cost_maps,
    }, meta={"stage": "patch_match", "config": vars(pm), "device": str(dev)})
    log.info("patch_match: %d depth maps", len(out_ids))
    return len(out_ids)


def _load_fusion_input(cfg: PipelineConfig, store: ArtifactStore, device):
    """The padded per-view depth, normal, color and pose tensors of fusion
    and meshing, from the patch_match and prepare_patch_match tables, on
    ``device``. Returns (FusionInput, ids); ids is empty without depth
    maps. A pixel is valid where its cost is below 2 - filter_min_ncc
    (plus geom_weight after a geometric pass)."""
    pm_tab = store.read_table("patch_match")
    prep = store.read_table("prepare_patch_match")
    ids = [int(i) for i in pm_tab["image_id"]]
    if not ids:
        return None, []
    prep_ids = [int(i) for i in prep["image_id"]]
    H = max(d.shape[0] for d in pm_tab["depth_map"])
    W = max(d.shape[1] for d in pm_tab["depth_map"])
    N = len(ids)
    depths = np.zeros((N, H, W), np.float32)
    normals = np.zeros((N, H, W, 3), np.float32)
    colors = np.zeros((N, H, W, 3), np.float32)
    valid = np.zeros((N, H, W), bool)
    qvecs, tvecs, Ks = np.zeros((N, 4)), np.zeros((N, 3)), np.zeros((N, 3, 3))
    thr = 2.0 - cfg.patch_match.filter_min_ncc
    if cfg.patch_match.geom_consistency:
        thr += cfg.patch_match.geom_weight
    for n, iid in enumerate(ids):
        pidx = prep_ids.index(iid)
        d = np.asarray(pm_tab["depth_map"][n])
        h, w = d.shape
        depths[n, :h, :w] = d
        normals[n, :h, :w] = np.asarray(pm_tab["normal_map"][n])
        colors[n, :h, :w] = np.asarray(prep["bitmap"][pidx])[:h, :w, None]
        valid[n, :h, :w] = np.asarray(pm_tab["cost_map"][n]) < thr
        qvecs[n] = geom.np_rotmat_to_quat(np.asarray(prep["R"][pidx]).reshape(3, 3))
        tvecs[n] = prep["T"][pidx]
        Ks[n] = np.asarray(prep["K"][pidx]).reshape(3, 3)
    up = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return fusion_ops.FusionInput(depths=up(depths), normals=up(normals), colors=up(colors),
                                  qvecs=up(qvecs), tvecs=up(tvecs), Ks=up(Ks),
                                  valid=up(valid)), ids


def run_fusion(cfg: PipelineConfig, store: Optional[ArtifactStore] = None,
               ply_path: Optional[str] = None, device=None) -> int:
    """Fuse the depth maps into a colored point cloud on ``device``
    (``ops/fusion.py``); ``fusion.window`` 0 votes over twice the
    PatchMatch window, -1 over all pairs."""
    store = store or ArtifactStore(cfg.store_path)
    dev = devlib.resolve(device)
    fu = cfg.fusion
    inp, ids = _load_fusion_input(cfg, store, dev)
    if not ids:
        store.write_table("fused", {
            "xyz": np.zeros((0, 3), np.float32), "rgb": np.zeros((0, 3), np.uint8),
            "normal": np.zeros((0, 3), np.float32),
            "num_consistent": np.zeros(0, np.int32)}, meta={"stage": "fusion"})
        return 0
    win = 2 * cfg.patch_match.overlap if fu.window == 0 else (None if fu.window < 0
                                                              else fu.window)
    out = fusion_ops.fuse_depth_maps(
        inp, max_depth_error=fu.max_depth_error,
        max_normal_error_rad=math.radians(fu.max_normal_error_deg),
        min_num_consistent=fu.min_num_consistent, window=win)
    pts = fusion_ops.compact_fused_points_device(out)
    store.write_table("fused", {
        "xyz": pts["xyz"].astype(np.float32),
        "rgb": np.clip(pts["rgb"] * 255, 0, 255).astype(np.uint8),
        "normal": pts["normal"].astype(np.float32),
        "num_consistent": pts["num_consistent"].astype(np.int32),
        "visibility": pts["visibility"],
    }, meta={"stage": "fusion", "device": str(dev)})
    if ply_path:
        fusion_ops.write_ply(ply_path, pts["xyz"], pts["rgb"], pts["normal"])
    log.info("fusion: %d points", len(pts["xyz"]))
    return len(pts["xyz"])


def run_meshing(cfg: PipelineConfig, store: Optional[ArtifactStore] = None,
                mesh_path: Optional[str] = None, device=None) -> int:
    """A surface mesh from the depth maps: TSDF fusion on ``device`` over
    the fused cloud's robust percentile box, then marching tetrahedra on
    the host (``ops/meshing.py``). Fusion must run first."""
    store = store or ArtifactStore(cfg.store_path)
    dev = devlib.resolve(device)
    me = cfg.meshing

    def write_empty():
        # a single-row table of ragged cells
        store.write_table("mesh", {
            "verts": [np.zeros((0, 3), np.float32)], "faces": [np.zeros((0, 3), np.int32)],
            "rgb": [np.zeros((0, 3), np.uint8)]}, meta={"stage": "meshing"})
        return 0

    inp, ids = _load_fusion_input(cfg, store, dev)
    if not ids:
        return write_empty()
    xyz = np.asarray(store.read_table("fused")["xyz"])
    if len(xyz) < 16:
        return write_empty()
    p = me.bounds_percentile
    origin, voxel, dims = meshing_ops.grid_from_bounds(
        np.percentile(xyz, p, axis=0), np.percentile(xyz, 100 - p, axis=0),
        resolution=me.resolution, margin_voxels=me.margin_voxels)
    with span("meshing.tsdf"):
        grid = meshing_ops.fuse_tsdf(inp, origin, voxel, dims, trunc_voxels=me.trunc_voxels)
    with span("meshing.extract"):
        verts, faces, rgb = meshing_ops.marching_tetrahedra(grid, min_weight=me.min_weight)
    store.write_table("mesh", {
        "verts": [verts.astype(np.float32)], "faces": [faces.astype(np.int32)],
        "rgb": [np.clip(rgb * 255, 0, 255).astype(np.uint8)],
    }, meta={"stage": "meshing", "dims": list(dims), "voxel": float(voxel),
             "device": str(dev)})
    if mesh_path and len(faces):
        meshing_ops.write_ply_mesh(mesh_path, verts, faces, rgb)
    log.info("meshing: %d verts / %d faces on %s grid", len(verts), len(faces), dims)
    return len(faces)


# ---------------------------------------------------------------------------
# the whole run
# ---------------------------------------------------------------------------


def _run_stage(name: str, fn, store: ArtifactStore, dev, profile_dir, metrics):
    """Run one stage of ``run_all`` with ``name`` open in ``metrics`` and
    record there its wall time (after the card's queue drains), the
    kernels' launches, on the card its peak allocated memory (and the
    run's, ``run.peak_allocated_mib``) and, with ``profile_dir``, the
    device's kernels and busy time from a ``torch.profiler`` trace of the
    stage (``<profile_dir>/<name>/trace.json``). The metrics, the spans and
    counters of the stage among them, are written to
    ``<store>/metrics.json`` after every stage."""
    from scanner_colmap_tpu_torch import kernels

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    before = kernels.launch_counts()
    trace = {}
    metrics.set_stage(name)
    t0 = time.perf_counter()
    try:
        with metrics_lib.device_trace(profile_dir and os.path.join(profile_dir, name), trace):
            out = fn()
            if cuda:
                torch.cuda.synchronize(dev)
    finally:
        metrics.set_stage(None)
    metrics.set(name, "wall_s", time.perf_counter() - t0)
    for k, v in kernels.launch_counts().items():
        metrics.set(name, f"launches.{k}", v - before[k])
    if cuda:
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        metrics.set(name, "peak_allocated_mib", peak)
        run_peak = metrics.stage(metrics_lib.RUN).get("peak_allocated_mib", 0.0)
        metrics.set(metrics_lib.RUN, "peak_allocated_mib", max(peak, run_peak))
    for k, v in trace.items():
        metrics.set(name, k, v)
    metrics.dump(os.path.join(store.root, "metrics.json"))
    return out


def run_all(cfg: PipelineConfig, export_path: Optional[str] = None,
            ply_path: Optional[str] = None, dense: bool = True,
            resume: bool = False, mesh_path: Optional[str] = None,
            mesh: bool = True, device=None, profile_dir: Optional[str] = None):
    """The whole pipeline (JAX ``run_all``) on ``device``: prepare_images,
    extraction, matching, mapping and merge, then with ``dense``
    prepare_patch_match, patch_match, fusion (``ply_path``: the cloud as
    PLY) and with ``mesh`` meshing (``mesh_path``). With ``resume``, a stage
    whose output table exists is skipped, and the model is read back from
    the ``models`` table when the merge is. Each stage's time, launches and
    peak memory go to ``<store>/metrics.json`` (``_run_stage``), and so do
    the program's spans and counters (``utils/metrics.span``, ``count``)
    while tracing is on: with ``utils.metrics.set_tracing(True)``, with
    ``profile_dir``, or for the whole run when it starts under a running
    ``torch.profiler``. ``GLOBAL_METRICS`` holds the run's metrics until
    the next run."""
    store = ArtifactStore(cfg.store_path)
    dev = devlib.resolve(device)
    steps = [("frames", "prepare_images", lambda: prepare_images(cfg, store)),
             ("extraction", "extraction", lambda: run_extraction(cfg, store, device=dev)),
             ("matching", "matching", lambda: run_matching(cfg, store, device=dev)),
             ("mapping", "mapping", lambda: run_mapping(cfg, store, device=dev)),
             ("models", "merge", lambda: run_merge(cfg, store, export_path=export_path,
                                                   device=dev))]
    if dense:
        steps += [("prepare_patch_match", "prepare_patch_match",
                   lambda: run_prepare_patch_match(cfg, store)),
                  ("patch_match", "patch_match", lambda: run_patch_match(cfg, store, device=dev)),
                  ("fused", "fusion", lambda: run_fusion(cfg, store, ply_path=ply_path,
                                                         device=dev))]
        if mesh:
            steps.append(("mesh", "meshing", lambda: run_meshing(cfg, store, mesh_path=mesh_path,
                                                                 device=dev)))
    metrics = metrics_lib.GLOBAL_METRICS
    metrics.reset()
    # a run that a profiler watches records the program's spans beside it
    was = metrics_lib.set_tracing(metrics_lib.tracing() or metrics_lib.profiler_running())
    try:
        model = None
        for table, name, fn in steps:
            if resume and store.has_table(table):
                log.info("run_all: %s table exists, %s skipped", table, name)
                continue
            out = _run_stage(name, fn, store, dev, profile_dir, metrics)
            if table == "models":
                model = out
        return model if model is not None else load_model(store)
    finally:
        metrics_lib.set_tracing(was)
