"""One run of one cell: set-up, the measured window, the check.

Set-up (``setup_s``): import torch and require the card; load the kernels
(the program builds them into its own directory in the checkout at first
use); render the cell's collection from the seed on the device and write
it as EXIF-tagged JPEGs into a directory under ``$TMPDIR``; reconstruct it
once at the cell's own shapes as the warm-up. The window then reconstructs
the collection again and again through ``stages.run_all`` (the program's
``cli all`` path, JPEG decode included), each pass into a fresh store that
the next pass replaces, until ``--seconds`` have passed; the pass in
flight is finished and counted. ``images_per_s`` is the images registered
in the merged models of all the window's passes over the window's wall
time. With ``--trace 1`` one more pass runs under ``torch.profiler`` once
the window has closed: the device metrics (activities, rooflines, idle
share) are read from it, and the stage metrics from the untraced window's
spans, which the profiler's overhead does not lengthen.

Once the window has closed and the peak memory has been read, the
reference (``reference/judge.py``) judges every pass's outputs against the
scene's ground truth.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import numpy as np

from benchmark.gen import scene as scene_mod
from benchmark.harness import cell as cell_mod
from benchmark.harness.record import Recorder
from benchmark.harness.trace import PASS_SPAN, TraceView
from benchmark.reference import judge

FORBIDDEN = ("jax", "jaxlib", "flax", "scanner_colmap_tpu")
OUT_DIR = "benchmark_out"      # the traced pass's spans and key averages, in the checkout
HOST_THREADS = 4               # the program's host thread pools (torch, OpenMP, BLAS)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, from nvidia-smi."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


# ---------------------------------------------------------------------------
# the collection
# ---------------------------------------------------------------------------

def make_collection(cell, seed: int, image_dir: str, device):
    """Render the cell's collection from the seed, write its JPEGs; return
    the ground truth the reference judges against."""
    fr, sc = cell.config["frames"], cell.config["scene"]
    scene = scene_mod.make_scene(fr["num_images"], seed, sc["num_blobs"], sc["depth0"],
                                 sc["depth_spread"], cell.traffic["track"],
                                 sc["blob_size_scale"])
    from benchmark.gen.render_torch import render_torch

    frames = render_torch(scene, fr["width"], fr["height"], fr["focal_px"], device).cpu().numpy()
    os.makedirs(image_dir, exist_ok=True)
    scene_mod.write_jpegs(image_dir, frames, fr["focal_px"], fr["width"])
    return {"qvecs": scene["qvecs"], "tvecs": scene["tvecs"], "depth0": scene["depth0"],
            "depth_spread": scene["depth_spread"]}


# ---------------------------------------------------------------------------
# one pass
# ---------------------------------------------------------------------------

def model_arrays(model) -> dict:
    """The merged model as plain arrays, for the reference."""
    ids = sorted(model.registered_image_ids)
    pids = np.asarray(sorted(model.points3D), np.int64)
    row = {int(p): n for n, p in enumerate(pids)}
    obs_img, obs_xy, obs_pt = [], [], []
    cams = {}
    for iid in ids:
        im = model.images[iid]
        cam = model.cameras[im.camera_id]
        cams[int(iid)] = (int(cam.model_id), np.asarray(cam.params, np.float64))
        for k, pid in enumerate(np.asarray(im.point3D_ids)):
            if pid >= 0 and int(pid) in row:
                obs_img.append(iid)
                obs_xy.append(im.xys[k])
                obs_pt.append(row[int(pid)])
    return {"image_ids": np.asarray(ids, np.int64),
            "qvecs": np.asarray([model.images[i].qvec for i in ids], np.float64).reshape(-1, 4),
            "tvecs": np.asarray([model.images[i].tvec for i in ids], np.float64).reshape(-1, 3),
            "cameras": cams,
            "points": np.asarray([model.points3D[int(p)].xyz for p in pids],
                                 np.float64).reshape(-1, 3),
            "obs_image": np.asarray(obs_img, np.int64),
            "obs_xy": np.asarray(obs_xy, np.float64).reshape(-1, 2),
            "obs_point": np.asarray(obs_pt, np.int64)}


def run_pass(cfg, store_dir, traffic, device, recorder, n_images, tapping=False,
             keep_store=False):
    """One reconstruction of the collection into a fresh store; its
    outputs as plain arrays, its registered and failed images. The store
    is deleted afterwards, unless ``keep_store``."""
    import torch

    from scanner_colmap_tpu_torch.pipeline import stages
    from scanner_colmap_tpu_torch.utils.store import ArtifactStore

    dense = bool(traffic.get("dense", False))
    shutil.rmtree(store_dir, ignore_errors=True)
    cfg.store_path = store_dir
    recorder.begin_pass(tapping)
    out = {"registered": 0, "failed": n_images, "model": None}
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(PASS_SPAN):
            model = stages.run_all(cfg, dense=dense, mesh=bool(traffic.get("mesh", False)),
                                   device=device)
        out["model"] = model_arrays(model)
        reg = set(int(i) for i in out["model"]["image_ids"])
        out["registered"] = len(reg)
        out["failed"] = n_images - len(reg)
        if dense:
            store = ArtifactStore(store_dir)
            fused = set(int(i) for i in store.read_table("patch_match", ["image_id"])["image_id"])
            out["failed"] += len(reg - fused)
            out["fused_xyz"] = np.asarray(store.read_table("fused", ["xyz"])["xyz"], np.float32)
            if traffic.get("mesh", False):
                out["mesh_verts"] = np.asarray(store.read_table("mesh", ["verts"])["verts"][0],
                                               np.float32)
    except Exception:     # a pass that raises counts all its images failed
        traceback.print_exc(file=sys.stderr)
        out["error"] = traceback.format_exc(limit=3)
    out["wall_s"] = time.perf_counter() - t0
    out["spans"] = list(recorder.spans)
    if not keep_store:
        shutil.rmtree(store_dir, ignore_errors=True)
    return out


def judge_pass(p: dict, truth: dict, control: bool = False) -> dict:
    """The reference's numbers of one pass; with ``control``, of its
    outputs served in bfloat16."""
    if p["model"] is None:
        return {}
    model = dict(p["model"])
    fused, mesh = p.get("fused_xyz"), p.get("mesh_verts")
    if control:
        for k in ("qvecs", "tvecs", "points"):
            model[k] = judge.to_bf16(model[k])
        fused = None if fused is None else judge.to_bf16(fused)
        mesh = None if mesh is None else judge.to_bf16(mesh)
    return judge.judge(model, truth, fused, mesh)


def worst(numbers: list) -> dict:
    """Each number's worst (largest) reading over the passes; a pass with
    no reading reads infinity."""
    keys = set().union(*numbers) if numbers else set()
    return {k: max(n.get(k, float("inf")) for n in numbers) for k in keys}


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """Set-up, window and check of one run, on ``device``. Returns what
    the result line is made of, the checks as (number, reading, limit)
    rows."""
    import torch

    from scanner_colmap_tpu_torch import kernels

    dev = torch.device(device)
    torch.manual_seed(seed)
    if dev.type == "cuda":
        torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", HOST_THREADS)))
    work = tempfile.mkdtemp(prefix="bench-")
    try:
        truth = make_collection(cell, seed, os.path.join(work, "images"), dev)
        log(f"collection ready at {time.perf_counter() - t_start:.1f} s")
        n_img = cell.config["frames"]["num_images"]
        cfg = cell_mod.pipeline_config(cell, os.path.join(work, "images"))
        recorder = Recorder(dev)
        with recorder.installed():
            warm = run_pass(cfg, os.path.join(work, "store"), cell.traffic, dev, recorder,
                            n_img, tapping=trace)
            tapped = recorder.work() if trace else {}
            tapped_calls = {k: len(v) for k, v in tapped.items()}
            if warm["model"] is None:
                raise RuntimeError("the warm-up pass failed")
            warm = None
            gc.collect()
            setup_s = time.perf_counter() - t_start
            passes = []
            t0 = time.perf_counter()
            while True:
                passes.append(run_pass(cfg, os.path.join(work, "store"), cell.traffic, dev,
                                       recorder, n_img))
                gc.collect()     # each pass starts with the last one's garbage gone
                if time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
            stage_s = {}
            for p in passes:
                for name, sec in p["spans"]:
                    stage_s[name] = stage_s.get(name, 0.0) + sec
            if trace:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if dev.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                before = kernels.launch_counts()
                with torch.profiler.profile(activities=acts) as prof:
                    p = run_pass(cfg, os.path.join(work, "store"), cell.traffic, dev,
                                 recorder, n_img)
                    t_stop = time.perf_counter()
                log(f"traced pass {p['wall_s']:.1f} s, profiler stopped in "
                    f"{time.perf_counter() - t_stop:.1f} s")
                after = kernels.launch_counts()
                launches = {k: (tapped_calls[k], after[k] - before[k]) for k in tapped_calls}
                t_view = time.perf_counter()
                view = TraceView(n_img, stage_s, n_img * len(passes),
                                 prof.profiler.kineto_results.events(), tapped, launches,
                                 torch.cuda.get_device_name(dev) if dev.type == "cuda"
                                 else "cpu")
                log(f"trace reduced in {time.perf_counter() - t_view:.1f} s")
                passes.append(p)
        log(f"set-up {setup_s:.1f} s, window {window_s:.1f} s ({len(passes)} passes)")
        peak = recorder.peak_bytes
        res = {"attempted": n_img * len(passes), "failed": sum(p["failed"] for p in passes),
               "passes": len(passes), "pass_s": [p["wall_s"] for p in passes],
               "window_s": window_s, "setup_s": setup_s,
               "memory_peak_bytes": peak, "stage_s": stage_s}
        if trace:
            res["per_layer"] = {m: cell_mod.reader(m)(view) for m in cell.per_layer}
            res["busy_s"], res["traced_window_s"] = view.busy_s(), view.window_s()
            res["breakdown"] = view.breakdown()
            view.dump(os.path.join(cell_mod.ROOT, OUT_DIR, f"{cell.name}.{seed}.trace.json"))
            view = None
        else:
            res["images_per_s"] = sum(p["registered"] for p in passes) / window_s
        # the check: after the window, with the program's state freed
        gc.collect()
        numbers = worst([judge_pass(p, truth) for p in passes])
        res["correct"], res["checks"] = judge.verdict(numbers, cell.limits)
        res["numbers"] = numbers
        log(f"checked at {time.perf_counter() - t_start:.1f} s")
        return res
    finally:
        shutil.rmtree(work, ignore_errors=True)


def result_line(cell, res: dict, trace: bool, device_kind: str, card: str) -> dict:
    """The result's JSON object; the checks come last."""
    if trace:
        metrics = {m: {"value": v, "unit": u} for m, v, u in cell_units(cell, res["per_layer"])}
    else:
        metrics = {"images_per_s": {"value": res["images_per_s"], "unit": "images/s"},
                   "setup_s": {"value": res["setup_s"], "unit": "s"}}
    device = {"platform": "gpu", "kind": device_kind, "count": cell.chips,
              "memory_peak_bytes": int(res["memory_peak_bytes"]), "card": card}
    line = {"correct": bool(res["correct"]), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device,
            "passes": res["passes"], "pass_s": res["pass_s"], "window_s": res["window_s"],
            "stage_s": res["stage_s"],
            "numbers": res["numbers"]}
    if trace:
        device["busy_s"], device["window_s"] = res["busy_s"], res["traced_window_s"]
        line["breakdown"] = res["breakdown"]
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in res["checks"]}
    return line


def cell_units(cell, values: dict):
    """(name, value, unit) of the per-layer metrics a reader found."""
    units = {m["name"]: m["unit"] for m in cell_mod.manifest()["per_layer"]}
    return [(m, v, units[m]) for m, v in values.items() if v is not None]


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = cell_mod.load(a.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"no result: the cell needs {cell.chips} CUDA device(s), "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 2
    card = card_line()
    res = run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        log(f"no result: the process loaded {found}")
        return 3
    line = result_line(cell, res, bool(a.trace), torch.cuda.get_device_name(0), card)
    for name, v, lim in res["checks"]:
        log(f"check {name}: {v!r} (limit {lim!r})")
    print(json.dumps(line), flush=True)
    return 0
