"""The readings the check's limits are set from; not run by the benchmark.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--device cuda]
        [--faults all|<fault>,...] [--out <file>]

For each seed, in one process: the cell's collection, one reconstruction
of it at the cell's own sizes, and the reference's numbers of the
program's outputs; then the control's numbers on the same seed: the
outputs served in bfloat16 (the merged model's poses and points, the fused
cloud and the mesh), with fusion and meshing run again on the same depth
maps under the traffic's ``control_overrides`` (the guarantees the control
breaks). With ``--faults``, also the named faults of ``harness/faults.py``
(``all``: each the cell can have), each planted in a further pass on the
same collection, with the reference's numbers and the verdict under the
cell's limits. One JSON line per seed, with the merged models' poses, on
standard output, also written to ``--out``.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import cell as cell_mod  # noqa: E402
from benchmark.harness import faults as faults_mod  # noqa: E402
from benchmark.harness.main import judge_pass, make_collection, run_pass  # noqa: E402
from benchmark.harness.record import Recorder  # noqa: E402
from benchmark.reference import judge  # noqa: E402


def control_dense(cell, store_dir, device) -> dict:
    """Fusion and meshing again on the store's depth maps under the
    control's overrides; their outputs."""
    import numpy as np

    from scanner_colmap_tpu_torch.pipeline import stages
    from scanner_colmap_tpu_torch.utils.store import ArtifactStore

    cfg = cell_mod.pipeline_config(cell, "", control=True)
    cfg.store_path = store_dir
    store = ArtifactStore(store_dir)
    stages.run_fusion(cfg, store, device=device)
    out = {"fused_xyz": np.asarray(store.read_table("fused", ["xyz"])["xyz"], np.float32)}
    if cell.traffic.get("mesh", False):
        stages.run_meshing(cfg, store, device=device)
        out["mesh_verts"] = np.asarray(store.read_table("mesh", ["verts"])["verts"][0],
                                       np.float32)
    return out


def spread_of(p, truth) -> dict:
    """Quantiles of the dense outputs' distance to the surface, and the
    fused cloud's size: what a dense number could be read from."""
    import numpy as np

    from benchmark.reference import judge

    out = {}
    for key in ("fused_xyz", "mesh_verts"):
        if p.get(key) is None or p["model"] is None:
            continue
        dz = judge.surface_dz(p["model"], truth, p[key])
        if dz is not None:
            out[key] = {"n": int(len(dz)), **{f"p{q}": float(np.percentile(dz, q))
                                              for q in (50, 90, 99)},
                        "over_3pct": float((dz > 0.03).mean()),
                        "over_10pct": float((dz > 0.1).mean())}
    return out


def poses_of(p) -> dict | None:
    """The merged model's registered image ids and world-to-camera poses,
    for numbers worked out afterwards."""
    m = p["model"]
    if m is None:
        return None
    return {k: m[k].tolist() for k in ("image_ids", "qvecs", "tvecs")}


def fault_readings(cell, cfg, store_dir, device, truth, only=None) -> dict:
    """{fault: {numbers, correct}} of a pass with each fault the cell can
    have planted; a pass that raises gives no numbers, and fails."""
    n_img = cell.config["frames"]["num_images"]
    out = {}
    for name in only or faults_mod.applicable(cell.traffic):
        with faults_mod.planted(name):
            rec = Recorder(device)
            with rec.installed():
                p = run_pass(cfg, store_dir, cell.traffic, device, rec, n_img)
        numbers = judge_pass(p, truth)
        out[name] = {"numbers": numbers, "correct": judge.verdict(numbers, cell.limits)[0],
                     "registered": p["registered"], "error": p.get("error"),
                     "poses": poses_of(p)}
    return out


def calibrate(cell, seed: int, device, faults=()) -> dict:
    import torch

    from scanner_colmap_tpu_torch.utils.store import ArtifactStore

    torch.manual_seed(seed)
    work = tempfile.mkdtemp(prefix="calib-")
    try:
        t0 = time.perf_counter()
        truth = make_collection(cell, seed, os.path.join(work, "images"), device)
        t_render = time.perf_counter() - t0
        cfg = cell_mod.pipeline_config(cell, os.path.join(work, "images"))
        rec = Recorder(device)
        store_dir = os.path.join(work, "store")
        n_img = cell.config["frames"]["num_images"]
        with rec.installed():
            p = run_pass(cfg, store_dir, cell.traffic, device, rec, n_img, keep_store=True)
        feats = [len(k) for k in ArtifactStore(store_dir).read_table(
            "extraction", ["keypoints"])["keypoints"]]
        out = {"seed": seed, "render_s": t_render, "registered": p["registered"],
               "failed": p["failed"], "spans": p["spans"], "peak_bytes": rec.peak_bytes,
               "features_min": min(feats), "features_mean": sum(feats) / len(feats),
               "program": judge_pass(p, truth), "poses": poses_of(p),
               "program_dense": spread_of(p, truth)}
        if p["model"] is not None and cell.traffic.get("dense", False):
            p.update(control_dense(cell, store_dir, device))
            out["control_dense"] = spread_of(p, truth)
        out["control"] = judge_pass(p, truth, control=True) \
            if p["model"] is not None else {}
        if faults:
            out["faults"] = fault_readings(cell, cfg, store_dir, device, truth,
                                           None if faults == ["all"] else faults)
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--faults", default="",
                    help="comma-separated faults to read as well, or 'all'")
    a = ap.parse_args(argv)
    cell = cell_mod.load(a.workload)
    for s in a.seeds.split(","):
        line = json.dumps(calibrate(cell, int(s), a.device, [f for f in a.faults.split(",") if f]))
        print(line, flush=True)
        if a.out:
            os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
            with open(a.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
