"""One pass of a benchmark cell with the program's tracing on, and what the
merge's triangulation and the device mapper's track capacity do in it.

    python tools/exp_colmap_capacity.py --workload colmap_capacity.seq_sparse \
        --seeds 11,12 [--ref_tracks 0] [--tracks_per_feature 4] [--device cuda]

For each seed: the cell's collection, one reconstruction through
``stages.run_all`` (the harness's ``run_pass``), and one JSON line with
- each cluster's tracks as built, the capacity, and the drop at that
  capacity and at ``mapper.device_max_points`` alone;
- the program's triangulation spans and counters, each stage's seconds,
  and the tracks of every ``triangulate_tracks_packed`` call, in order
  (the last is the one that raised, where one did);
- the largest ``triangulate_tracks_packed`` call (the merge's
  retriangulation) run again through the plain reference
  (``benchmark/reference/triangulate.py``, on the CPU in float64): the
  accepted and passing views that differ, and the largest deviation of a
  point both accept, relative to its distance from the origin
  (``--ref_tracks N`` takes N tracks spread over the call, 0 all);
- the reference judge's numbers and the peak device memory.

``--tracks_per_feature 1`` holds the capacity at ``mapper.device_max_points``
(8192), as before it followed the features.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import cell as cell_mod  # noqa: E402
from benchmark.harness.main import judge_pass, make_collection, run_pass  # noqa: E402
from benchmark.harness.record import Recorder  # noqa: E402
from benchmark.reference import triangulate as ref  # noqa: E402


def against_reference(call, n_tracks):
    """The reference on a call's tracks: (tracks compared, accepted
    differing, views differing, largest relative deviation of a point both
    accept, seconds)."""
    data, thr, angle, out = call
    B = len(data)
    idx = np.arange(B) if not n_tracks or n_tracks >= B else \
        np.linspace(0, B - 1, n_tracks).round().astype(np.int64)
    d = torch.as_tensor(data[idx])
    t0 = time.perf_counter()
    xyz, ok, view_ok = ref.triangulate_tracks(d[..., 0:4], d[..., 4:7], d[..., 7:9],
                                              d[..., 9] > 0.5, torch.as_tensor(thr[idx]),
                                              angle)
    secs = time.perf_counter() - t0
    p_xyz, p_ok, p_view = out[idx, 0:3], out[idx, 3] > 0.5, out[idx, 4:] > 0.5
    both = p_ok & ok.numpy()
    dev = np.linalg.norm(p_xyz[both] - xyz.numpy()[both], axis=1) / np.maximum(
        np.linalg.norm(xyz.numpy()[both], axis=1), 1e-300)
    return {"tracks": int(len(idx)), "of": int(B), "accepted": int(p_ok.sum()),
            "accepted_ref": int(ok.sum()), "accepted_differ": int((p_ok != ok.numpy()).sum()),
            "views_differ": int((p_view != view_ok.numpy()).sum()),
            "max_rel_dev": float(dev.max()) if len(dev) else None,
            "median_rel_dev": float(np.median(dev)) if len(dev) else None,
            "ref_seconds": secs}


def one_seed(cell, seed, device, n_ref, tracks_per_feature):
    from scanner_colmap_tpu_torch.engine import device_cluster as dc
    from scanner_colmap_tpu_torch.ops import triangulate
    from scanner_colmap_tpu_torch.utils import metrics

    built, largest, sizes = [], [None], []
    build, packed = dc.build_tracks_packed, triangulate.triangulate_tracks_packed

    def build_logged(*a, **k):
        out = build(*a, **k)
        built.append(int(len(out[2])))
        return out

    def packed_logged(data, thr, angle):
        sizes.append(int(len(data)))
        out = packed(data, thr, angle)
        if largest[0] is None or len(data) > len(largest[0][0]):
            largest[0] = (data.cpu().numpy(), np.broadcast_to(thr.cpu().numpy(), len(data)),
                          angle, out.cpu().numpy())
        return out

    torch.manual_seed(seed)
    work = tempfile.mkdtemp(prefix="capacity-")
    dc.build_tracks_packed, triangulate.triangulate_tracks_packed = build_logged, packed_logged
    per_feature, dc.TRACKS_PER_FEATURE = dc.TRACKS_PER_FEATURE, tracks_per_feature
    was = metrics.set_tracing(True)
    try:
        truth = make_collection(cell, seed, os.path.join(work, "images"), device)
        cfg = cell_mod.pipeline_config(cell, os.path.join(work, "images"))
        rec = Recorder(device)
        with rec.installed():
            p = run_pass(cfg, os.path.join(work, "store"), cell.traffic, device, rec,
                         cell.config["frames"]["num_images"])
        reg = metrics.GLOBAL_METRICS.to_dict()
        cap = dc.track_capacity(cfg.mapper, cfg.sift.max_num_features)
        out = {"seed": seed, "registered": p["registered"], "error": p.get("error"),
               "pass_s": p["wall_s"], "stages": dict(p["spans"]), "peak_bytes": rec.peak_bytes,
               "tracks_built": built, "capacity": cap, "triangulate_calls": sizes,
               "dropped": [max(n - cap, 0) for n in built],
               "dropped_at_device_max_points": [max(n - cfg.mapper.device_max_points, 0)
                                                for n in built],
               "program": {s: {k: v for k, v in d.items()
                               if "triangulate" in k or "tracks_dropped" in k}
                           for s, d in reg.items()},
               "numbers": judge_pass(p, truth)}
    finally:
        metrics.set_tracing(was)
        dc.build_tracks_packed, triangulate.triangulate_tracks_packed = build, packed
        dc.TRACKS_PER_FEATURE = per_feature
        shutil.rmtree(work, ignore_errors=True)
    if largest[0] is not None:
        out["largest_call"] = against_reference(largest[0], n_ref)
    return out


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="colmap_capacity.seq_sparse")
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--ref_tracks", type=int, default=0)
    ap.add_argument("--tracks_per_feature", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    cell = cell_mod.load(a.workload)
    for s in a.seeds.split(","):
        print(json.dumps(one_seed(cell, int(s), torch.device(a.device), a.ref_tracks,
                                  a.tracks_per_feature)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
