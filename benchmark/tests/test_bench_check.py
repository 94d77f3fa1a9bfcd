"""The check that decides ``correct``, driven through the harness on the CPU
at a size a test run holds: a sound run passes; the control (the outputs
served in bfloat16, fusion and meshing without the guarantees the traffic's
``control_overrides`` break) fails; and so does a run with each fault of
``harness/faults.py`` planted underneath the timed path.

The limits here are this size's own (the readings of sound runs at this
size, with room); the cells' limits are set from runs at their own sizes
on the card (PERF.md)."""

import time

import pytest
import torch

from benchmark.harness import cell as cell_mod
from benchmark.harness import faults
from benchmark.harness.main import run_cell
from benchmark.reference import judge

TINY = {
    "overrides": {"sift.max_image_size": 320, "sift.max_num_features": 512,
                  "sift.num_octaves": 3, "matching.overlap": 4,
                  "matching.min_num_inliers": 12, "mapper.cluster_size": 5,
                  "mapper.cluster_overlap": 3, "mapper.init_min_num_inliers": 20,
                  "mapper.abs_pose_min_num_inliers": 12, "patch_match.max_image_size": 64,
                  "patch_match.overlap": 2, "patch_match.num_iterations": 2,
                  "patch_match.fine_iterations": 1, "patch_match.window_radius": 2,
                  "meshing.resolution": 16},
    "frames": {"num_images": 8, "width": 320, "height": 240, "focal_px": 200.0},
    "scene": {"num_blobs": 350, "blob_size_scale": 1.0, "depth0": 8.0, "depth_spread": 2.5}}
# sound runs at this size on the CPU, seeds 2^31 + 11, 12, 13: rpe_rms
# 0.047-0.061, reproj_rms_px 0.34-0.37, fused_p99_rel 0.12-0.34,
# mesh_p90_rel 0.157-0.169; the control 0.048-0.062, 0.45-0.48, 0.45-0.47,
# 0.14-0.22: at this size the control fails by the fused cloud alone
LIMITS = {"rpe_rms": 0.2, "reproj_rms_px": 1.0, "fused_p99_rel": 0.4, "mesh_p90_rel": 0.3}
SPARSE = ("rpe_rms", "reproj_rms_px")
SEED = 2**31 + 11


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def tiny_cell(traffic: str):
    t = cell_mod._load_json(cell_mod.BENCH_DIR, "traffic", traffic + ".json")
    limits = {k: v for k, v in LIMITS.items() if t.get("dense") or k in SPARSE}
    return cell_mod.Cell("tiny." + traffic, 1, TINY, t, limits, [], [])


def run(traffic: str):
    return run_cell(tiny_cell(traffic), SEED, 0.0, False, "cpu", time.perf_counter())


def test_sound_run_passes_and_control_fails():
    from benchmark.calibrate import calibrate

    cell = tiny_cell("seq_full")
    out = calibrate(cell, SEED, torch.device("cpu"))
    ok, _ = judge.verdict(out["program"], cell.limits)
    bad, rows = judge.verdict(out["control"], cell.limits)
    assert ok, out["program"]
    assert not bad, out["control"]


@pytest.mark.parametrize("fault,traffic", [
    ("state_unchanged_sparse", "seq_sparse"), ("state_unchanged_dense", "seq_full"),
    ("half_batch", "seq_sparse"), ("answer_altered", "seq_sparse")])
def test_planted_fault_fails(fault, traffic):
    with faults.planted(fault):
        assert not run(traffic)["correct"]
