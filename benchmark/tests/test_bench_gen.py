"""The benchmark's generator copy against the program's generator, and the
card's renderer against the plain one, at a small size on the CPU."""

import numpy as np
import pytest
import torch

from benchmark.gen import scene as scene_mod
from benchmark.gen.render_torch import render_torch


@pytest.mark.parametrize("track", ["arc", "out_and_back"])
def test_copy_equals_synth(track):
    from scanner_colmap_tpu_torch.pipeline import synth

    frames, gt = synth.render_dataset(num_images=4, width=96, height=72, focal=60.0,
                                      num_blobs=120, seed=2**31 + 5, track=track)
    sc = scene_mod.make_scene(4, 2**31 + 5, 120, track=track)
    mine = scene_mod.render_frames(sc, 96, 72, 60.0)
    assert all(np.array_equal(a, b) for a, b in zip(frames, mine))
    assert np.array_equal(sc["qvecs"], gt["qvecs"]) and np.array_equal(sc["tvecs"], gt["tvecs"])
    assert np.array_equal(sc["centers"], gt["points"])


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_torch_renderer_equals_plain(scale, monkeypatch):
    import benchmark.gen.render_torch as rt

    # a small chunk budget, so that blobs are split over many chunks
    monkeypatch.setattr(rt, "PATCH_ELEMENTS", 4096)
    sc = scene_mod.make_scene(3, 11, 200, blob_size_scale=scale)
    plain = np.stack(scene_mod.render_frames(sc, 160, 120, 100.0))
    got = render_torch(sc, 160, 120, 100.0, torch.device("cpu")).numpy()
    diff = np.abs(plain.astype(int) - got.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_jpegs_carry_the_focal(tmp_path):
    from scanner_colmap_tpu_torch.ops import image as image_ops

    sc = scene_mod.make_scene(2, 3, 50)
    frames = scene_mod.render_frames(sc, 128, 96, 80.0)
    scene_mod.write_jpegs(str(tmp_path), frames, 80.0, 128)
    path = str(tmp_path / "image_0001.jpg")
    assert abs(image_ops.exif_focal_px(path, 128) - 80.0) < 1e-3
    assert image_ops.decode_image(path).shape == (96, 128, 3)
