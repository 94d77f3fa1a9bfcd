"""The port's command line and whole-run entry, on the CPU.

- tests/test_cli.py's five cases on the port's parser, each also holding
  the config the port builds from the argv to the JAX CLI's (the same
  config JSON);
- ``set`` writes a config that ``--config`` reads back;
- the dense subcommands, ``all`` without ``--sparse_only`` and
  ``run_all(dense=True)`` run (each on a copy of the sparse store below,
  at 64 px);
- ``--device`` defaults to the card: without one, a stage raises;
- ``--profile_dir`` writes its trace also when the stage raises;
- ``run_all(resume=True)`` skips the stages whose tables exist and reads the
  model back; ``all --sparse_only --device cpu --resume`` runs end to end
  (here on 4 in-memory frames with the extraction table written; the
  8-image run is in tests/test_torch_slice.py, with the JAX package
  unimportable);
- the extraction table for no images has a (0, 9) camera column, as the
  JAX stage writes it.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from scanner_colmap_tpu.pipeline import cli as jcli
from scanner_colmap_tpu_torch.pipeline import ArtifactStore, PipelineConfig
from scanner_colmap_tpu_torch.pipeline import cli as tcli
from scanner_colmap_tpu_torch.pipeline import stages as tstages
from scanner_colmap_tpu_torch.pipeline import synth as tsynth
from scanner_colmap_tpu_torch.utils import metrics as tmetrics

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: the tier-1 run has six
    workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PARSER_CASES = {
    "shared_flags_before_subcommand": (
        ["--store_path", "S", "--image_path", "I", "all"],
        {"store_path": "S", "image_path": "I"}),
    "shared_flags_after_subcommand": (
        ["all", "--store_path", "S", "--image_path", "I"],
        {"store_path": "S", "image_path": "I"}),
    "shared_flag_defaults_fill_in": (
        ["extraction"],
        {"store_path": None, "image_path": None, "config": None, "verbose": False,
         "device": "cuda", "profile_dir": None}),
    "verbose_before_subcommand": (["-v", "all"], {"verbose": True}),
    "stage_knobs_reach_config": (
        ["--store_path", "S", "all", "--overlap", "7", "--cluster_size", "12",
         "--cluster_overlap", "3"],
        {"store_path": "S"}),
}


@pytest.mark.parametrize("case", sorted(PARSER_CASES))
def test_parser_cases_match_the_jax_cli(case):
    argv, want = PARSER_CASES[case]
    args = tcli.parse_args(argv)
    for k, v in want.items():
        assert getattr(args, k) == v, k
    cfg = tcli.config_from_args(args)
    jcfg = jcli.config_from_args(jcli.parse_args(argv))
    assert json.loads(cfg.to_json()) == json.loads(jcfg.to_json())
    if case == "stage_knobs_reach_config":
        assert cfg.store_path == "S" and cfg.matching.overlap == 7
        assert cfg.mapper.cluster_size == 12 and cfg.mapper.cluster_overlap == 3


def test_device_flag_goes_anywhere():
    assert tcli.parse_args(["--device", "cpu", "all"]).device == "cpu"
    assert tcli.parse_args(["all", "--device", "cpu"]).device == "cpu"


def test_set_writes_a_config_that_config_reads(tmp_path, capsys):
    out = str(tmp_path / "cfg.json")
    assert tcli.main(["set", "matching.overlap=5", "sift.upright=true",
                      "mapper.cluster_size=9", "--out", out]) == 0
    args = tcli.parse_args(["--config", out, "all", "--cluster_overlap", "2"])
    cfg = tcli.config_from_args(args)
    assert (cfg.matching.overlap, cfg.sift.upright, cfg.mapper.cluster_size,
            cfg.mapper.cluster_overlap) == (5, True, 9, 2)
    jcfg = jcli.config_from_args(jcli.parse_args(["--config", out, "all",
                                                  "--cluster_overlap", "2"]))
    assert json.loads(cfg.to_json()) == json.loads(jcfg.to_json())


DENSE_TABLES = {"undistort": "undistorted", "prepare_patch_match": "prepare_patch_match",
                "patch_match": "patch_match", "stereo_fusion": "fused", "meshing": "mesh"}


def _dense_config(cfg):
    pm = cfg.patch_match
    pm.max_image_size, pm.overlap, pm.num_iterations = 64, 2, 2
    pm.fine_iterations, pm.window_radius = 1, 2
    cfg.meshing.resolution = 16
    return cfg


@pytest.mark.parametrize("argv", [["all"], ["undistort"], ["prepare_patch_match"],
                                  ["patch_match"], ["stereo_fusion"], ["meshing"]],
                         ids=lambda a: a[0])
def test_unported_stages_raise_naming_their_item(argv, sparse_store, tmp_path):
    """The dense stages are ported: each dense subcommand runs on a copy of
    the sparse store (after the stages it needs), and ``all --resume`` and
    ``run_all(dense=True, resume=True)`` run the dense stages after the
    store's sparse tables."""
    src, cfg = sparse_store["root"], _dense_config(_cfg(""))
    root = str(tmp_path / "store")
    shutil.copytree(src, root)
    cfg.store_path = root
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    store = ArtifactStore(root)
    flags = ["--device", "cpu", "--config", cfg_path, "--store_path", root]
    if argv == ["all"]:
        assert tcli.main(["all", "--resume", "--ply_path", str(tmp_path / "c.ply"),
                          "--mesh_path", str(tmp_path / "m.ply")] + flags) == 0
        metrics = json.load(open(os.path.join(root, "metrics.json")))
        assert {"prepare_patch_match", "patch_match", "fusion", "meshing"} == set(metrics)
        assert metrics["patch_match"]["launches.plane_cost"] == 0    # the plain route
        assert store.num_rows("patch_match") == 4 and store.num_rows("fused") > 0
        assert os.path.getsize(str(tmp_path / "c.ply")) > 0
        again = str(tmp_path / "again")
        shutil.copytree(src, again)
        cfg.store_path = again
        model = tstages.run_all(cfg, dense=True, resume=True, device=CPU)
        assert model.num_registered == 4
        assert ArtifactStore(again).num_rows("fused") == store.num_rows("fused")
        return
    order = list(DENSE_TABLES)[1:]
    for stage in order[:order.index(argv[0])] if argv[0] in order else ():
        {"prepare_patch_match": lambda: tstages.run_prepare_patch_match(cfg, store),
         "patch_match": lambda: tstages.run_patch_match(cfg, store, device=CPU),
         "stereo_fusion": lambda: tstages.run_fusion(cfg, store, device=CPU)}[stage]()
    assert tcli.main(argv + flags) == 0
    table = DENSE_TABLES[argv[0]]
    assert store.has_table(table)
    if table != "fused":
        assert store.num_rows(table) == (1 if table == "mesh" else 4)


def test_default_device_is_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["extraction", "--store_path", str(tmp_path)])


def test_profile_dir_trace_survives_a_raising_stage(tmp_path):
    prof = str(tmp_path / "prof")
    with pytest.raises(FileNotFoundError):      # no frames table
        tcli.main(["extraction", "--store_path", str(tmp_path / "s"), "--device", "cpu",
                   "--profile_dir", prof])
    assert os.path.getsize(os.path.join(prof, "trace.json")) > 0
    summary = {}
    with tmetrics.device_trace(str(tmp_path / "p2"), summary):
        torch.ones(4).sum()
    assert summary == {"device_kernels": 0, "device_busy_ms": 0.0}


def test_metrics_and_reconstruction_metrics():
    m = tmetrics.Metrics()
    m.set("a", "x", 2)
    m.inc("a", "n")
    m.inc("a", "n", 2.5)
    with m.timer("b", items_name="per_s", items=10):
        pass
    d = m.to_dict()
    assert d["a"] == {"x": 2.0, "n": 3.5} and d["b"]["per_s"] > 0
    assert json.loads(m.to_json()) == d


def _cfg(root):
    cfg = PipelineConfig()
    cfg.store_path = root
    cfg.sift.max_image_size = 320
    cfg.sift.max_num_features = 512
    cfg.sift.num_octaves = 3
    cfg.matching.overlap = 3
    cfg.matching.min_num_inliers = 12
    cfg.mapper.cluster_size = 8
    cfg.mapper.init_min_num_inliers = 20
    cfg.mapper.abs_pose_min_num_inliers = 12
    return cfg


@pytest.fixture(scope="module")
def sparse_store(tmp_path_factory):
    """Frames in memory and the extraction table written, then ``all
    --sparse_only --resume --device cpu``."""
    tmp_path = tmp_path_factory.mktemp("sparse")
    frames, gt = tsynth.render_dataset(num_images=4, width=320, height=240,
                                       num_blobs=350, seed=1)
    root = str(tmp_path / "store")
    cfg = _cfg(root)
    store = ArtifactStore(root)
    tstages.prepare_images(cfg, store, frames=[(f, gt["focal"]) for f in frames])
    tstages.run_extraction(cfg, store, device=CPU)
    stamp = {t: os.path.getmtime(os.path.join(root, t)) for t in ("frames", "extraction")}
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    rc = tcli.main(["all", "--sparse_only", "--resume", "--device", "cpu",
                    "--config", cfg_path, "--store_path", root])
    return {"root": root, "cfg": cfg, "gt": gt, "stamp": stamp, "rc": rc}


def test_all_sparse_only_resume_on_an_in_memory_store(sparse_store):
    """Frames in memory and the extraction table written; ``all
    --sparse_only --resume --device cpu`` runs matching, mapping and merge,
    skips the rest, and the model reads back with ``load_model``; a second
    ``run_all(resume=True)`` runs nothing and returns the same model."""
    root, cfg, gt, stamp = (sparse_store[k] for k in ("root", "cfg", "gt", "stamp"))
    store = ArtifactStore(root)
    assert sparse_store["rc"] == 0
    for t in ("frames", "extraction"):
        assert os.path.getmtime(os.path.join(root, t)) == stamp[t]
    model = tstages.load_model(store)
    assert model.num_registered == 4 and tsynth.evaluate_ate(model, gt) < 0.05
    metrics = json.load(open(os.path.join(root, "metrics.json")))
    assert {"matching", "mapping", "merge"} <= set(metrics)
    assert "extraction" not in metrics and metrics["matching"]["wall_s"] > 0
    again = tstages.run_all(cfg, dense=False, resume=True, device=CPU)
    assert again.registered_image_ids == model.registered_image_ids
    assert np.array_equal(again.images[1].qvec, model.images[1].qvec)
    assert tstages.cam_scales(store) == {i: 1.0 for i in range(4)}
    assert tstages.cam_scale_of(store, 2) == 1.0
    rm = tmetrics.reconstruction_metrics(model)
    assert rm["num_registered_images"] == 4 and rm["num_points3D"] == len(model.points3D)


def test_empty_extraction_table_has_width_9(tmp_path):
    store = ArtifactStore(str(tmp_path))
    store.write_table("frames", {
        "image_id": np.zeros(0, np.int64), "path": [], "width": np.zeros(0, np.int32),
        "height": np.zeros(0, np.int32)}, meta={"stage": "prepare_images"})
    cfg = PipelineConfig()
    cfg.store_path = str(tmp_path)
    assert tstages.run_extraction(cfg, store, device=CPU) == []
    assert np.asarray(store.read_table("extraction")["camera"]).shape == (0, 9)
    shutil.rmtree(str(tmp_path / "extraction"))


TRACED_SPANS = (
    "mapping.cluster", "mapping.prepare", "mapping.pnp", "mapping.triangulate",
    "mapping.ba", "mapping.unpack", "mapping.host_retry",
    "merge.load", "merge.fold", "merge.graph", "merge.refine",
    "refine.retriangulate", "refine.ba", "refine.track_ops",
    "prepare_patch_match.depth_ranges", "image.decode", "store.read", "store.write",
    "matching.window", "matching.loop_closure", "matching.verify", "matching.guided",
    "patch_match.map", "meshing.tsdf", "meshing.extract")
TRACED_COUNTS = ("ba.lm_trials", "host_reads", "store.bytes_written", "store.fsyncs",
                 "prepare_patch_match.depth_points")


@pytest.fixture(scope="module")
def traced_runs(sparse_store, tmp_path_factory):
    """``run_all`` (dense at 64 px) from the sparse store's frames and
    extraction tables, with tracing on and off: guided matching, clusters
    of 3 overlapping by 2 (so a merge of two submodels and its
    refinement), each cluster retried on the host mapper. {on: (model,
    store, the run's metrics)}."""
    out = {}
    for on in (True, False):
        root = str(tmp_path_factory.mktemp("traced_on" if on else "traced_off") / "store")
        for t in ("frames", "extraction"):
            shutil.copytree(os.path.join(sparse_store["root"], t), os.path.join(root, t))
        cfg = _dense_config(_cfg(root))
        cfg.matching.guided_matching = True
        cfg.mapper.cluster_size, cfg.mapper.cluster_overlap = 3, 2
        cfg.mapper.device_fallback_min_frac = 1.01
        was = tmetrics.set_tracing(on)
        try:
            model = tstages.run_all(cfg, resume=True, device=CPU)
        finally:
            tmetrics.set_tracing(was)
        out[on] = (model, ArtifactStore(root), tmetrics.GLOBAL_METRICS.to_dict())
    return out


def _untraced_keys(metrics):
    return {stage: {k for k in kv if not k.startswith(("span.", "count."))}
            for stage, kv in metrics.items()
            if any(not k.startswith(("span.", "count.")) for k in kv)}


def test_tracing_leaves_the_run_unchanged(traced_runs):
    """The model and every table bitwise the same with tracing on and off;
    ``metrics.json`` has the same keys but for the spans and counters."""
    (m_on, st_on, _), (m_off, st_off, _) = traced_runs[True], traced_runs[False]
    assert m_on.num_registered >= 3
    assert m_on.registered_image_ids == m_off.registered_image_ids
    for i in m_on.registered_image_ids:
        assert np.array_equal(m_on.images[i].qvec, m_off.images[i].qvec)
        assert np.array_equal(m_on.images[i].tvec, m_off.images[i].tvec)
    assert m_on.points3D.keys() == m_off.points3D.keys()
    assert all(np.array_equal(p.xyz, m_off.points3D[k].xyz) for k, p in m_on.points3D.items())
    assert st_on.list_tables() == st_off.list_tables()
    for t in st_on.list_tables():
        a, b = st_on.read_table(t), st_off.read_table(t)
        assert a.keys() == b.keys(), t
        for col in a:
            if isinstance(a[col], list):
                assert len(a[col]) == len(b[col]), (t, col)
                assert all(np.array_equal(np.asarray(x), np.asarray(y))
                           for x, y in zip(a[col], b[col])), (t, col)
            else:
                assert np.array_equal(a[col], b[col]), (t, col)
    j_on, j_off = (json.load(open(os.path.join(s.root, "metrics.json")))
                   for s in (st_on, st_off))
    assert _untraced_keys(j_on) == _untraced_keys(j_off)
    assert not any(k.startswith(("span.", "count.")) for kv in j_off.values() for k in kv)


def test_tracing_fills_every_span_and_counter(traced_runs):
    """With tracing on, every span of the program has a count and seconds
    in ``metrics.json`` and every counter counts; the mapping stage's
    spans sit under it. Off, the run records none."""
    metrics = json.load(open(os.path.join(traced_runs[True][1].root, "metrics.json")))
    for name in TRACED_SPANS:
        n = sum(kv.get(f"span.{name}.n", 0) for kv in metrics.values())
        s = sum(kv.get(f"span.{name}.s", 0) for kv in metrics.values())
        assert n > 0 and s > 0, name
    for name in TRACED_COUNTS:
        assert sum(kv.get(f"count.{name}", 0) for kv in metrics.values()) > 0, name
    mapping = metrics["mapping"]
    assert mapping["span.mapping.ba.n"] > 0 and mapping["count.host_reads"] > 0
    assert mapping["span.mapping.cluster.s"] >= mapping["span.mapping.unpack.s"]
    assert not any(k.startswith(("span.", "count."))
                   for kv in traced_runs[False][2].values() for k in kv)
