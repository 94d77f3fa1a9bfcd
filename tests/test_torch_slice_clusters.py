"""The two-cluster f32 slice of the torch port against the JAX stages, on
CPU: the banked matching plan (kernel 3's plain version), the merge of
several submodels and its full-graph refinement.

Configuration: 8 synthetic 320x240 images (the tests/test_torch_slice.py
set), f32 matching, ``cluster_size=5`` and ``cluster_overlap=3``, so three
submodels. The JAX stages give 8/8 in 3 submodels at ATE 0.0359 here.
RANSAC draws differ between the packages, so parity is statistical: the
port registers 8/8 in 3 submodels, ATE <= 0.05, and verifies >= 90% of
the JAX pairs. On the port's own extraction the plan choices are exact:
bf16 banked == resident, and 3-image banks == one bank (f32 and bf16).
Mapping tables cross between the packages' merge stages both ways.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from scanner_colmap_tpu.pipeline import stages as jstages
from scanner_colmap_tpu.pipeline import synth as jsynth
from scanner_colmap_tpu.utils.config import PipelineConfig
from scanner_colmap_tpu.utils.store import ArtifactStore
from scanner_colmap_tpu_torch.ops import two_view as ttv
from scanner_colmap_tpu_torch.pipeline import stages as tstages
from scanner_colmap_tpu_torch.pipeline import synth as tsynth
from scanner_colmap_tpu_torch.utils import config as tconfig
from scanner_colmap_tpu_torch.utils import metrics as tmetrics
from scanner_colmap_tpu_torch.utils import store as tstore

CPU = torch.device("cpu")


def _cfg(image_dir, store_path):
    cfg = PipelineConfig()
    cfg.image_path = image_dir
    cfg.store_path = store_path
    cfg.sift.max_image_size = 320
    cfg.sift.max_num_features = 512
    cfg.sift.num_octaves = 3
    cfg.matching.overlap = 4
    cfg.matching.min_num_inliers = 12
    cfg.matching.precision = "f32"
    cfg.mapper.cluster_size = 5
    cfg.mapper.cluster_overlap = 3
    cfg.mapper.init_min_num_inliers = 20
    cfg.mapper.abs_pose_min_num_inliers = 12
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    image_dir = str(tmp_path_factory.mktemp("images"))
    gt = jsynth.generate_dataset(image_dir, num_images=8, width=320, height=240,
                                 num_blobs=350, seed=1)
    gt = {k: np.asarray(v) if k in ("qvecs", "tvecs") else v for k, v in gt.items()}
    out = {"gt": gt}
    for name, mod, kw in (("jax", jstages, {}), ("torch", tstages, {"device": CPU})):
        cfg = _cfg(image_dir, str(tmp_path_factory.mktemp(f"store_{name}")))
        store = ArtifactStore(cfg.store_path)
        if name == "torch":     # the port's own config and store, same fields and files
            cfg = tconfig.PipelineConfig.from_dict(cfg.to_dict())
            store = tstore.ArtifactStore(cfg.store_path)
        mod.prepare_images(cfg, store)
        mod.run_extraction(cfg, store, **kw)
        mod.run_matching(cfg, store, **kw)
        mod.run_mapping(cfg, store, **kw)
        if name == "torch":     # the merge's split: its spans
            was = tmetrics.set_tracing(True)
            tmetrics.GLOBAL_METRICS.reset()
            try:
                out[name] = (cfg, store, mod.run_merge(cfg, store, **kw))
                out["merge_spans"] = tmetrics.GLOBAL_METRICS.stage(tmetrics.RUN)
            finally:
                tmetrics.set_tracing(was)
                tmetrics.GLOBAL_METRICS.reset()
        else:
            out[name] = (cfg, store, mod.run_merge(cfg, store, **kw))
    return out


def _pairs(store, table="matching"):
    return {tuple(p) for p in np.asarray(store.read_table(table)["pair_image_ids"])}


def _copy_tables(src: ArtifactStore, dst_root, tables):
    dst = ArtifactStore(dst_root)
    for t in tables:
        shutil.copytree(os.path.join(src.root, t), os.path.join(dst.root, t))
    return dst


def _rows_by_pair(store, table):
    """{pair: [(tvg row, matches), ...]}: plans order the pairs differently
    (bank-major or offset-major), so tables compare by pair."""
    t = store.read_table(table)
    out = {}
    for n, p in enumerate(np.asarray(t["pair_image_ids"])):
        out.setdefault(tuple(p), []).append((np.asarray(t["two_view_geometry"][n]),
                                             np.asarray(t["matches"][n])))
    return out


def _assert_same_tables(store, a, b):
    ra, rb = _rows_by_pair(store, a), _rows_by_pair(store, b)
    assert set(ra) == set(rb) and len(ra) > 10
    for pair, rows in ra.items():
        assert len(rows) == len(rb[pair])
        for (tvg_a, m_a), (tvg_b, m_b) in zip(rows, rb[pair]):
            np.testing.assert_array_equal(tvg_a, tvg_b)
            np.testing.assert_array_equal(m_a, m_b)


def test_two_cluster_f32_slice_matches_jax(runs):
    (_, sj, mj), (_, st, mt) = runs["jax"], runs["torch"]
    assert mj.num_registered == 8 and mt.num_registered == 8
    for s in (sj, st):
        assert s.read_manifest("mapping")["meta"]["num_submodels"] == 3
        assert s.read_manifest("matching")["meta"]["execution"] == "banked"
    ate = tsynth.evaluate_ate(mt, runs["gt"])
    assert ate <= 0.05, ate
    assert len(mt.points3D) > 200 and mt.mean_reprojection_error() < 2.0
    pj, pt = _pairs(sj), _pairs(st)
    assert len(pj & pt) >= 0.9 * len(pj), (len(pj), len(pt), len(pj & pt))
    meta = st.read_manifest("matching")["meta"]
    assert meta["num_banks"] == 1 and meta["bank_images"] > 8
    spans = runs["merge_spans"]
    assert {k[len("span.merge."):-len(".n")] for k in spans
            if k.startswith("span.merge.") and k.endswith(".n")} == \
        {"load", "fold", "graph", "refine"}
    for table in ("matching", "mapping", "models"):
        cj = sj.read_manifest(table)["columns"]
        ct = st.read_manifest(table)["columns"]
        assert set(cj) == set(ct)
        for col in cj:
            assert cj[col].get("dtype") == ct[col].get("dtype"), (table, col)


def test_bf16_banked_equals_resident(runs):
    cfg, store, _ = runs["torch"]
    cfg.matching.precision = "bf16"
    try:
        cfg.matching.execution = "banked"
        cfg.matching.bank_images = 3
        tstages.run_matching(cfg, store, device=CPU, out_table="m_banked")
        cfg.matching.execution = "resident"
        cfg.matching.resident_pair_chunk = 5
        tstages.run_matching(cfg, store, device=CPU, out_table="m_resident")
    finally:
        cfg.matching.precision, cfg.matching.execution = "f32", "auto"
        cfg.matching.bank_images, cfg.matching.resident_pair_chunk = 0, 512
    _assert_same_tables(store, "m_banked", "m_resident")
    assert store.read_manifest("m_banked")["meta"]["num_banks"] == 3
    assert store.read_manifest("m_resident")["meta"]["execution"] == "resident"


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_small_banks_equal_one_bank(runs, precision):
    cfg, store, _ = runs["torch"]
    cfg.matching.precision = precision
    cfg.matching.execution = "banked"
    try:
        cfg.matching.bank_images = 1000
        tstages.run_matching(cfg, store, device=CPU, out_table=f"m1_{precision}")
        cfg.matching.bank_images = 3
        tstages.run_matching(cfg, store, device=CPU, out_table=f"m3_{precision}")
    finally:
        cfg.matching.precision, cfg.matching.execution = "f32", "auto"
        cfg.matching.bank_images = 0
    _assert_same_tables(store, f"m1_{precision}", f"m3_{precision}")
    assert store.read_manifest(f"m3_{precision}")["meta"]["num_banks"] == 3


def test_guided_and_multiple_models_stage(runs, tmp_path):
    cfg, st, _ = runs["torch"]
    store = tstore.ArtifactStore(
        _copy_tables(st, str(tmp_path), ["frames", "extraction", "matching"]).root)
    cfg.matching.guided_matching = cfg.matching.multiple_models = True
    try:
        n_rows = tstages.run_matching(cfg, store, device=CPU, out_table="m_gm")
    finally:
        cfg.matching.guided_matching = cfg.matching.multiple_models = False
    tab = store.read_table("m_gm")
    pairs = [tuple(p) for p in np.asarray(tab["pair_image_ids"])]
    assert n_rows == len(pairs) >= len(_pairs(st))
    assert set(pairs) == _pairs(st)      # the same verified pairs, maybe more rows
    base = store.read_table("matching")
    base_len = {tuple(p): len(m) for p, m in zip(np.asarray(base["pair_image_ids"]),
                                                 base["matches"])}
    for n, p in enumerate(pairs):
        cfg_n = int(tab["two_view_geometry"][n][0])
        assert (cfg_n == ttv.MULTIPLE) == (pairs.count(p) > 1)
        if pairs.count(p) == 1:          # guided is upgrade-only
            assert len(tab["matches"][n]) >= base_len[p]


def test_mapping_tables_cross_merge_stages(runs, tmp_path):
    cfg_j, sj, _ = runs["jax"]
    _, st, _ = runs["torch"]
    tables = ["frames", "extraction", "matching", "mapping"]
    s1 = _copy_tables(sj, str(tmp_path / "a"), tables)     # JAX mapping -> port merge
    model = tstages.run_merge(tconfig.PipelineConfig.from_dict(cfg_j.to_dict()),
                              tstore.ArtifactStore(s1.root), device=CPU)
    assert model.num_registered == 8
    assert tsynth.evaluate_ate(model, runs["gt"]) <= 0.05
    s2 = _copy_tables(st, str(tmp_path / "b"), tables)     # port mapping -> JAX merge
    assert jstages.run_merge(cfg_j, s2).num_registered == 8
