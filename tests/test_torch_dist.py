"""The port's multi-host stages (``parallel/dist.py``, ``run_extraction(
frame_slice=)``, ``run_matching(schedule_slice=)``) on the CPU.

- tests/test_dist.py's eight recipes, mirrored: round-robin partition,
  the store barrier (alone, and timing out), and the distributed stages at
  world 1. Their tables must be bitwise the port's single-process tables,
  and the tables the distributed layer writes (shards, ready markers,
  merged tables) must have the JAX stages' names, columns and dtypes, and
  the dist-written ones the JAX ``meta``.
- One 2-rank gloo run (``torch_dist_worker``) of extraction and matching
  on tests/test_dist_multiprocess.py's 6-image recipe, with jax and the
  JAX package refused in both ranks: the merged tables equal world 1's
  bitwise.
- Loop pairs under sharding: 12 out-and-back frames with
  ``loop_closure="on"`` in 2 ranks: no pair appears twice, and the table
  equals world 1's. The JAX stage's own two shards match every loop pair
  twice (stages.py:915-923), which the port does not copy.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from scanner_colmap_tpu.parallel import dist as jdist
from scanner_colmap_tpu.pipeline import stages as jstages
from scanner_colmap_tpu.utils.config import PipelineConfig as JConfig
from scanner_colmap_tpu.utils.store import ArtifactStore as JStore
from scanner_colmap_tpu_torch.parallel import dist as tdist
from scanner_colmap_tpu_torch.pipeline import ArtifactStore, PipelineConfig, stages, synth

CPU = torch.device("cpu")
N_IMAGES = 6
STEPS = ("extraction", "matching", "mapping", "merge")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(cls, image_dir, store_path):
    """tests/test_dist_multiprocess.py's configuration (dist_worker.py)."""
    cfg = cls(image_path=image_dir, store_path=store_path)
    cfg.sift.max_image_size = 256
    cfg.sift.max_num_features = 384
    cfg.sift.num_octaves = 3
    cfg.matching.overlap = 3
    cfg.matching.min_num_inliers = 12
    cfg.mapper.mode = "host"
    cfg.mapper.cluster_size = 4
    cfg.mapper.cluster_overlap = 2
    return cfg


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("six") / "imgs")
    synth.generate_dataset(d, num_images=N_IMAGES, width=256, height=192, num_blobs=250,
                           seed=4)
    return d


def _port_store(images, root):
    cfg = _config(PipelineConfig, images, root)
    store = ArtifactStore(root)
    stages.prepare_images(cfg, store)
    return cfg, store


@pytest.fixture(scope="module")
def single(images, tmp_path_factory):
    """The port's single-process stages."""
    cfg, store = _port_store(images, str(tmp_path_factory.mktemp("single") / "store"))
    stages.run_extraction(cfg, store, device=CPU)
    stages.run_matching(cfg, store, device=CPU)
    stages.run_mapping(cfg, store, device=CPU)
    stages.run_merge(cfg, store, device=CPU)
    return cfg, store


@pytest.fixture(scope="module")
def world1(images, tmp_path_factory):
    """The port's distributed stages in one process (world 1)."""
    cfg, store = _port_store(images, str(tmp_path_factory.mktemp("world1") / "store"))
    out = {name: getattr(tdist, f"run_{name}_distributed")(cfg, store, device=CPU)
           for name in STEPS}
    return cfg, store, out


@pytest.fixture(scope="module")
def jax_world1(images, tmp_path_factory):
    """The JAX package's distributed stages in one process."""
    cfg = _config(JConfig, images, str(tmp_path_factory.mktemp("jax1") / "store"))
    store = JStore(cfg.store_path)
    jstages.prepare_images(cfg, store)
    for name in STEPS:
        getattr(jdist, f"run_{name}_distributed")(cfg, store)
    return store


def _rows(store, table, key_cols):
    """{key: [row, ...]} of a table, rows as tuples of numpy arrays."""
    t = store.read_table(table)
    cols = sorted(t)
    keys = np.asarray(t[key_cols]).reshape(len(t[cols[0]]), -1)
    out = {}
    for n in range(len(keys)):
        out.setdefault(tuple(keys[n]), []).append(tuple(np.asarray(t[c][n]) for c in cols))
    return out


def _same_rows(a, b):
    return a.keys() == b.keys() and all(
        len(a[k]) == len(b[k]) and all(
            len(x) == len(y) and all(np.array_equal(u, v) and u.dtype == v.dtype
                                     for u, v in zip(x, y))
            for x, y in zip(a[k], b[k])) for k in a)


def _same_table(sa, sb, table):
    ta, tb = sa.read_table(table), sb.read_table(table)
    if sorted(ta) != sorted(tb):
        return False
    return all(len(ta[c]) == len(tb[c]) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(ta[c], tb[c]))
        for c in ta)


def test_partition_round_robin_explicit():
    items = list(range(10))
    parts = [tdist.partition_round_robin(items, process_id=k, num_processes=3)
             for k in range(3)]
    assert parts == [[0, 3, 6, 9], [1, 4, 7], [2, 5, 8]]
    assert parts == [jdist.partition_round_robin(items, process_id=k, num_processes=3)
                     for k in range(3)]


def test_partition_single_process_default():
    assert tdist.process_info() == (0, 1)
    assert tdist.partition_round_robin(list(range(5))) == list(range(5))


def test_store_barrier_single(tmp_path):
    store = ArtifactStore(str(tmp_path))
    tdist.barrier_via_store(store, "phase1", timeout_s=5)
    assert store.has_table("phase1_ready_0")
    assert store.read_manifest("phase1_ready_0")["meta"] == {"barrier": "phase1"}


def test_store_barrier_times_out_waiting_for_peer(tmp_path, monkeypatch):
    store = ArtifactStore(str(tmp_path))
    monkeypatch.setattr(tdist, "process_info", lambda: (0, 2))
    with pytest.raises(TimeoutError):
        tdist.barrier_via_store(store, "p", timeout_s=0.5, poll_s=0.1)


def test_maybe_init_distributed_without_configuration(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.maybe_init_distributed(backend="gloo") is False
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("env, device, card", [
    ({"LOCAL_RANK": "3", "RANK": "7"}, None, 3),     # torchrun: the node-local rank
    ({"RANK": "1"}, None, 1),                         # no LOCAL_RANK: the rank
    ({"LOCAL_RANK": "3", "RANK": "7"}, "cuda:2", 2),  # the caller's card wins
])
def test_nccl_rank_takes_its_own_card(monkeypatch, env, device, card):
    """Under NCCL, which refuses two ranks on one card, each rank sets its
    own card as the current device before the group starts; gloo sets none."""
    calls = []
    for k in ("LOCAL_RANK", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "8")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("card", d)))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw["rank"])))
    assert tdist.maybe_init_distributed(backend="nccl", device=device) is True
    assert calls == [("card", card), ("nccl", int(env["RANK"]))]
    calls.clear()
    assert tdist.maybe_init_distributed(backend="gloo") is True
    assert calls == [("gloo", int(env["RANK"]))]


def test_run_mapping_distributed_single_process(single, world1):
    """World 1 maps every cluster with the host mapper (seed = cluster
    index): the table is the host-mode mapping stage's, bitwise, and the
    merge registers the set."""
    cfg, store, out = world1
    assert out["mapping"] >= 1
    assert store.has_table("mapping_shard_0")
    assert _same_table(store, single[1], "mapping")
    model = out["merge"]
    assert model.num_registered >= 4
    assert _same_table(store, single[1], "models")


def test_run_matching_distributed_single_process(single, world1):
    """Shard 0 of 1 is the whole matching table, row for row (the merged
    table is sorted by pair; the stage writes candidate order)."""
    _, store, out = world1
    assert out["matching"] is not None and out["matching"] >= 5
    t = store.read_table("matching")
    pairs = [tuple(p) for p in np.asarray(t["pair_image_ids"]).reshape(-1, 2)]
    assert pairs == sorted(pairs)
    assert _same_rows(_rows(store, "matching", "pair_image_ids"),
                      _rows(single[1], "matching", "pair_image_ids"))
    assert _same_table(store, single[1], "extraction")


def test_extraction_shards_cover_and_match_full(single, two_ranks):
    """The 2-rank run's frame shards (frame_slice (0, 2) and (1, 2))
    partition the frame set and reproduce the unsharded stage's rows
    exactly."""
    full = _rows(single[1], "extraction", "image_id")
    shards = [_rows(two_ranks[0], f"extraction_shard_{k}", "image_id") for k in range(2)]
    assert [sorted(s) for s in shards] == [sorted(full)[0::2], sorted(full)[1::2]]
    assert _same_rows({**shards[0], **shards[1]}, full)


DIST_TABLES = [f"{s}_{suffix}" for s in ("extraction", "matching", "mapping")
               for suffix in ("shard_0", "done_ready_0", "merged_ready_0")] + [
    "extraction", "matching", "mapping", "merge_done_ready_0"]
DIST_META = [t for t in DIST_TABLES if "ready" in t] + [
    "extraction", "matching", "mapping", "mapping_shard_0"]


def _schema(store, table):
    cols = store.read_manifest(table)["columns"]
    return {c: (i["kind"], i.get("dtype"), tuple(i.get("shape", [0])[1:]),
                tuple(i.get("trailing_shape", ()))) for c, i in cols.items()}


def test_dist_tables_follow_the_jax_contract(world1, jax_world1):
    """The distributed layer's tables: the JAX stages' names, columns and
    dtypes, and the JAX meta on the tables the layer itself writes."""
    store = world1[1]
    names = set(jax_world1.list_tables()) - {"frames", "models"}
    assert names == set(store.list_tables()) - {"frames", "models"}
    assert set(DIST_TABLES) <= names
    for t in DIST_TABLES:
        assert _schema(store, t) == _schema(jax_world1, t), t
    for t in DIST_META:
        assert (store.read_manifest(t)["meta"] == jax_world1.read_manifest(t)["meta"]), t


def _store_copy(store, root):
    """A copy of a module fixture's store, which a test may then write."""
    shutil.copytree(store.root, root)
    return ArtifactStore(root)


def test_patch_match_shards_match_full(single, world1, tmp_path):
    """2-way contiguous reference blocks, and the world-1 distributed
    stage, reproduce the unsharded depth maps bitwise (each map's draws
    are keyed by its own indices). It runs on copies of the fixtures'
    stores and configuration, which it leaves as they were."""
    cfg = PipelineConfig.from_json(single[0].to_json())
    store = _store_copy(single[1], str(tmp_path / "single"))
    pm = cfg.patch_match
    pm.max_image_size, pm.overlap, pm.num_iterations = 48, 2, 2
    pm.fine_iterations, pm.window_radius = 1, 2
    stages.run_prepare_patch_match(cfg, store)
    n_full = stages.run_patch_match(cfg, store, device=CPU)
    assert n_full >= 2
    for k in range(2):
        stages.run_patch_match(cfg, store, ref_slice=(k, 2), out_table=f"pm_s{k}",
                               device=CPU)
    full = _rows(store, "patch_match", "image_id")
    shards = [_rows(store, f"pm_s{k}", "image_id") for k in range(2)]
    assert _same_rows({**shards[0], **shards[1]}, full)
    assert sorted(shards[0]) < sorted(shards[1])          # contiguous blocks
    wcfg = PipelineConfig.from_json(world1[0].to_json())
    wstore = _store_copy(world1[1], str(tmp_path / "world1"))
    wcfg.patch_match = pm
    stages.run_prepare_patch_match(wcfg, wstore)
    assert tdist.run_patch_match_distributed(wcfg, wstore, device=CPU) == n_full
    assert _same_rows(_rows(wstore, "patch_match", "image_id"), full)


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------

LOOP_IMAGES = 12


def _loop_config(store_path):
    cfg = PipelineConfig(store_path=store_path)
    cfg.sift.max_image_size = 256
    cfg.sift.max_num_features = 384
    cfg.sift.num_octaves = 3
    cfg.matching.overlap = 2
    cfg.matching.min_num_inliers = 12
    cfg.matching.loop_closure = "on"
    return cfg


@pytest.fixture(scope="module")
def loop_frames(tmp_path_factory):
    frames, gt = synth.render_dataset(num_images=LOOP_IMAGES, width=256, height=192,
                                      num_blobs=400, seed=5, track="out_and_back")
    path = str(tmp_path_factory.mktemp("loopframes") / "frames.npz")
    np.savez(path, focal=gt["focal"], **{f"frame{n:03d}": f for n, f in enumerate(frames)})
    return path, frames, gt


@pytest.fixture(scope="module")
def two_ranks(images, loop_frames, tmp_path_factory):
    """Extraction and matching of the 6-image recipe, then of the loop set,
    in 2 gloo ranks with jax refused."""
    root = tmp_path_factory.mktemp("two_ranks")
    six = _config(PipelineConfig, images, str(root / "six"))
    loop = _loop_config(str(root / "loop"))
    jobs = [(six.store_path, six.to_json(), None, ("extraction", "matching")),
            (loop.store_path, loop.to_json(), loop_frames[0], ("extraction", "matching"))]
    worker.run_ranks(worker.stages_rank, 2, root, jobs, refuse_jax=True)
    return ArtifactStore(six.store_path), ArtifactStore(loop.store_path)


@pytest.fixture(scope="module")
def loop_world1(two_ranks, tmp_path_factory):
    """World 1's matching of the loop set, on the 2-rank run's frames and
    extraction."""
    cfg = _loop_config(str(tmp_path_factory.mktemp("loop1") / "store"))
    src = two_ranks[1]
    for t in ("frames", "extraction"):
        shutil.copytree(os.path.join(src.root, t), os.path.join(cfg.store_path, t))
    store = ArtifactStore(cfg.store_path)
    tdist.run_matching_distributed(cfg, store, device=CPU)
    return cfg, store


def test_two_ranks_equal_world1(two_ranks, world1):
    store, ref = two_ranks[0], world1[1]
    for k in range(2):
        assert store.has_table(f"extraction_shard_{k}") and store.has_table(f"matching_shard_{k}")
    assert store.read_manifest("matching")["meta"] == {"stage": "matching", "num_hosts": 2}
    assert store.num_rows("extraction") == N_IMAGES
    assert store.num_rows("matching") > 5
    assert _same_table(store, ref, "extraction")
    assert _same_table(store, ref, "matching")


def test_two_rank_run_imports_no_jax(two_ranks):
    """Both ranks ran every stage with a meta-path finder refusing jax and
    the JAX package (``torch_dist_worker.RefuseJax``); a rank that imported
    either would have failed the spawn."""
    for store in two_ranks:
        for k in range(2):
            assert store.has_table(f"matching_done_ready_{k}")


def _pairs(store, table="matching"):
    return [tuple(p) for p in np.asarray(store.read_table(table)["pair_image_ids"]).reshape(-1, 2)]


def test_loop_pairs_once_under_sharding(two_ranks, loop_world1):
    store, (cfg, ref) = two_ranks[1], loop_world1
    pairs = _pairs(store)
    assert len(pairs) == len(set(pairs))
    sep = 2 * cfg.matching.overlap
    assert any(abs(a - b) > sep for a, b in pairs)         # loop pairs were verified
    manifests = [store.read_manifest(f"matching_shard_{k}")["meta"] for k in range(2)]
    assert [m["schedule_slice"] for m in manifests] == [[0, 2], [1, 2]]
    metas = [m["loop_closure"] for m in manifests]
    assert all(m["enabled"] for m in metas)
    assert sum(m["n_candidates"] for m in metas) == metas[0]["candidates_total"] > 0
    assert _same_table(store, ref, "matching")


def test_jax_shards_match_loop_pairs_twice(loop_world1, tmp_path):
    """The reference's fault the port does not copy: the JAX stage's two
    schedule slices each match every loop candidate (on a copy of the
    fixture's store)."""
    cfg, store = loop_world1
    jcfg = JConfig.from_json(cfg.to_json())
    copy = _store_copy(store, str(tmp_path / "store"))
    jstore = JStore(copy.root)
    for k in range(2):
        jstages.run_matching(jcfg, jstore, schedule_slice=(k, 2), out_table=f"jax_shard_{k}")
    sep = 2 * cfg.matching.overlap
    far = [{p for p in _pairs(copy, f"jax_shard_{k}") if abs(p[0] - p[1]) > sep}
           for k in range(2)]
    assert far[0] and far[0] == far[1]
    port_far = {p for p in _pairs(store) if abs(p[0] - p[1]) > sep}
    assert port_far and len(port_far) < len(far[0]) + len(far[1])
