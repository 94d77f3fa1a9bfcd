"""The port's batched cluster mapper (``mapper.device_batch_clusters``)
and the connectivity schedule against the JAX package, on CPU.

The scenes are tests/test_incremental.py's ``build_synthetic_scene`` with
the port's correspondence graph. Bars: each lane of a batched run, and a
cluster mapped alone, against the JAX package's mapper on the same
clusters (the same registered images and points, and poses, points and
focal length within the bars of ``_held_to_jax``); the JAX recipe's counts
and ATE (tests/test_device_mapper.py::test_device_batch_mixed_sizes); on
the CPU each lane of a batched run is bitwise its cluster's own run (the
same registered images, poses and points), as the lane-batched LM, PnP and
kernel 2's plain version are bitwise their single-problem calls; the
connectivity order equals JAX's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_incremental
from test_incremental import align_and_ate, build_synthetic_scene
from scanner_colmap_tpu.engine import device_cluster as jdc
from scanner_colmap_tpu.engine.cluster import subgraph as jsubgraph
from scanner_colmap_tpu.utils import flops as jflops
from scanner_colmap_tpu.utils.config import MapperConfig as JaxMapperConfig
from scanner_colmap_tpu_torch.engine import device_cluster as tdc
from scanner_colmap_tpu_torch.engine import cluster as tcluster
from scanner_colmap_tpu_torch.engine.cluster import run_clustered_mapping, subgraph
from scanner_colmap_tpu_torch.engine.correspondence import make_graph
from scanner_colmap_tpu_torch.kernels import schur as tschur
from scanner_colmap_tpu_torch.models import geometry as tgeom
from scanner_colmap_tpu_torch.ops import ba as tba
from scanner_colmap_tpu_torch.ops import pnp as tpnp
from scanner_colmap_tpu_torch.utils import flops as tflops
from scanner_colmap_tpu_torch.utils import metrics as tmetrics
from scanner_colmap_tpu_torch.utils.config import MapperConfig

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs, beside the other test
    workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recording_graph():
    """The port's graph, keeping each pair's match list as the stage's
    graph build does (``pair_matches``), which track building reads."""
    g = make_graph()
    g.pair_matches = {}
    add = g.add_matches

    def add_matches(i, j, pairs):
        add(i, j, pairs)
        g.pair_matches[(i, j)] = np.asarray(pairs)

    g.add_matches = add_matches
    return g


def _port_scene(monkeypatch, seed=0, **kw):
    monkeypatch.setattr(test_incremental, "CorrespondenceGraph", _recording_graph)
    return build_synthetic_scene(np.random.default_rng(seed), **kw)


def _cfg(cls=MapperConfig):
    cfg = cls()
    cfg.init_min_num_inliers = 20
    cfg.abs_pose_min_num_inliers = 12
    cfg.single_camera = True
    return cfg


def _args(kp, cams, graph, tv, groups, sub=subgraph):
    out = []
    for ci, members in enumerate(groups):
        g, tvs = sub(graph, tv, members)
        out.append(({i: kp[i] for i in members}, {i: cams[i] for i in members}, g, tvs, ci))
    return out


def test_batch_recipe_of_the_jax_package(monkeypatch):
    """tests/test_device_mapper.py::test_device_batch_mixed_sizes on the
    port: 9 and 4 images and a 2-image cluster that cannot seed."""
    kp, cams, graph, tv, (qs, ts, _) = _port_scene(monkeypatch, num_images=10,
                                                   num_points=300)
    args = _args(kp, cams, graph, tv, [list(range(0, 9)), list(range(6, 10))])
    g_e, _ = subgraph(graph, tv, [0, 9])
    args.append(({0: kp[0], 9: kp[9]}, {0: cams[0], 9: cams[9]}, g_e, {}, 99))
    recs = tdc.map_clusters_device_batch(args, _cfg(), device=CPU)
    assert len(recs) == 3
    assert recs[0].num_registered >= 8
    assert recs[1].num_registered >= 3
    assert recs[2].num_registered == 0
    assert align_and_ate(recs[0], qs, ts) < 0.05


# three clusters of one shape (M 16): one chunk of three lanes
LANE_GROUPS = [list(range(0, 9)), list(range(1, 10)), list(range(0, 8)) + [9]]


@pytest.fixture(scope="module")
def lane_runs(_one_torch_thread):
    """The port's batched run of LANE_GROUPS on a 10-image scene: (cluster
    arguments, results, CHUNK_LOG, ground truth)."""
    with pytest.MonkeyPatch.context() as mp:
        kp, cams, graph, tv, gt = _port_scene(mp, num_images=10, num_points=300)
    args = _args(kp, cams, graph, tv, LANE_GROUPS)
    tdc.CHUNK_LOG.clear()
    recs = tdc.map_clusters_device_batch(args, _cfg(), device=CPU)
    return args, recs, list(tdc.CHUNK_LOG), gt


def _held_to_jax(rec, ref):
    """``rec`` (the port) against ``ref`` (the JAX package) on one cluster:
    the same registered images, the same triangulated tracks (point ids are
    track indices) with the same observations each, then, after the Sim(3) that best maps rec's camera centres
    onto ref's, every centre within 1e-4 of ref's centre span, every
    rotation within 0.05 degrees, every point within 3e-3 of the span and
    the shared focal length within 5e-4 relative. The two mappers draw
    their RANSAC samples from different generators and solve in f32, so
    they stop at nearby optima: on these scenes the largest differences
    were 1.7e-5, 0.011 degrees, 6.1e-4 and 1.05e-4."""
    ids = sorted(ref.registered_image_ids)
    assert sorted(rec.registered_image_ids) == ids and len(ids) >= 8
    assert rec.points3D.keys() == ref.points3D.keys() and len(ref.points3D) > 250
    for k, p in ref.points3D.items():
        assert sorted(rec.points3D[k].track) == sorted(p.track), k
    want = np.stack([ref.images[i].projection_center() for i in ids])
    got = np.stack([rec.images[i].projection_center() for i in ids])
    s, q, t = tgeom.np_umeyama_alignment(got, want)
    R = tgeom.np_quat_to_rotmat(q)
    span = np.linalg.norm(want.max(0) - want.min(0))
    assert np.linalg.norm(s * got @ R.T + t - want, axis=1).max() <= 1e-4 * span
    for i in ids:
        rel = (tgeom.np_quat_to_rotmat(ref.images[i].qvec)
               @ (tgeom.np_quat_to_rotmat(rec.images[i].qvec) @ R.T).T)
        assert np.degrees(np.arccos(np.clip((np.trace(rel) - 1) / 2, -1, 1))) <= 0.05
    keys = sorted(ref.points3D)
    X = np.stack([rec.points3D[k].xyz for k in keys])
    Y = np.stack([ref.points3D[k].xyz for k in keys])
    assert np.linalg.norm(s * X @ R.T + t - Y, axis=1).max() <= 3e-3 * span
    f_rec = {c.params[0] for c in rec.cameras.values()}
    f_ref = {c.params[0] for c in ref.cameras.values()}
    assert len(f_rec) == len(f_ref) == 1
    assert abs(f_rec.pop() / f_ref.pop() - 1) <= 5e-4


def test_lanes_match_the_jax_batched_mapper(lane_runs):
    """Each lane of the port's batched run against the same cluster's lane
    of the JAX package's map_clusters_device_batch."""
    _, recs, _, _ = lane_runs
    kp, cams, graph, tv, _ = build_synthetic_scene(np.random.default_rng(0),
                                                   num_images=10, num_points=300)
    want = jdc.map_clusters_device_batch(
        _args(kp, cams, graph, tv, LANE_GROUPS, jsubgraph), _cfg(JaxMapperConfig))
    for rec, ref in zip(recs, want):
        _held_to_jax(rec, ref)


def test_one_cluster_matches_the_jax_mapper(monkeypatch):
    """map_cluster_device (a batched run of one lane) against the JAX
    package's map_cluster_device on an 8-image cluster."""
    kp, cams, graph, tv, _ = build_synthetic_scene(np.random.default_rng(0), num_images=8)
    ref = jdc.map_cluster_device(kp, cams, graph, tv, _cfg(JaxMapperConfig), seed=0)
    kp, cams, graph, tv, _ = _port_scene(monkeypatch, num_images=8)
    _held_to_jax(tdc.map_cluster_device(kp, cams, graph, tv, _cfg(), seed=0, device=CPU), ref)


def test_lanes_equal_their_clusters_own_runs(lane_runs):
    """Three clusters of one shape run as three lanes of one batched run
    (one chunk, device_batch_size 8), then each alone."""
    args, batched, chunks, (qs, ts, _) = lane_runs
    assert chunks == [3]
    for a, rec in zip(args, batched):
        alone = tdc.map_cluster_device(*a[:4], _cfg(), seed=a[4], device=CPU)
        assert sorted(rec.registered_image_ids) == sorted(alone.registered_image_ids)
        assert rec.num_registered >= 8
        for i in rec.registered_image_ids:
            assert np.array_equal(rec.images[i].qvec, alone.images[i].qvec)
            assert np.array_equal(rec.images[i].tvec, alone.images[i].tvec)
        assert rec.points3D.keys() == alone.points3D.keys()
        assert all(np.array_equal(p.xyz, alone.points3D[k].xyz)
                   for k, p in rec.points3D.items())
        assert align_and_ate(rec, qs, ts) < 0.05


def test_clustered_mapping_batched_stats(monkeypatch):
    """run_clustered_mapping with device_batch_clusters: lanes, chunks of at
    most device_batch_size, the scheduled FLOPs of every cluster."""
    kp, cams, graph, tv, _ = _port_scene(monkeypatch, num_images=10, num_points=300)
    cfg = _cfg()
    cfg.cluster_size, cfg.cluster_overlap = 6, 4
    cfg.device_batch_clusters, cfg.device_batch_size = True, 2
    model, subs = run_clustered_mapping(kp, cams, graph, tv, cfg, merge=False, device=CPU)
    stats = tcluster.LAST_MAPPING_STATS
    assert model is None
    assert stats["batched"] and stats["n_clusters"] == 3
    assert sum(stats["chunks"]) == 3 and max(stats["chunks"]) == 2
    assert len(subs) == 3 and min(stats["registered"]) >= 5
    want = 3 * tflops.device_mapper_flops(8, 512, 6, 6, cfg.device_ba_iters_per_step,
                                          cfg.device_final_ba_iters, cfg.device_pnp_trials)
    assert stats["scheduled_tflop"] == pytest.approx(want / 1e12)


@pytest.mark.parametrize("lanes", [1, 2])
def test_host_reads_of_a_device_map_are_its_sites(monkeypatch, lanes):
    """``count.host_reads`` of a device map (one cluster, or two lanes of
    one batched run) is its sites' hand count: the schedule's two reads
    (with lanes, and the shared scalars' check), one a scheduled step, one
    a PnP, one a LM trial (its stop; the CPU builds no ``CamSegments``
    plan) and the result's download."""
    kp, cams, graph, tv, _ = _port_scene(monkeypatch, num_images=6, num_points=200)
    args = _args(kp, cams, graph, tv, [list(range(6))] * lanes)
    cfg = _cfg()
    orders = np.stack([tdc._prepare_cluster(*a[:4], cfg)["order"] for a in args])
    steps = int((orders.max(0) >= 0).sum())
    was = tmetrics.set_tracing(True)
    tmetrics.GLOBAL_METRICS.reset()
    try:
        recs = tdc.map_clusters_device_batch(args, cfg, device=CPU, batch_size=lanes)
        d = tmetrics.GLOBAL_METRICS.stage(tmetrics.RUN)
    finally:
        tmetrics.set_tracing(was)
        tmetrics.GLOBAL_METRICS.reset()
    assert all(r.num_registered >= 5 for r in recs)
    assert d["span.mapping.cluster.n"] == 1
    assert d["span.mapping.prepare.n"] == d["span.mapping.unpack.n"] == lanes
    assert d["span.mapping.ba.n"] == d["span.mapping.triangulate.n"] >= 2
    pnp_n, trials = d["span.mapping.pnp.n"], d["count.ba.lm_trials"]
    assert pnp_n >= 4 and trials >= d["span.mapping.ba.n"]
    assert d["count.host_reads"] == 2 + (lanes > 1) + steps + pnp_n + trials + 1


def test_clustered_mapping_merges_like_jax(monkeypatch):
    """tests/test_device_mapper.py::test_device_mode_clustered's recipe
    (10 images, clusters of 7 with overlap 3) through both packages'
    ``run_clustered_mapping(kp, cams, graph, tv, cfg)``, which returns
    (merged model, submodels) in both: the same submodel count and
    registered images, and the merged model held to ``_held_to_jax``: the
    same point ids with the same track each, then its tolerances on the
    centres, rotations, points and focal."""
    from scanner_colmap_tpu.engine.cluster import run_clustered_mapping as jrun

    kp, cams, graph, tv, _ = build_synthetic_scene(np.random.default_rng(0),
                                                   num_images=10, num_points=300)
    cfg_j = _cfg(JaxMapperConfig)
    cfg_j.mode, cfg_j.cluster_size, cfg_j.cluster_overlap = "device", 7, 3
    ref, ref_subs = jrun(kp, cams, graph, tv, cfg_j)
    kp, cams, graph, tv, (qs, ts, _) = _port_scene(monkeypatch, num_images=10,
                                                   num_points=300)
    cfg = _cfg()
    cfg.mode, cfg.cluster_size, cfg.cluster_overlap = "device", 7, 3
    model, subs = run_clustered_mapping(kp, cams, graph, tv, cfg, device=CPU)
    assert len(subs) == len(ref_subs) == 2
    assert [sorted(s.registered_image_ids) for s in subs] == [
        sorted(s.registered_image_ids) for s in ref_subs]
    assert sorted(model.registered_image_ids) == sorted(ref.registered_image_ids)
    assert model.num_registered >= 9 and align_and_ate(model, qs, ts) < 0.08
    _held_to_jax(model, ref)


@pytest.mark.parametrize("seed,n_img", [(0, 8), (3, 10)])
def test_connectivity_order_equals_jax(monkeypatch, seed, n_img):
    kp, _, g_j, tv, _ = build_synthetic_scene(np.random.default_rng(seed), num_images=n_img)
    _, _, g_t, _, _ = _port_scene(monkeypatch, seed, num_images=n_img)
    members = sorted(kp)
    for a, b in [(0, 3), (2, 5), (members[-1], members[-4])]:
        want = jdc._registration_order(members, g_j, a, b)
        assert tdc._registration_order(members, g_t, a, b) == want
    # a member subset whose graph falls apart: the leftovers in member order
    sub = [0, 1, 2, members[-2], members[-1]]
    assert (tdc._registration_order(sub, g_t, 0, 1)
            == jdc._registration_order(sub, g_j, 0, 1))


def test_connectivity_schedule_maps_the_cluster(monkeypatch):
    kp, cams, graph, tv, (qs, ts, _) = _port_scene(monkeypatch, num_images=8)
    cfg = _cfg()
    cfg.device_schedule = "connectivity"
    rec = tdc.map_cluster_device(kp, cams, graph, tv, cfg, device=CPU)
    assert rec.num_registered >= 7 and align_and_ate(rec, qs, ts) < 0.05
    cfg.device_schedule = "random"
    with pytest.raises(ValueError, match="device_schedule"):
        tdc.map_cluster_device(kp, cams, graph, tv, cfg, device=CPU)


def _lane_problem(tied):
    """Three seeded ba.synthetic_bundle problems laid end to end."""
    probs = []
    for s in range(3):
        params, obs, cfg = tba.synthetic_bundle(M=8, P=256, T=4, seed=s, device=CPU)
        if tied:
            cfg = dataclasses.replace(cfg, cam_group=torch.zeros(8, dtype=torch.int32),
                                      refine_focal=torch.tensor(True),
                                      prior_weight_f=torch.full((8,), 0.1))
        probs.append((params, obs, cfg))
    lanes = tba.Lanes.of(torch.stack([p[1].cam_idx for p in probs]), 8)
    params = tba.BundleParams(*(torch.cat([getattr(p[0], f.name) for p in probs])
                                for f in dataclasses.fields(tba.BundleParams)))
    obs = tba.BundleObs(lanes.cam_idx(), torch.cat([p[1].uv for p in probs]),
                        torch.cat([p[1].valid for p in probs]))

    def field(name):
        v = getattr(probs[0][2], name)
        if v is None or v.dim() == 0:
            return v
        if name == "cam_group":
            return torch.cat([p[2].cam_group + 8 * c for c, p in enumerate(probs)])
        return torch.cat([getattr(p[2], name) for p in probs])

    cfg = tba.BundleConfig(**{f.name: field(f.name) for f in dataclasses.fields(tba.BundleConfig)})
    return probs, params, obs, cfg, lanes


@pytest.mark.parametrize("tied", [False, True], ids=["per_image", "tied_intrinsics"])
def test_lane_lm_equals_bundle_adjust_per_lane(tied):
    """Each lane of bundle_adjust_lanes is bitwise bundle_adjust on its own
    problem; an inactive lane keeps its state bitwise."""
    probs, params, obs, cfg, lanes = _lane_problem(tied)
    active = torch.tensor([True, False, True])
    out = tba.bundle_adjust_lanes(params, obs, cfg, lanes, active, max_iterations=10)
    for c, prob in enumerate(probs):
        want = tba.bundle_adjust(*prob, max_iterations=10)[0] if active[c] else prob[0]
        cams, pts = slice(8 * c, 8 * c + 8), slice(256 * c, 256 * c + 256)
        assert torch.equal(out.qvec[cams], want.qvec) and torch.equal(out.tvec[cams], want.tvec)
        assert torch.equal(out.log_f[cams], want.log_f)
        assert torch.equal(out.xyz[pts], want.xyz)


def test_pnp_lanes_equal_single_problems(rng):
    X = torch.tensor(rng.uniform([-2, -1.5, 4], [2, 1.5, 8], (3, 128, 3)), dtype=torch.float32)
    xn = X[..., :2] / X[..., 2:] + torch.tensor(rng.normal(0, 0.01, (3, 128, 2)),
                                                dtype=torch.float32)
    valid = torch.tensor(rng.uniform(size=(3, 128)) < 0.8)
    thr = torch.full((3,), 0.02)
    min_inl = torch.full((3,), 12.0)

    def gens():
        return [torch.Generator().manual_seed(s) for s in range(3)]

    lanes = tpnp.pnp_ransac(gens(), X, xn, valid, thr, min_num_inliers=min_inl,
                            min_inlier_ratio=0.0)
    for c in range(3):
        one = tpnp.pnp_ransac(gens()[c], X[c], xn[c], valid[c], thr[c],
                              min_num_inliers=min_inl[c], min_inlier_ratio=0.0)
        for f in dataclasses.fields(one):
            assert torch.equal(getattr(one, f.name), getattr(lanes, f.name)[c]), f.name
        assert bool(one.ok)


def test_schur_plain_lanes_equal_per_lane_calls():
    probs, params, obs, cfg, lanes = _lane_problem(False)
    cam, Wc, Vinv = tba.schur_inputs(params, obs, cfg)
    S = tschur.schur_accumulate(lanes.cam_local, Wc.view(3, 256, 4, 8, 3),
                                Vinv.view(3, 256, 3, 3), 8)
    assert S.shape == (3, 64, 64)
    for c, prob in enumerate(probs):
        assert torch.equal(S[c], tschur.schur_accumulate(*tba.schur_inputs(*prob), 8))
    with pytest.raises(ValueError):
        tschur.schur_accumulate(lanes.cam_local, Wc.view(3, 256, 4, 8, 3), Vinv, 8)


@pytest.mark.parametrize("M,P", [(8, 1024), (16, 2048), (64, 2048), (256, 8192)])
def test_schur_launch_plan_keeps_lanes_co_resident(M, P):
    """Lanes x tiles x splits within MAX_SPLIT_BLOCKS wherever the launch
    is split (cooperative); one lane's plan is the single call's."""
    _, tiles1, splits1 = tschur.launch_plan(M, P)
    for C in (1, 3, 8, 32):
        _, tiles, splits = tschur.launch_plan(M, P, C)
        assert tiles == tiles1 and splits >= 1
        assert splits == 1 or C * tiles * splits <= tschur.MAX_SPLIT_BLOCKS
        assert splits <= splits1
    assert tschur.launch_plan(M, P, 1) == tschur.launch_plan(M, P)


@pytest.mark.parametrize("M,P,T", [(8, 512, 8), (16, 1024, 12), (32, 4096, 16)])
def test_flops_equal_jax(M, P, T):
    assert tflops.matching_flops(M, P) == jflops.matching_flops(M, P)
    assert tflops.ba_flops_per_iter(M, P, T) == jflops.ba_flops_per_iter(M, P, T)
    assert tflops.ba_cg_flops_per_iter(M, P, T, 64) == jflops.ba_cg_flops_per_iter(M, P, T, 64)
    for n, it, fin in ((M - 1, 8, 60), (M // 2, 4, 40)):
        assert (tflops.device_mapper_flops(M, P, T, n, it, fin)
                == jflops.device_mapper_flops(M, P, T, n, it, fin))
    assert tflops.patch_match_taps(M, P, 4, 5, T) == jflops.patch_match_taps(M, P, 4, 5, T)
    assert (tflops.patch_match_taps(M, P, 4, 5, T, window_step=2)
            == jflops.patch_match_taps(M, P, 4, 5, T, window_step=2))


def test_flops_peaks_know_the_h100_only():
    assert tflops.device_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert tflops.device_peak_tflops("NVIDIA H100 80GB HBM3", "f32") == 67.0
    assert tflops.device_peak_tbps("NVIDIA H100 80GB HBM3") == 3.35
    for other in ("cpu", "TPU v5 lite", "NVIDIA A100-SXM4-80GB"):
        assert tflops.device_peak_tflops(other) is None
        assert tflops.device_peak_tbps(other) is None
    with pytest.raises(ValueError):
        tflops.device_peak_tflops("NVIDIA H100 80GB HBM3", "fp8")
