"""The port's multi-view triangulation against the plain reference
(``benchmark/reference/triangulate.py``), the split of a large batched
``eigh`` (``ops/two_view.EIGH_MAX_BATCH``), and the device mapper's track
capacity (``engine/device_cluster.track_capacity``) with its drop counter.

The card's part (``cuda``-marked, skipped without one):

    python -m pytest --noconftest -m cuda tests/test_torch_triangulate_chunks.py
"""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import triangulate as ref
from scanner_colmap_tpu_torch.engine import device_cluster as dc
from scanner_colmap_tpu_torch.engine.correspondence import make_graph
from scanner_colmap_tpu_torch.models import cameras as camlib
from scanner_colmap_tpu_torch.ops import triangulate, two_view
from scanner_colmap_tpu_torch.utils import metrics as tm
from scanner_colmap_tpu_torch.utils.config import MapperConfig, PipelineConfig

# Relative agreement of a point with the reference's on a well-conditioned
# track. Both solve in float64: the reference by an SVD of the 2M x 4
# system, the port by the eigenvector of its normal matrix, which squares
# the system's condition number (here under 1e3), so they differ by about
# 1e-16 x 1e6 at most. An f32 computation rounds at 6e-8 relative before
# any squaring and lands 1e-5 to 1e-3 away: it fails this by orders of
# magnitude (test_f32_fails_the_tolerance).
REL = 1e-9
THR_N = 0.01                 # normalised reprojection threshold
MIN_ANGLE = math.radians(1.5)


def _quat_y(angle):
    return [math.cos(angle / 2), 0.0, math.sin(angle / 2), 0.0]


def _tracks(seed, B=64, M=8):
    """Seeded tracks of 2-8 views on an arc of cameras looking at points
    4-8 units away; observations with 1e-4 noise, some views masked, one
    view in four (of tracks with four or more) an outlier the
    reprojection test drops. Returns qvecs, tvecs, xn, mask, as float64."""
    rng = np.random.default_rng(seed)
    q = np.zeros((B, M, 4))
    t = np.zeros((B, M, 3))
    xn = np.zeros((B, M, 2))
    mask = np.zeros((B, M), bool)
    for b in range(B):
        X = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1), rng.uniform(4, 8)])
        n = rng.integers(2, M + 1)
        views = np.sort(rng.choice(M, n, replace=False))
        for m in range(M):
            ang = -0.3 + 0.6 * m / (M - 1)
            qv = np.array(_quat_y(ang))
            w, x, y, z = qv
            R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                          [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                          [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
            C = np.array([3.0 * math.sin(ang), 0.0, 6.0 - 6.0 * math.cos(ang)])
            q[b, m], t[b, m] = qv, -R @ C
            xc = R @ X + t[b, m]
            xn[b, m] = xc[:2] / xc[2] + rng.normal(size=2) * 1e-4
        mask[b, views] = True
        if n >= 4:
            xn[b, views[rng.integers(n)]] += rng.choice([-1, 1], 2) * 0.05
    return tuple(torch.as_tensor(a) for a in (q, t, xn)) + (torch.as_tensor(mask),)


def _ref_dlt(q, t, xn, mask):
    """The reference's point of every track."""
    out = []
    for b in range(len(mask)):
        views = torch.nonzero(mask[b]).flatten().tolist()
        R = torch.stack([ref.rotation(q[b, m]) for m in views])
        P = torch.cat([R, t[b, views][:, :, None]], dim=2)
        out.append(ref.triangulate_point(P, xn[b, views]))
    return torch.stack(out)


def _rel(a, b):
    return (torch.linalg.norm(a - b, dim=-1) / torch.linalg.norm(b, dim=-1)).max().item()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dlt_matches_the_reference(seed):
    q, t, xn, mask = _tracks(seed)
    P = triangulate.projection_matrices(q, t)
    got = triangulate.triangulate_dlt(P, xn, mask)
    assert _rel(got, _ref_dlt(q, t, xn, mask)) < REL


@pytest.mark.parametrize("seed", [3, 4])
def test_tracks_match_the_reference(seed):
    """Points, accepted tracks and passing views; among them tracks the
    reprojection test trims and tracks too narrow for the angle test."""
    q, t, xn, mask = _tracks(seed)
    thr = torch.full((len(mask),), THR_N, dtype=torch.float64)
    xyz, ok, view_ok = triangulate.triangulate_tracks(q, t, xn, mask, thr, MIN_ANGLE)
    rxyz, rok, rview = ref.triangulate_tracks(q, t, xn, mask, thr, MIN_ANGLE)
    assert _rel(xyz, rxyz) < REL
    assert torch.equal(ok, rok) and torch.equal(view_ok, rview)
    assert 0 < int(ok.sum()) < len(ok)                       # both outcomes occur
    assert int((mask & ~view_ok).sum()) > 0                  # views the tests drop


def test_f32_fails_the_tolerance():
    q, t, xn, mask = _tracks(0)
    P = triangulate.projection_matrices(q, t)
    got = triangulate.triangulate_dlt(P.float(), xn.float(), mask).double()
    assert _rel(got, _ref_dlt(q, t, xn, mask)) > 100 * REL


@pytest.mark.parametrize("shape", [(50, 16, 4), (3, 11, 18, 9)])
def test_split_eigh_is_the_single_call(monkeypatch, shape):
    """Past the limit the batch is split into calls in order; on the CPU
    the result is bitwise the one call's."""
    A = torch.randn(*shape, dtype=torch.float64, generator=torch.Generator().manual_seed(5))
    whole = two_view._smallest_eigvec(A)
    calls = []
    eigh = torch.linalg.eigh
    monkeypatch.setattr(two_view, "EIGH_MAX_BATCH", 7)
    monkeypatch.setattr(torch.linalg, "eigh", lambda M: calls.append(len(M)) or eigh(M))
    split = two_view._smallest_eigvec(A)
    n = int(np.prod(shape[:-2]))
    assert calls == [7] * (n // 7) + ([n % 7] if n % 7 else [])
    assert len(calls) == two_view.eigh_calls(n)
    assert split.shape == whole.shape and torch.equal(split, whole)


def test_eigh_calls():
    lim = two_view.EIGH_MAX_BATCH
    assert [two_view.eigh_calls(n) for n in (0, 1, lim, lim + 1, 262144)] == [
        1, 1, 1, 2, -(-262144 // lim)]


def test_track_capacity_follows_the_features():
    cfg = PipelineConfig()
    assert dc.track_capacity(cfg.mapper, cfg.sift.max_num_features) == 8192
    assert cfg.mapper.device_max_points == 8192
    assert dc.track_capacity(cfg.mapper, 8192) == 32768
    assert dc.track_capacity(cfg.mapper, 3000) == 12000
    assert dc.track_capacity(cfg.mapper, 512) == 8192
    cfg.mapper.device_max_points = 50000
    assert dc.track_capacity(cfg.mapper, 8192) == 50000


def _tiny_cluster(n_img=4, n_pts=30):
    """Four images that all see 30 points: 30 tracks of four views."""
    rng = np.random.default_rng(0)
    kp = {i: rng.uniform(0, 640, (n_pts, 2)) for i in range(n_img)}
    cams = {i: (camlib.SIMPLE_PINHOLE, [600.0, 320.0, 240.0], 640, 480, True)
            for i in range(n_img)}
    g = make_graph()
    g.pair_matches = {}
    tv = {}
    for i in range(n_img):
        g.add_image(i, n_pts)
    for i in range(n_img):
        for j in range(i + 1, n_img):
            pairs = np.stack([np.arange(n_pts)] * 2, 1)
            g.add_matches(i, j, pairs)
            g.pair_matches[(i, j)] = pairs
            tv[(i, j)] = {"qvec": np.array([1.0, 0, 0, 0]), "tvec": np.array([1.0, 0, 0]),
                          "tri_angle": 0.2, "num_inliers": n_pts, "config": 2}
    return kp, cams, g, tv


@pytest.mark.parametrize("cap, per_feature, dropped", [(10, 0, 20), (25, 0, 5), (10, 1, 0),
                                                        (8192, 4, 0)])
def test_tracks_dropped_counts_the_cut(monkeypatch, cap, per_feature, dropped):
    """30 tracks over images of 30 keypoints each, against capacities of
    10, 25 and 30 (1 a keypoint) and the default."""
    monkeypatch.setattr(dc, "TRACKS_PER_FEATURE", per_feature)
    cfg = MapperConfig()
    cfg.device_max_points = cap
    cfg.init_min_num_inliers = 10
    was = tm.set_tracing(True)
    tm.GLOBAL_METRICS.reset()
    try:
        prep = dc._prepare_cluster(*_tiny_cluster(), cfg)
        got = tm.GLOBAL_METRICS.stage(tm.RUN)
    finally:
        tm.set_tracing(was)
        tm.GLOBAL_METRICS.reset()
    assert got["count.mapping.tracks_dropped"] == dropped
    assert len(prep["tr_len"]) == 30 - dropped


def test_spans_and_counters_only_with_tracing():
    """Off, the default, the capacity cut records nothing."""
    tm.GLOBAL_METRICS.reset()
    cfg = MapperConfig()
    cfg.device_max_points, cfg.init_min_num_inliers = 10, 10
    assert not tm.tracing()
    dc._prepare_cluster(*_tiny_cluster(), cfg)
    assert tm.GLOBAL_METRICS.to_dict() == {}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [31292, 262144])
def test_eigh_past_cusolvers_batch_on_the_card(card, batch):
    """The 4x4 batch that raised in cuSOLVER's buffer query (31292, and the
    retriangulation's chunk of 262144) runs split, and each matrix's
    vector is the one a call within the limit gives it."""
    g = torch.Generator(device=card).manual_seed(batch)
    A = torch.randn(batch, 8, 4, dtype=torch.float64, device=card, generator=g)
    v = two_view._smallest_eigvec(A)
    assert v.shape == (batch, 4) and bool(torch.isfinite(v).all())
    head = two_view._smallest_eigvec(A[:1000])
    assert torch.equal(v[:1000], head)
    AtA = torch.einsum("bki,bkj->bij", A, A)
    resid = torch.linalg.norm(torch.einsum("bij,bj->bi", AtA, v), dim=-1)
    lam = torch.linalg.eigvalsh(AtA[:2000])[:, 0]
    assert torch.allclose(resid[:2000], lam, rtol=1e-8, atol=1e-10)
