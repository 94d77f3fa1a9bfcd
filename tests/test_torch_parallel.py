"""The port's scale-out layer (``scanner_colmap_tpu_torch/parallel``,
``ops/matching.match_window``) against the JAX package's on the CPU.

The port runs in 2 and 4 gloo ranks (``torch_dist_worker.run_ranks``, one
spawn per world size for the whole module); the JAX functions run on the
conftest's virtual 8-device CPU mesh. Bars:
- the halo: exact, against JAX ``windowed_gather`` on a mesh of as many
  devices as the port has ranks (the recipe of tests/test_parallel.py:24-33);
- the sharded BA in f64 on ``make_bundle_problem(M=6, P=64, T=4)`` (dense,
  CG with 64 iterations, and a tied ``cam_group`` under each solver)
  against JAX ``distributed_bundle_adjust`` on 8 devices: final cost rtol
  1e-6, qvec atol 1e-8, xyz atol 1e-6 (tests/test_parallel.py:36-46's
  own bars), and the port's world 4 against its own single-process
  ``bundle_adjust`` at the same bars; the ranks' outputs bitwise equal;
- the sharded BA (dense and CG) on the problem padded with invalid points
  to twice its size, so whole shards are padding, against the port's
  single-process solve of the unpadded problem at the same bars, and at 2
  ranks bitwise;
- ``match_window``: f32 decisions exact; bf16 decisions agree on >= 0.97
  of keypoints, every flip a near-tie (the bar of
  tests/test_torch_matching.py);
- the fused step in f64 against JAX ``make_distributed_step`` on 8 devices:
  the same shapes, the matches at the bf16 bar, final cost rtol 1e-6, and
  a tied config's intrinsics exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import torch_dist_worker as worker
from scanner_colmap_tpu.ops import matching as jmatch
from scanner_colmap_tpu.parallel import dist_ba as jdist_ba
from scanner_colmap_tpu.parallel.halo import windowed_gather as jwindowed_gather
from scanner_colmap_tpu.parallel.mesh import make_mesh as jmake_mesh
from scanner_colmap_tpu.parallel.step import make_distributed_step as jmake_step
from scanner_colmap_tpu_torch.ops import ba as tba
from scanner_colmap_tpu_torch.ops import matching as tmatch
from scanner_colmap_tpu_torch.parallel import dist_ba as tdist_ba
from scanner_colmap_tpu_torch.parallel import halo as thalo
from scanner_colmap_tpu_torch.parallel import mesh as tmesh

from tests.test_ba import make_bundle_problem

CPU = torch.device("cpu")
WORLDS = (2, 4)
VARIANTS = ("dense", "cg", "tied_dense", "tied_cg")
STEP_M, STEP_K, STEP_OVERLAP = 32, 32, 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(prefix, params, obs, cfg):
    """The JAX problem as flat numpy arrays for the ranks."""
    out = {}
    for group, x in (("params", params), ("obs", obs), ("cfg", cfg)):
        for f in x._fields:
            v = getattr(x, f)
            if v is not None:
                out[f"{prefix}{group}.{f}"] = np.asarray(v)
    return out


def _jax_tied(cfg):
    M = cfg.cc.shape[0]
    return cfg._replace(cam_group=jnp.zeros(M, jnp.int32), refine_focal=jnp.asarray(True))


@pytest.fixture(scope="module")
def problems():
    params, obs, cfg, _ = make_bundle_problem(np.random.default_rng(0), M=6, P=64, T=4)
    sp, so, sc, desc, kp_valid = graft._synthetic_bundle(M=STEP_M, Pn=256, T=4, K=STEP_K,
                                                        dtype=np.float64)
    return {"ba": (params, obs, cfg), "step": (sp, so, sc, desc, kp_valid)}


@pytest.fixture(scope="module")
def ranks(problems, tmp_path_factory):
    """{world: [rank 0's results, rank 1's, ...]}, one spawn per world."""
    root = tmp_path_factory.mktemp("parallel")
    sp, so, sc, desc, kp_valid = problems["step"]
    src = str(root / "src.npz")
    np.savez(src, **_arrays("ba.", *problems["ba"]), **_arrays("step.", sp, so, sc),
             **{"step.desc": np.asarray(desc), "step.valid": np.asarray(kp_valid)})
    out = {}
    for world in WORLDS:
        d = root / f"w{world}"
        d.mkdir()
        worker.run_ranks(worker.parallel_rank, world, d, src, str(d))
        out[world] = worker.load_ranks(d, world)
    return out


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return jmake_mesh(num_devices=8)


@pytest.fixture(scope="module")
def jax_ba(problems, jmesh):
    params, obs, cfg = problems["ba"]
    out = {}
    for name in VARIANTS:
        c = _jax_tied(cfg) if name.startswith("tied") else cfg
        solver = "cg" if name.endswith("cg") else "dense"
        p, info = jdist_ba.distributed_bundle_adjust(jmesh, params, obs, c, max_iterations=10,
                                                     chunk=8, solver=solver)
        out[name] = (p, info)
    return out


def _assert_ranks_bitwise(results, prefix):
    keys = [k for k in results[0] if k.startswith(prefix)]
    for r in results[1:]:
        for k in keys:
            assert np.array_equal(r[k], results[0][k]), k


@pytest.mark.parametrize("world", WORLDS)
def test_halo_matches_jax(ranks, world):
    x = jnp.arange(32.0).reshape(32, 1)
    ref = np.asarray(jwindowed_gather(jmake_mesh(num_devices=world), x, halo=2))
    n_local = 32 // world
    ref = ref.reshape(world, n_local + 2, 1)
    for r, res in enumerate(ranks[world]):
        assert np.array_equal(res["halo.gather"], ref)
        nxt = (np.arange((r + 1) * n_local, (r + 1) * n_local + 2)) % 32
        rows = np.concatenate([np.arange(r * n_local, (r + 1) * n_local), nxt])
        assert np.array_equal(res["halo.append.f32"][:, 0], rows.astype(np.float32))
        assert np.array_equal(res["halo.append.bool"], rows % 3 == 0)
        u8 = np.arange(32 * 5, dtype=np.uint8).reshape(32, 5)
        assert np.array_equal(res["halo.append.u8"], u8[rows])


def test_halo_larger_than_local_rows_raises():
    mesh = tmesh.make_mesh(device=CPU)
    with pytest.raises(ValueError, match="exceeds local shard rows"):
        thalo.ring_halo_append(torch.zeros(2, 3), 3, mesh)


def test_points_must_divide_over_ranks():
    p, o, c = tba.synthetic_bundle(M=4, P=10, T=2, device=CPU)
    mesh = dataclasses.replace(tmesh.make_mesh(device=CPU), size=4)
    with pytest.raises(ValueError, match="pad_to_shards"):
        tdist_ba.distributed_bundle_adjust(mesh, p, o, c)
    padded, n = tmesh.pad_to_shards(np.zeros((10, 3)), 4)
    assert padded.shape == (12, 3) and n == 10


def _assert_ba_close(res, prefix, p_ref, cost_ref):
    assert np.isclose(float(res[f"{prefix}.final_cost"]), float(cost_ref), rtol=1e-6)
    assert np.allclose(res[f"{prefix}.qvec"], np.asarray(p_ref.qvec), atol=1e-8)
    assert np.allclose(res[f"{prefix}.xyz"], np.asarray(p_ref.xyz), atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_sharded_ba_matches_jax(ranks, jax_ba, world, variant):
    res = ranks[world]
    _assert_ranks_bitwise(res, f"ba.{variant}.")
    p_j, info_j = jax_ba[variant]
    _assert_ba_close(res[0], f"ba.{variant}", p_j, info_j["final_cost"])
    if variant.startswith("tied"):
        f = res[0][f"ba.{variant}.log_f"]
        assert f.max() - f.min() == 0.0


@pytest.fixture(scope="module")
def single_ba(problems):
    """The port's single-process ``bundle_adjust`` of each variant."""
    p, o, c = worker.bundle_from_arrays(_arrays("", *problems["ba"]))
    return {name: tba.bundle_adjust(p, o, worker._tied(c) if name.startswith("tied") else c,
                                    max_iterations=10,
                                    solver="cg" if name.endswith("cg") else "dense")
            for name in VARIANTS}


@pytest.mark.parametrize("variant", VARIANTS)
def test_world4_matches_single_process(ranks, single_ba, variant):
    q, info = single_ba[variant]
    _assert_ba_close(ranks[4][0], f"ba.{variant}", q, info["final_cost"])
    assert float(ranks[4][0][f"ba.{variant}.final_cost"]) < float(info["initial_cost"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_shards_of_padding_match_single_process(ranks, single_ba, world, solver):
    """The problem padded with invalid points to twice its size, so that
    whole shards hold only padding (at 2 ranks the second, at 4 the last
    two): kernel 2's plain version, ``launch_plan`` and the CG build run on
    shards of padding. Against the single-process solve of the unpadded
    problem at the JAX bars; at 2 ranks the first shard is the whole
    problem and every sum adds zeros, so the cameras, the points and the
    cost are the single-process ones bitwise. The padding stays at zero."""
    res = ranks[world]
    pre = f"ba.padded_{solver}"
    _assert_ranks_bitwise(res, pre + ".")
    q, info = single_ba[solver]
    P = q.xyz.shape[0]
    xyz = res[0][f"{pre}.xyz"]
    assert xyz.shape == (2 * P, 3) and not xyz[P:].any()
    _assert_ba_close({f"{pre}.final_cost": res[0][f"{pre}.final_cost"],
                      f"{pre}.qvec": res[0][f"{pre}.qvec"], f"{pre}.xyz": xyz[:P]},
                     pre, q, info["final_cost"])
    if world == 2:
        for f in ("qvec", "tvec", "log_f", "k1"):
            assert np.array_equal(res[0][f"{pre}.{f}"], getattr(q, f).numpy()), f
        assert np.array_equal(xyz[:P], q.xyz.numpy())
        assert float(res[0][f"{pre}.final_cost"]) == float(info["final_cost"])


def _window(rng, W=5, K=96):
    """A window of uint8 descriptors: each image after the pivot holds a
    noisy permutation of the pivot's, and every image some invalid slots."""
    D = np.zeros((W, K, 128), np.float32)
    D[0] = rng.integers(0, 200, (K, 128))
    for j in range(1, W):
        D[j] = np.clip(D[0][rng.permutation(K)] + rng.normal(0, 12 * j, (K, 128)), 0, 255)
    V = rng.uniform(size=(W, K)) > 0.15
    return np.round(D), V


def _near_tie(D, V, w, k, precision, margin=1e-5):
    """Whether keypoint k's decision against window image w sits within
    ``margin`` of a threshold or a tie, in f64 on the matcher's operands."""
    d = D / np.maximum(np.linalg.norm(D, axis=-1, keepdims=True), 1e-8)
    if precision == "bf16":
        d = np.asarray(jnp.asarray(d, jnp.bfloat16).astype(jnp.float32), np.float64)
    sim = d[0] @ d[w].T
    sim[:, ~V[w]] = -1e9
    row = np.sort(sim[k])[::-1]
    b = int(np.argmax(sim[k]))
    col = np.sort(np.where(V[0][:, None], sim, -1e9)[:, b])[::-1]
    dist, dist2 = np.arccos(np.clip(row[:2], -1, 1))
    return min(row[0] - row[1], col[0] - col[1], abs(dist - 0.7),
               abs(dist - 0.8 * dist2)) < margin


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_match_window_matches_jax(rng, precision):
    flips = 0
    for _ in range(3):
        D, V = _window(rng)
        idx_j, ok_j = (np.asarray(x) for x in jmatch.match_window(
            jnp.asarray(D), jnp.asarray(V), precision=precision))
        idx_t, ok_t = tmatch.match_window(torch.from_numpy(D), torch.from_numpy(V),
                                          precision=precision)
        idx_t, ok_t = idx_t.numpy(), ok_t.numpy()
        assert idx_t.dtype == np.int32 and idx_t.shape == idx_j.shape
        assert np.array_equal(ok_t, idx_t >= 0) and ok_t.sum() > 0.3 * V[0].sum()
        diff = np.argwhere(idx_t != idx_j)
        flips += len(diff)
        if precision == "f32":
            assert len(diff) == 0
        for w, k in diff:
            assert _near_tie(D, V, w + 1, k, precision), (w, k)
        assert (idx_t == idx_j).mean(axis=1).min() >= 0.97
    print(f"match_window {precision}: {flips} decisions flip against JAX")


@pytest.fixture(scope="module")
def jax_step(problems, jmesh):
    sp, so, sc, desc, kp_valid = problems["step"]
    step = jmake_step(jmesh, overlap=STEP_OVERLAP, ba_iterations=2, chunk=16)
    return {name: step(desc, kp_valid, sp, so, cfg)
            for name, cfg in (("untied", sc), ("tied", _jax_tied(sc)))}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tied", ["untied", "tied"])
def test_fused_step_matches_jax(ranks, jax_step, problems, world, tied):
    res = ranks[world]
    _assert_ranks_bitwise(res, f"step.{tied}.final_cost")
    _assert_ranks_bitwise(res, f"step.{tied}.xyz")
    idx_j, ok_j, p_j, info_j = jax_step[tied]
    idx_t = np.concatenate([r[f"step.{tied}.idx"] for r in res])
    ok_t = np.concatenate([r[f"step.{tied}.ok"] for r in res])
    assert idx_t.shape == np.asarray(idx_j).shape == (STEP_M, STEP_OVERLAP, STEP_K)
    assert np.array_equal(ok_t, idx_t >= 0)
    desc, valid = (np.asarray(x) for x in problems["step"][3:])
    idx_j = np.asarray(idx_j)
    for i, w, k in np.argwhere(idx_t != idx_j):
        rows = (i + np.arange(STEP_OVERLAP + 1)) % STEP_M
        assert _near_tie(desc[rows], valid[rows], w + 1, k, "bf16"), (i, w, k)
    assert (idx_t == idx_j).mean() >= 0.97
    assert np.isclose(float(res[0][f"step.{tied}.final_cost"]), float(info_j["final_cost"]),
                      rtol=1e-6)
    assert float(res[0][f"step.{tied}.final_cost"]) <= float(info_j["initial_cost"])
    if tied == "tied":
        f = res[0][f"step.{tied}.log_f"]
        assert f.max() - f.min() == 0.0
