"""Parity of the port's dense-Schur bundle adjustment with the JAX package.

- Kernel 2's plain version (the wrapper's route for CPU tensors) against
  the Pallas Schur kernel in interpret mode and against the XLA einsum
  reference, at relative Frobenius error 1e-5: all are f32 sums of the
  same products in different orders.
- The normal equations and the full LM solve on the reference's
  ``__graft_entry__._synthetic_bundle`` problem, moved over with
  ``interop.bundle_from_numpy``: S and rhs at 1e-5 relative, and the final
  cost within 1e-3 relative (the two LM runs may stop one iteration apart
  when the relative cost change sits near the tolerance).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from scanner_colmap_tpu.ops import ba as jba
from scanner_colmap_tpu.ops import pallas_ba
from scanner_colmap_tpu_torch import interop
from scanner_colmap_tpu_torch.kernels import schur
from scanner_colmap_tpu_torch.ops import ba as tba


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_plain_schur_matches_pallas_and_xla(rng):
    M, P, T = 16, 512, 6
    cam = rng.integers(0, M, (P, T)).astype(np.int32)
    Wc = rng.normal(size=(P, T, 8, 3)).astype(np.float32)
    Wc[:, T - 2:] *= (rng.uniform(size=(P, 2, 1, 1)) > 0.5)   # dead slots
    V = rng.normal(size=(P, 3, 3)).astype(np.float32)
    Vinv = V + V.transpose(0, 2, 1)
    B = np.zeros((P, M, 8, 3), np.float32)
    for t in range(T):
        np.add.at(B, (np.arange(P), cam[:, t]), Wc[:, t])
    B = B.reshape(P, M * 8, 3)
    s_pal = np.asarray(pallas_ba.schur_accumulate(jnp.asarray(B), jnp.asarray(Vinv),
                                                  interpret=True))
    s_xla = np.asarray(pallas_ba.schur_accumulate_xla(jnp.asarray(B),
                                                      jnp.asarray(Vinv), chunk=256))
    s_t = schur.schur_accumulate(torch.from_numpy(cam), torch.from_numpy(Wc),
                                 torch.from_numpy(Vinv), M).numpy()
    assert _rel(s_t, s_xla) <= 1e-5
    assert _rel(s_t, s_pal) <= 1e-5
    s_dense = schur.schur_dense(torch.from_numpy(B), torch.from_numpy(Vinv)).numpy()
    assert _rel(s_dense, s_xla) <= 1e-5


@pytest.mark.parametrize("M,P,T", [(16, 512, 6), (32, 1024, 4)])
def test_plain_schur_duplicates_and_dead_points(M, P, T):
    # tracks that see one camera two or three times, and a run of all-dead
    # points (the engines' P padding, cam_idx 0 with Wc = 0)
    g = np.random.default_rng(M + P)
    cam = g.integers(0, M, (P, T)).astype(np.int32)
    cam[::2, 1] = cam[::2, 0]
    cam[::5, 2] = cam[::5, 0]
    Wc = g.normal(size=(P, T, 8, 3)).astype(np.float32)
    cam[P - P // 4:] = 0
    Wc[P - P // 4:] = 0
    V = g.normal(size=(P, 3, 3)).astype(np.float32)
    Vinv = V + V.transpose(0, 2, 1)
    B = np.zeros((P, M, 8, 3), np.float32)
    for t in range(T):
        np.add.at(B, (np.arange(P), cam[:, t]), Wc[:, t])
    B = B.reshape(P, M * 8, 3)
    s_pal = np.asarray(pallas_ba.schur_accumulate(jnp.asarray(B), jnp.asarray(Vinv),
                                                  interpret=True))
    s_xla = np.asarray(pallas_ba.schur_accumulate_xla(jnp.asarray(B),
                                                      jnp.asarray(Vinv), chunk=256))
    s_t = schur.schur_accumulate(torch.from_numpy(cam), torch.from_numpy(Wc),
                                 torch.from_numpy(Vinv), M).numpy()
    assert _rel(s_t, s_xla) <= 1e-5
    assert _rel(s_t, s_pal) <= 1e-5


@pytest.mark.parametrize("M", [1, 4, 16, 20, 40, 64, 128, 256, 1000])
def test_schur_launch_plan_covers_every_block_once(M):
    # the kernel's grid depends on (M, P) only; its tiles R1 <= R2 and
    # their mirrors cover each (c1, c2) camera block of S exactly once
    assert list(inspect.signature(schur.launch_plan).parameters) == ["M", "P"]
    for P in (0, 1, 100, 512, 2048, 8192, 100000):
        windows, tiles, splits = schur.launch_plan(M, P)
        assert (windows, tiles, splits) == schur.launch_plan(M, P)
        assert windows * schur.WINDOW >= M > (windows - 1) * schur.WINDOW
        assert splits == 1 or (tiles * splits <= schur.MAX_SPLIT_BLOCKS
                               and splits <= -(-P // schur.MIN_SPLIT_POINTS))
        count = np.zeros((M, M), int)
        for tile in range(tiles):
            r1, r2 = schur.tile_windows(windows, tile)
            assert 0 <= r1 <= r2 < windows
            c1 = np.arange(r1 * schur.WINDOW, min(M, (r1 + 1) * schur.WINDOW))
            c2 = np.arange(r2 * schur.WINDOW, min(M, (r2 + 1) * schur.WINDOW))
            count[np.ix_(c1, c2)] += 1
            if r1 != r2:
                count[np.ix_(c2, c1)] += 1
        assert (count == 1).all()


def _problem(tied: bool):
    params, obs, cfg, _, _ = graft._synthetic_bundle()
    if tied:
        M = params.qvec.shape[0]
        cfg = cfg._replace(refine_focal=jnp.asarray(True),
                           refine_distortion=jnp.asarray(True),
                           prior_weight_f=jnp.full(M, 10.0, jnp.float32),
                           prior_weight_k=jnp.full(M, 100.0, jnp.float32),
                           cam_group=jnp.zeros(M, jnp.int32))
    return params, obs, cfg


@pytest.mark.parametrize("tied", [False, True], ids=["per_image", "tied"])
def test_normal_equations_match_reference(tied):
    params, obs, cfg = _problem(tied)
    S_j, rhs_j = jba._build_normal_eqs(params, obs, cfg, jnp.float32(1e-3), 64)[:2]
    tp, to, tc = interop.bundle_from_numpy(params, obs, cfg, device="cpu")
    S_t, rhs_t = tba._build_normal_eqs(tp, to, tc, torch.tensor(1e-3))[:2]
    assert _rel(S_t.numpy(), np.asarray(S_j)) <= 1e-5
    assert _rel(rhs_t.numpy(), np.asarray(rhs_j)) <= 1e-5


@pytest.mark.parametrize("tied", [False, True], ids=["per_image", "tied"])
def test_bundle_adjust_matches_reference(tied):
    params, obs, cfg = _problem(tied)
    pj, ij = jba.bundle_adjust(params, obs, cfg, max_iterations=10, chunk=64)
    tp, to, tc = interop.bundle_from_numpy(params, obs, cfg, device="cpu")
    pt, it = tba.bundle_adjust(tp, to, tc, max_iterations=10)
    c0_j, c_j = float(ij["initial_cost"]), float(ij["final_cost"])
    c0_t, c_t = float(it["initial_cost"]), float(it["final_cost"])
    assert abs(c0_t - c0_j) <= 1e-5 * c0_j
    assert c_j < 0.1 * c0_j
    assert abs(c_t - c_j) <= 1e-3 * c_j
    assert np.abs(pt.xyz.numpy() - np.asarray(pj.xyz)).max() < 1e-2
    if tied:   # tied slots keep bitwise-equal intrinsics
        assert torch.all(pt.log_f == pt.log_f[0]) and torch.all(pt.k1 == pt.k1[0])


def test_synthetic_bundle_solves():
    p, o, c = tba.synthetic_bundle(M=6, P=128, T=3, seed=2, device="cpu")
    _, info = tba.bundle_adjust(p, o, c, max_iterations=15)
    assert float(info["final_cost"]) < 0.05 * float(info["initial_cost"])
    cam_idx, Wc, Vinv = tba.schur_inputs(p, o, c)
    assert cam_idx.dtype == torch.int32 and Wc.shape == (128, 3, 8, 3)
    assert Vinv.shape == (128, 3, 3)
