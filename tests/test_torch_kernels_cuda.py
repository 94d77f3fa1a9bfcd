"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. These tests need a CUDA device and nvcc; elsewhere they skip.
They import no jax, so they run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: kernel 1's row reductions are f32 sums of exact bf16 products
(on the tensor cores), so they agree with the plain f32 matmul to 1e-6 and
the decisions agree on >= 99.9% of rows; kernel 2 sums the same f32
products as its plain version in another (but fixed) order, so S agrees at
1e-5 relative Frobenius error and two runs are bitwise equal; kernel 3
sums f32 products in another order than the plain matmul, so best and
second agree to 1e-5 and argbest on >= 99.9% of rows; its reverse argbest
equals the plain version's and its own swapped launch's argbest exactly
(these seeded inputs hold no column near-tie), and two runs are bitwise
equal (its only atomics are order-free maxima).
"""

import numpy as np
import pytest
import torch

from scanner_colmap_tpu_torch.kernels import pair_match as tpm
from scanner_colmap_tpu_torch.kernels import schur as tschur
from scanner_colmap_tpu_torch.kernels import top2 as ttop2

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("K", [64, 128, 192, 640])
def test_pair_match_kernel_matches_plain(dev, K):
    # K = 64 and 192: the second warpgroup's rows lie past K and the last
    # column tile is half masked
    g = np.random.default_rng(K)
    D = g.integers(0, 255, (6, K, 128)).astype(np.float32)
    V = np.ones((6, K), np.float32)
    for i in range(6):
        n = int(g.integers(K // 2, K + 1))
        V[i, n:] = 0
        D[i, n:] = 0
    D /= np.maximum(np.linalg.norm(D, axis=-1, keepdims=True), 1e-8)
    pool = torch.tensor(D, device=dev).to(torch.bfloat16)
    vb = torch.tensor(V, device=dev)
    ai = torch.tensor([0, 1, 2, 3, 5], dtype=torch.int32, device=dev)
    bi = torch.tensor([1, 2, 3, 4, 0], dtype=torch.int32, device=dev)
    before = tpm.pair_match.launches
    out = tpm.pair_match(pool, vb, ai, bi)
    ref = tpm.pair_match_plain(pool, vb, ai, bi)
    torch.cuda.synchronize()
    assert tpm.pair_match.launches == before + 1
    assert (out[0] - ref[0]).abs().max().item() <= 1e-6
    assert (out[1] - ref[1]).abs().max().item() <= 1e-6
    assert (out[2] == ref[2]).float().mean().item() >= 0.999
    assert (out[3] == ref[3]).float().mean().item() >= 0.999


def _schur_inputs(M, P, T, seed, dev):
    """Random blocks with tracks that see one camera twice, dead slots and
    a run of all-dead points (the P padding of the engines)."""
    g = np.random.default_rng(seed)
    cam = g.integers(0, M, (P, T)).astype(np.int32)
    cam[::3, 1 % T] = cam[::3, 0]                  # one camera seen twice
    Wc = g.normal(size=(P, T, 8, 3)).astype(np.float32)
    Wc[:, T - 1] *= g.uniform(size=(P, 1, 1)) > 0.5  # dead slots
    Wc[P // 2: P // 2 + P // 8] = 0                # all-dead points
    V = g.normal(size=(P, 3, 3)).astype(np.float32)
    return (torch.tensor(cam, device=dev), torch.tensor(Wc, device=dev),
            torch.tensor(V + V.transpose(0, 2, 1), device=dev))


@pytest.mark.parametrize("M,P,T", [(4, 64, 4), (16, 2048, 16), (20, 300, 6),
                                   (40, 500, 8), (16, 256, 32), (256, 4096, 16)])
def test_schur_kernel_matches_plain(dev, M, P, T):
    # M = 4, 20, 40: ragged last window; M = 256: 136 tiles, no split
    cam, Wc, Vinv = _schur_inputs(M, P, T, P + M, dev)
    before = tschur.schur_accumulate.launches
    S = tschur.schur_accumulate(cam, Wc, Vinv, M)
    again = tschur.schur_accumulate(cam, Wc, Vinv, M)
    R = tschur.schur_accumulate_plain(cam, Wc, Vinv, M)
    torch.cuda.synchronize()
    assert tschur.schur_accumulate.launches == before + 2
    assert ((S - R).norm() / R.norm()).item() <= 1e-5
    assert torch.equal(S, again)


def test_schur_kernel_ignores_cameras_out_of_range(dev):
    M, P, T = 20, 200, 5
    cam, Wc, Vinv = _schur_inputs(M, P, T, 7, dev)
    bad = torch.zeros_like(cam, dtype=torch.bool)
    bad[::4, 2], bad[1::4, 3] = True, True
    cam_bad = torch.where(bad, torch.where(cam % 2 == 0, -1 - cam, M + cam), cam)
    S = tschur.schur_accumulate(cam_bad, Wc, Vinv, M)
    R = tschur.schur_accumulate_plain(cam, Wc * (~bad)[..., None, None], Vinv, M)
    torch.cuda.synchronize()
    assert ((S - R).norm() / R.norm()).item() <= 1e-5


def test_schur_kernel_no_points(dev):
    S = tschur.schur_accumulate(torch.zeros((0, 4), dtype=torch.int32, device=dev),
                                torch.zeros((0, 4, 8, 3), device=dev),
                                torch.zeros((0, 3, 3), device=dev), 3)
    torch.cuda.synchronize()
    assert S.shape == (24, 24) and not S.any()


@pytest.mark.parametrize("K", [128, 700])
def test_top2_kernel_matches_plain(dev, K):
    g = np.random.default_rng(K)
    D = g.normal(size=(5, K, 128)).astype(np.float32)
    D /= np.linalg.norm(D, axis=-1, keepdims=True)
    V = (g.uniform(size=(5, K)) > 0.2).astype(np.float32)
    bank = torch.tensor(D, device=dev)
    vb = torch.tensor(V, device=dev)
    ai = torch.tensor([0, 1, 2, 3, 4], dtype=torch.int32, device=dev)
    bi = torch.tensor([1, 2, 3, 4, 0], dtype=torch.int32, device=dev)
    before = ttop2.top2_bank.launches
    out = ttop2.top2_bank(bank, vb, ai, bi)
    again = ttop2.top2_bank(bank, vb, ai, bi)
    swapped = ttop2.top2_bank(bank, vb, bi, ai)
    ref = ttop2.top2_bank_plain(bank, vb, ai, bi)
    torch.cuda.synchronize()
    assert ttop2.top2_bank.launches == before + 3
    assert (out[0] - ref[0]).abs().max().item() <= 1e-5
    assert (out[1] - ref[1]).abs().max().item() <= 1e-5
    assert (out[2] == ref[2]).float().mean().item() >= 0.999
    assert torch.equal(out[3], ref[3])
    # one launch's reverse argbest is the swapped launch's argbest, bitwise
    assert torch.equal(out[3], swapped[2])
    assert torch.equal(swapped[3], out[2])
    assert all(torch.equal(x, y) for x, y in zip(out, again))


def test_wrappers_reject_non_contiguous(dev):
    Wc = torch.zeros((8, 4, 3, 8), device=dev).transpose(2, 3)
    with pytest.raises(ValueError):
        tschur.schur_accumulate(torch.zeros((8, 4), dtype=torch.int32, device=dev),
                                Wc, torch.zeros((8, 3, 3), device=dev), 2)
    bank = torch.zeros((2, 128, 128), device=dev).transpose(1, 2)
    ab = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        ttop2.top2_bank(bank, torch.ones((2, 128), device=dev), ab[:1], ab[1:])
