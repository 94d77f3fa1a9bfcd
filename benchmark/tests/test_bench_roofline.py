"""The frozen roofline formulas give the bound column of the kernels'
table in PERF.md (the bounds the kernels were designed against)."""

import pytest

from benchmark.roofline import pair_match, peaks, plane_cost, schur


def _ms(flops, nbytes, kind):
    return 1e3 * peaks.least_seconds(flops, nbytes, kind)


@pytest.mark.parametrize("K,pairs,n_img,expect", [(640, 75, 16, 0.00795),
                                                  (8192, 32, 8, 0.556)])
def test_kernel1(K, pairs, n_img, expect):
    f, b = pair_match.work(pairs * K * K, n_img * K * 128, n_img * K, pairs, K)
    assert _ms(f, b, pair_match.KIND) == pytest.approx(expect, rel=5e-3)


@pytest.mark.parametrize("M,P,T,seed,expect", [(16, 2048, 16, 0, 0.00271),
                                               (256, 8192, 16, 1, 0.0122)])
def test_kernel2(M, P, T, seed, expect):
    import torch

    from scanner_colmap_tpu_torch.ops import ba

    params, obs, cfg = ba.synthetic_bundle(M=M, P=P, T=T, seed=seed,
                                           device=torch.device("cpu"))
    cam, Wc, Vinv = ba.schur_inputs(params, obs, cfg)
    L = (Wc != 0).flatten(2).any(-1).sum(1).double()
    f, b = schur.work(L.sum().item(), (L * L).sum().item(), (L > 0).sum().item(),
                      (8 * M) ** 2)
    assert _ms(f, b, schur.KIND) == pytest.approx(expect, rel=5e-3)


@pytest.mark.parametrize("P,T,M", [(2048, 16, 16), (8192, 16, 256)])
def test_kernel2_bytes_every_slot_live(P, T, M):
    """With every slot live the live count is the padded inputs' size."""
    padded = 4 * (P * T + P * T * 8 * 3 + P * 3 * 3 + (8 * M) ** 2)
    assert schur.live_bytes(P * T, P, (8 * M) ** 2) == padded
    assert schur.live_bytes(P * T // 4, P, (8 * M) ** 2) < padded


@pytest.mark.parametrize("H,W,S,expect", [(96, 96, 4, 0.00318), (160, 192, 4, 0.01089),
                                          (384, 480, 8, 0.1328)])
def test_kernel4_per_candidate(H, W, S, expect):
    f, b = plane_cost.sweep_work(H, W, S, plane_cost.window_offsets(5), H, W)
    per_candidate = _ms(f, b, plane_cost.KIND) / plane_cost.SWEEP_CANDIDATES
    assert per_candidate == pytest.approx(expect, rel=5e-3)


def test_window_offsets_are_the_kernels():
    from scanner_colmap_tpu_torch.kernels import plane_cost as pc

    taps = pc.window_taps(5, 1, 5.0, "cpu")
    assert sorted(taps.offsets) == sorted(plane_cost.window_offsets(5))
