"""Kernel 4 (``kernels/plane_cost.py``, PatchMatch's plane cost with the
Jacobi update) against its plain PyTorch version, on the card. These tests
need a CUDA device and nvcc; elsewhere they skip. They import no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_plane_cost_cuda.py

Tolerance: both routes round every product and sum in the same order, so
they could differ only where expf or the best-half mean's order does; the
single-candidate entries are held to a cost within 1e-5 and the same
update decision on >= 99.9% of the pixels, the others near-ties (costs
within 1e-5). A sweep (``plane_cost_sweep``, ten candidates a call) is held
to the bit: the state and each candidate's cost equal the plain sweep's,
whether the wrapper builds the tap-weight table or is given it. Two
launches are bitwise equal: each pixel sums in a fixed order, with no
atomics.
"""

import numpy as np
import pytest
import torch

from scanner_colmap_tpu_torch import kernels
from scanner_colmap_tpu_torch.kernels import plane_cost as pc
from scanner_colmap_tpu_torch.ops import patch_match as tpm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def problem(dev, H=37, W=53, S=3, Hs=None, Ws=None, seed=0):
    """Random smooth images and a small-baseline rig; slot S-1 invalid."""
    g = np.random.default_rng(seed)
    Hs, Ws = Hs or H, Ws or W

    def smooth(h, w):
        a = g.uniform(size=(h + 4, w + 4))
        return sum(a[i:i + h, j:j + w] for i in range(5) for j in range(5)).astype(np.float32) / 25

    f = 0.9 * max(W, H)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    R = np.stack([np.eye(3) + 0.01 * np.array([[0, -1, 0.5], [1, 0, -0.3], [-0.5, 0.3, 0]]) * s
                  for s in range(S)]).astype(np.float32)
    t = np.stack([[0.2 * (s + 1) * (-1) ** s, 0.03 * s, 0.01] for s in range(S)]).astype(np.float32)
    valid = np.ones(S, bool)
    valid[-1] = S < 2
    up = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    prob = tpm.PatchMatchProblem(up(smooth(H, W)), up(np.stack([smooth(Hs, Ws) for _ in range(S)])),
                                 up(K), up(np.stack([K] * S)), up(R), up(t), 3.0, 6.0, up(valid))
    depth = up(g.uniform(3.0, 6.0, (H, W)).astype(np.float32))
    n = g.normal(size=(H, W, 3)) * 0.3
    n[..., 2] = -1
    normal = up((n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32))
    return prob, depth, normal


def both_routes(prob, depth, normal, radius, step=1, geom=None):
    prep = tpm._prepare(prob, "field")
    taps = pc.window_taps(radius, step, 3.0, depth.device)
    args = (prep.ref, prep.pack, prep.k_ref, prep.k_src, prep.R, prep.t, prep.src_valid, taps,
            depth, normal)
    bad = 2.0 if geom is None else 2.9
    kern = pc.plane_cost(*args, geom=geom, bad=bad)
    plain = pc.plane_cost_plain(*args, geom=geom, bad=bad)
    return kern, plain, args


@pytest.mark.parametrize("shape", [(37, 53, 3, None, None), (16, 16, 1, None, None),
                                   (40, 64, 8, 72, 80), (24, 33, 16, None, None)],
                         ids=["ragged", "one_tile", "tiled_band", "s_max"])
@pytest.mark.parametrize("radius,step", [(3, 1), (5, 1), (5, 2)])
def test_cost_matches_plain(dev, shape, radius, step):
    H, W, S, Hs, Ws = shape
    prob, depth, normal = problem(dev, H, W, S, Hs, Ws)
    kern, plain, _ = both_routes(prob, depth, normal, radius, step)
    assert kern.shape == (H, W)
    assert (kern - plain).abs().max().item() <= 1e-5


def test_geometric_term_matches_plain(dev):
    prob, depth, normal = problem(dev)
    prep = tpm._prepare(prob, "field")
    src_d = depth.expand(3, -1, -1).contiguous() * 1.01
    geom = tpm._field_geom(prep, depth, normal, src_d, 0.3, 3.0)
    kern, plain, _ = both_routes(prob, depth, normal, 5, geom=geom)
    assert (kern - plain).abs().max().item() <= 1e-5


def test_update_takes_the_plain_decisions(dev):
    prob, depth, normal = problem(dev, 48, 64, 4)
    _, d2, n2 = problem(dev, 48, 64, 4, seed=1)
    kern, plain, args = both_routes(prob, depth, normal, 5)
    state_k = [depth.clone(), normal.clone(), kern.clone()]
    state_p = [depth.clone(), normal.clone(), plain.clone()]
    cand_args = args[:8] + (d2, n2)
    c_new = pc.plane_cost_plain(*cand_args)
    pc.plane_cost_update(*cand_args, *state_k)
    better = c_new < state_p[2]
    state_p = [torch.where(better, d2, state_p[0]), torch.where(better[..., None], n2, state_p[1]),
               torch.where(better, c_new, state_p[2])]
    same = state_k[0] == state_p[0]
    assert same.float().mean().item() >= 0.999
    assert (state_k[2] - state_p[2]).abs().max().item() <= 1e-5
    assert torch.equal(state_k[1][same], state_p[1][same])


def test_two_launches_are_bitwise_equal_and_counted(dev):
    prob, depth, normal = problem(dev, 64, 80, 5)
    kernels.reset_launch_counts()
    a, _, args = both_routes(prob, depth, normal, 5)
    b = pc.plane_cost(*args)
    assert torch.equal(a, b)
    assert kernels.launch_counts()["plane_cost"] == 2


def test_patch_match_on_the_card_runs_the_kernel(dev):
    prob, _, _ = problem(dev, 40, 56, 3)
    kernels.reset_launch_counts()
    d1 = tpm.patch_match(prob, num_iterations=2, generator=tpm.pm_generator(dev, 0))
    calls = kernels.launch_counts()["plane_cost"]
    assert calls == 1 + 2            # the initial pass, then one call a sweep
    d2 = tpm.patch_match(prob, num_iterations=2, generator=tpm.pm_generator(dev, 0))
    for a, b in zip(d1, d2):
        assert torch.equal(a, b)


def test_wrapper_refuses_a_strided_input(dev):
    prob, depth, normal = problem(dev)
    prep = tpm._prepare(prob, "field")
    taps = pc.window_taps(3, 1, 3.0, dev)
    strided = torch.empty((depth.shape[1], depth.shape[0]), device=dev).t()
    strided.copy_(depth)
    with pytest.raises(ValueError, match="contiguous"):
        pc.plane_cost(prep.ref, prep.pack, prep.k_ref, prep.k_src, prep.R, prep.t,
                      prep.src_valid, taps, strided, normal)


def sweep_case(dev, H, W, S, radius, step, seed=0):
    """(base arguments, sweep-start state, extra fields) at one shape."""
    prob, d0, n0 = problem(dev, H, W, S, seed=seed)
    _, d1, n1 = problem(dev, H, W, S, seed=seed + 1)
    _, d2, n2 = problem(dev, H, W, S, seed=seed + 2)
    prep = tpm._prepare(prob, "field")
    taps = pc.window_taps(radius, step, 3.0, dev)
    base = (prep.ref, prep.pack, prep.k_ref, prep.k_src, prep.R, prep.t, prep.src_valid, taps)
    return base, (d0, n0, pc.plane_cost_plain(*base, d0, n0)), (torch.stack([d1, d2]),
                                                                torch.stack([n1, n2]))


def kernel_sweep(base, state, extras, **kw):
    st = [a.clone() for a in state]
    means = torch.empty((10,) + st[0].shape, device=st[0].device)
    pc.plane_cost_sweep(*base, *st, *extras, means=means, **kw)
    return st + [means]


@pytest.mark.parametrize("S", [1, 3, 8, 16])
@pytest.mark.parametrize("radius,step", [(3, 1), (5, 1), (5, 2)])
def test_sweep_equals_the_plain_sweep_bitwise(dev, S, radius, step):
    base, state, extras = sweep_case(dev, 37, 53, S, radius, step, seed=S)
    a = kernel_sweep(base, state, extras)
    b = kernel_sweep(base, state, extras, weights=pc.tap_weights(base[0], base[7]))
    plain = [x.clone() for x in state]
    means = torch.empty_like(a[3])
    pc.plane_cost_sweep_plain(*base, *plain, *extras, means=means)
    for x, y, z in zip(a, b, plain + [means]):
        assert torch.equal(x, y)
        assert torch.equal(x, z)
    assert not torch.equal(a[2], state[2])        # some candidate won somewhere


def test_sweep_with_the_geometric_term_equals_plain(dev):
    base, state, extras = sweep_case(dev, 37, 53, 3, 5, 1)
    geom = torch.rand((10, 3, 37, 53), device=dev) * 0.9
    a = kernel_sweep(base, state, extras, geom=geom, bad=2.9)
    plain = [x.clone() for x in state]
    means = torch.empty_like(a[3])
    pc.plane_cost_sweep_plain(*base, *plain, *extras, geom=geom, bad=2.9, means=means)
    for x, y in zip(a, plain + [means]):
        assert torch.equal(x, y)


def test_tap_weights_equal_the_plain_table(dev):
    base, _, _ = sweep_case(dev, 37, 53, 2, 5, 1)
    assert torch.equal(pc.tap_weights(base[0], base[7], 0.3),
                       pc.tap_weights_plain(base[0], base[7], 0.3))


def test_sweep_is_one_call_and_two_launches(dev):
    """One wrapper call a sweep; on the card (torch.profiler) its cost pass
    and finish, and the table's launch where the wrapper builds it."""
    base, state, extras = sweep_case(dev, 40, 48, 4, 5, 1)
    weights = pc.tap_weights(base[0], base[7])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        kernel_sweep(base, state, extras, weights=weights)
        kernel_sweep(base, state, extras)
        torch.cuda.synchronize()
    assert kernels.launch_counts()["plane_cost"] == 2
    counts = {}
    for e in prof.key_averages():
        for name in ("plane_cost_pass", "plane_cost_finish", "plane_weight_kernel"):
            if name in e.key:
                counts[name] = counts.get(name, 0) + e.count
    assert counts == {"plane_cost_pass": 2, "plane_cost_finish": 2, "plane_weight_kernel": 1}


def test_sweep_refuses_a_strided_or_misshaped_input(dev):
    base, state, (ed, en) = sweep_case(dev, 37, 53, 3, 3, 1)
    st = [a.clone() for a in state]
    strided = torch.empty((2, 53, 37), device=dev).transpose(1, 2)
    strided.copy_(ed)
    with pytest.raises(ValueError, match="contiguous"):
        pc.plane_cost_sweep(*base, *st, strided, en)
    with pytest.raises(ValueError, match="geom"):
        pc.plane_cost_sweep(*base, *st, ed, en, geom=torch.zeros((3, 37, 53), device=dev))
    with pytest.raises(ValueError, match="extra_n"):
        pc.plane_cost_sweep(*base, *st, ed, en[:1])
