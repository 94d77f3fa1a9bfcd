"""Kernel 4's sweep entry (``kernels/plane_cost.plane_cost_sweep``, one call
a Jacobi sweep for all ten candidates) against the loop it replaces: ten
``plane_cost_update`` calls on ``torch.roll``-materialised candidates, in
the scan's order. On the CPU both run the plain versions, whose arithmetic
is the same, so every comparison here is bitwise: the state, each
candidate's cost, and a whole ``patch_match`` (and ``patch_match_tiled``
over two bands). The wrapper's input checks, and no launch counted on the
CPU. Small shapes (<= 24x32, radius <= 3) and one torch thread.
"""

import numpy as np
import pytest
import torch

from scanner_colmap_tpu_torch import kernels
from scanner_colmap_tpu_torch.kernels import plane_cost as pc
from scanner_colmap_tpu_torch.ops import patch_match as tpm


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: the tier-1 run has six
    workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def problem(H=20, W=28, S=3, seed=0):
    """Smooth random images, a small-baseline rig (the last of S > 1 slots
    padded), a state and two extra candidate fields."""
    g = np.random.default_rng(seed)

    def smooth(h, w):
        a = g.uniform(size=(h + 4, w + 4))
        return sum(a[i:i + h, j:j + w] for i in range(5) for j in range(5)).astype(np.float32) / 25

    def field():
        n = g.normal(size=(H, W, 3)) * 0.3
        n[..., 2] = -1
        return (torch.as_tensor(g.uniform(3.0, 6.0, (H, W)).astype(np.float32)),
                torch.as_tensor((n / np.linalg.norm(n, axis=-1, keepdims=True))
                                .astype(np.float32)))

    f = 0.9 * max(W, H)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    R = np.stack([np.eye(3) + 0.01 * s * np.array([[0, -1, 0.5], [1, 0, -0.3], [-0.5, 0.3, 0]])
                  for s in range(S)]).astype(np.float32)
    t = np.stack([[0.2 * (s + 1) * (-1) ** s, 0.03 * s, 0.01] for s in range(S)]).astype(np.float32)
    valid = np.ones(S, bool)
    valid[-1] = S < 2
    up = torch.as_tensor
    prob = tpm.PatchMatchProblem(up(smooth(H, W)), up(np.stack([smooth(H, W) for _ in range(S)])),
                                 up(K), up(np.stack([K] * S)), up(R), up(t), 3.0, 6.0, up(valid))
    return prob, field(), field(), field()


def reference_sweep(base, state, extras, geom=None, bad=2.0):
    """The loop the sweep replaces: ten plane_cost_update calls on
    candidates materialised at the sweep's start, in order."""
    depth, normal, cost = state
    cands = [(torch.roll(depth, s, (0, 1)), torch.roll(normal, s, (0, 1))) for s in tpm.SHIFTS]
    cands += list(extras)
    means = []
    for c, (cd, cn) in enumerate(cands):
        g = None if geom is None else geom[c]
        means.append(pc.plane_cost_plain(*base, cd, cn, g, bad=bad))
        pc.plane_cost_update(*base, cd.contiguous(), cn.contiguous(), depth, normal, cost,
                             geom=g, bad=bad)
    return torch.stack(means)


def assert_same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("S", [1, 3, 5])
@pytest.mark.parametrize("step,geometric", [(1, False), (2, False), (1, True)],
                         ids=["step1", "step2", "geometric"])
def test_sweep_equals_the_update_loop(S, step, geometric):
    prob, (d0, n0), (d1, n1), (d2, n2) = problem(S=S, seed=S)
    prep = tpm._prepare(prob, "field")
    taps = pc.window_taps(3, step, 3.0, "cpu")
    base = (prep.ref, prep.pack, prep.k_ref, prep.k_src, prep.R, prep.t, prep.src_valid, taps)
    geom, bad = None, 2.0
    if geometric:
        src_d = d1.expand(S, -1, -1).contiguous() * 1.01
        cands = [(torch.roll(d0, s, (0, 1)), torch.roll(n0, s, (0, 1))) for s in tpm.SHIFTS]
        geom = torch.stack([tpm._field_geom(prep, cd, cn, src_d, 0.3, 3.0)
                            for cd, cn in cands + [(d1, n1), (d2, n2)]])
        bad = 2.9
    c0 = pc.plane_cost(*base, d0, n0, geom=None if geom is None else geom[0], bad=bad)
    ref_state = [d0.clone(), n0.clone(), c0.clone()]
    ref_means = reference_sweep(base, ref_state, ((d1, n1), (d2, n2)), geom, bad)
    extra_d, extra_n = torch.stack([d1, d2]), torch.stack([n1, n2])
    for weights in (None, pc.tap_weights(prep.ref, taps)):
        state = [d0.clone(), n0.clone(), c0.clone()]
        means = torch.empty((10,) + d0.shape)
        pc.plane_cost_sweep(*base, *state, extra_d, extra_n, geom=geom, bad=bad,
                            weights=weights, means=means)
        assert_same(state, ref_state)
        assert torch.equal(means, ref_means)
    # the sweep moved the state: some candidates won somewhere
    assert not torch.equal(ref_state[2], c0)


def test_tap_weights_equal_the_inline_weights():
    prob, (d0, n0), _, _ = problem(S=2)
    prep = tpm._prepare(prob, "field")
    taps = pc.window_taps(3, 1, 3.0, "cpu")
    base = (prep.ref, prep.pack, prep.k_ref, prep.k_src, prep.R, prep.t, prep.src_valid, taps)
    w = pc.tap_weights(prep.ref, taps, 0.3)
    assert w.shape == (49,) + d0.shape
    assert torch.equal(w[24], taps.wsp[24] * torch.ones_like(d0))     # the center tap
    assert (w[0, :3] == 0).all() and (w[0, :, :3] == 0).all()           # off the canvas
    assert torch.equal(pc.plane_cost_plain(*base, d0, n0, sigma_color=0.3, weights=w),
                       pc.plane_cost_plain(*base, d0, n0, sigma_color=0.3))


def reference_patch_match(problem, num_iterations=5, window_radius=3, window_step=1,
                          sigma_spatial=3.0, sigma_color=0.2, src_depths=None,
                          geom_weight=0.3, max_geom_error=3.0, init_depth=None,
                          init_normal=None, sampling="field", generator=None, draws=None):
    """``patch_match`` as it was with one kernel-4 call per candidate."""
    ref = problem.ref_image
    H, W = ref.shape
    dtype, dev = ref.dtype, ref.device
    dmin, dmax = float(np.float32(problem.depth_min)), float(np.float32(problem.depth_max))
    if draws is None:
        draws = tpm.Draws(generator if generator is not None else tpm.pm_generator(dev),
                          dmin, dmax)
    prep = tpm._prepare(problem, sampling)
    taps = pc.window_taps(window_radius, window_step, sigma_spatial, dev)
    base = (prep.ref, prep.pack, prep.k_ref, prep.k_src, prep.R, prep.t, prep.src_valid, taps)
    bad = 2.0 if src_depths is None else 2.0 + geom_weight * max_geom_error

    def geom(cd, cn):
        return None if src_depths is None else tpm._field_geom(
            prep, cd, cn, src_depths.to(dtype).contiguous(), geom_weight, max_geom_error)

    if init_depth is None or init_normal is None:
        d0, g0 = draws.initial(H, W, dtype, dev)
    depth = (init_depth.to(dtype) if init_depth is not None else d0).contiguous().clone()
    normal = (init_normal.to(dtype) if init_normal is not None
              else tpm._random_normals(g0)).contiguous().clone()
    cost = pc.plane_cost(*base, depth, normal, geom(depth, normal), sigma_color, bad)
    for it in range(num_iterations):
        u, g, rd, gr = draws.sweep(H, W, dtype, dev)
        cands = [(torch.roll(depth, s, (0, 1)), torch.roll(normal, s, (0, 1)))
                 for s in tpm.SHIFTS]
        scale = 0.5 ** (it + 1.0)
        pd = torch.clamp(depth * (1.0 + scale * u), dmin, dmax)
        pn = normal + scale * g
        pn = pn / torch.clamp(torch.linalg.vector_norm(pn, dim=-1, keepdim=True), min=1e-9)
        pn = torch.cat([pn[..., :2], -pn[..., 2:].abs()], dim=-1)
        cands.append((pd, pn))
        cands.append((rd, tpm._random_normals(gr)))
        for cd, cn in cands:
            cd, cn = cd.contiguous(), cn.contiguous()
            pc.plane_cost_update(*base, cd, cn, depth, normal, cost, geom(cd, cn),
                                 sigma_color, bad)
    return depth, normal, cost


@pytest.mark.parametrize("case", ["untiled", "geometric", "two_bands"])
def test_patch_match_equals_the_reference_loop(case, monkeypatch):
    prob, (d0, n0), (d1, _), _ = problem(H=24, W=32, S=3, seed=7)
    kw = dict(num_iterations=2, window_radius=2, sigma_color=0.25)
    if case == "geometric":
        kw.update(src_depths=d1.expand(3, -1, -1) * 1.01, init_depth=d0, init_normal=n0)
    if case == "two_bands":
        got = tpm.patch_match_tiled(prob, tile_rows=12, halo_rows=4, seed=(1, 2), **kw)
        monkeypatch.setattr(tpm, "patch_match", reference_patch_match)
        want = tpm.patch_match_tiled(prob, tile_rows=12, halo_rows=4, seed=(1, 2), **kw)
    else:
        got = tpm.patch_match(prob, generator=tpm.pm_generator("cpu", 5), **kw)
        want = reference_patch_match(prob, generator=tpm.pm_generator("cpu", 5), **kw)
    assert_same(got, want)
    assert got[0].shape == (24, 32)


def _sweep_args(S=2, H=8, W=10, E=2):
    a = dict(ref=torch.rand(H, W), pack=torch.rand(S, H, W, 3),
             k_ref=torch.tensor([20.0, 20.0, 5.0, 4.0]),
             k_src=torch.tensor([[20.0, 20.0, 5.0, 4.0]] * S),
             R=torch.eye(3).expand(S, 3, 3).contiguous(), t=torch.zeros(S, 3),
             src_valid=torch.ones(S, dtype=torch.bool), taps=pc.window_taps(2, 1, 3.0, "cpu"),
             depth=torch.full((H, W), 3.0),
             normal=torch.tensor([0.0, 0.0, -1.0]).expand(H, W, 3).contiguous(),
             cost=torch.full((H, W), 2.0), extra_d=torch.full((E, H, W), 4.0),
             extra_n=torch.tensor([0.0, 0.0, -1.0]).expand(E, H, W, 3).contiguous())
    return a


@pytest.mark.parametrize("bad", ["extra_d_shape", "extra_n_shape", "extra_dtype",
                                 "extra_device", "too_many", "geom_shape", "geom_dtype",
                                 "weights_shape", "means_shape", "state_shape"])
def test_sweep_wrapper_checks_its_inputs(bad):
    a = _sweep_args()
    H, W = a["depth"].shape
    if bad == "extra_d_shape":
        a["extra_d"] = a["extra_d"][:1]
    elif bad == "extra_n_shape":
        a["extra_n"] = a["extra_n"][..., :2]
    elif bad == "extra_dtype":
        a["extra_d"] = a["extra_d"].double()
    elif bad == "extra_device":
        a["extra_d"] = torch.empty(a["extra_d"].shape, device="meta")
    elif bad == "too_many":
        a = _sweep_args(E=pc.C_MAX - len(pc.SHIFTS) + 1)
    elif bad == "geom_shape":
        a["geom"] = torch.zeros(2, H, W)                 # (S, H, W): one candidate's
    elif bad == "geom_dtype":
        a["geom"] = torch.zeros((10, 2, H, W), dtype=torch.float64)
    elif bad == "weights_shape":
        a["weights"] = torch.zeros(9, H, W)
    elif bad == "means_shape":
        a["means"] = torch.zeros(9, H, W)
    else:
        a["cost"] = torch.zeros(H, W + 1)
    with pytest.raises(ValueError):
        pc.plane_cost_sweep(**a)


def test_sweep_on_cpu_counts_no_launch():
    kernels.reset_launch_counts()
    a = _sweep_args()
    means = torch.empty(10, 8, 10)
    pc.plane_cost_sweep(**a, means=means)
    # the uniform state's own neighbours tie (never strictly better), then
    # the extra planes at depth 4 win wherever their cost is lower
    assert torch.equal(a["cost"], torch.minimum(means.min(0).values, torch.full((8, 10), 2.0)))
    assert kernels.launch_counts()["plane_cost"] == 0
