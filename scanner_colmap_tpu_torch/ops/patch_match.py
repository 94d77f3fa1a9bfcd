"""PatchMatch multi-view stereo (port of ``ops/patch_match.py``).

Per reference image, with a window of source views: a random (depth,
normal) field, then Jacobi sweeps. Each sweep proposes for every pixel, in
a fixed order, its 4 + 4 neighbours' planes at distances 1 and 3, a
perturbation and a fresh random sample; a candidate is kept where its cost
is strictly lower. The cost is a bilateral-weighted NCC over a window,
per source, aggregated as the mean of the best half of the sources
(occlusion robustness).

Two samplings of the cost:
- ``"field"`` (the default): each source is sampled once per pixel through
  the pixel's own candidate plane, and every window tap is reconstructed
  from the neighbour's sample with a first-order correction to p's own
  plane. On a CUDA tensor this is kernel 4 (``kernels/plane_cost.py``):
  one call a sweep evaluates all ten candidates and applies the Jacobi
  update.
- ``"exact"``: every window tap is warped through the center pixel's plane
  and sampled bilinearly (COLMAP's slanted window), as tensor operations on
  both devices.

Random numbers come from a ``torch.Generator`` through a ``Draws`` source,
which a caller may replace (the parity tests inject the JAX package's
``jax.random`` draws).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from scanner_colmap_tpu_torch.kernels import plane_cost as pc

_ncc_finish = pc.ncc_finish

# Jacobi propagation: neighbours at distance 1 and 3, in this order
SHIFTS = pc.SHIFTS


class PatchMatchProblem(NamedTuple):
    ref_image: torch.Tensor   # (H, W) grayscale float
    src_images: torch.Tensor  # (S, Hs, Ws)
    K_ref: torch.Tensor       # (3, 3)
    K_src: torch.Tensor       # (S, 3, 3)
    R: torch.Tensor           # (S, 3, 3) ref camera -> source camera rotation
    t: torch.Tensor           # (S, 3)
    depth_min: float
    depth_max: float
    src_valid: torch.Tensor   # (S,) bool: padded source slots are False


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Bilinear samples of img (H, W), or of each of (S, H, W) at its own
    (S, ...) coordinates, with the in-bounds mask."""
    H, W = img.shape[-2:]
    inb = (x >= 0) & (x <= W - 1.001) & (y >= 0) & (y <= H - 1.001)
    xc = x.clamp(0.0, W - 1.001)
    yc = y.clamp(0.0, H - 1.001)
    x0 = torch.floor(xc).long()
    y0 = torch.floor(yc).long()
    fx = xc - x0
    fy = yc - y0
    if img.dim() == 3:
        base = (torch.arange(img.shape[0], device=img.device)
                .reshape((-1,) + (1,) * (x.dim() - 1)) * (H * W))
    else:
        base = 0
    flat = img.reshape(-1)

    def at(yi, xi):
        return flat[base + yi * W + xi]

    v = ((1 - fy) * ((1 - fx) * at(y0, x0) + fx * at(y0, x0 + 1))
         + fy * ((1 - fx) * at(y0 + 1, x0) + fx * at(y0 + 1, x0 + 1)))
    return v, inb


def _window_offsets(radius: int, step: int = 1):
    r = np.arange(-radius, radius + 1, step)
    du, dv = np.meshgrid(r, r)
    return du.ravel().astype(np.float32), dv.ravel().astype(np.float32)


def _intrinsics4(K: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) as (fx, fy, cx, cy)."""
    return torch.stack([K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]],
                       dim=-1).contiguous()


class _Prepared(NamedTuple):
    """What every cost call of one problem shares."""
    ref: torch.Tensor
    pack: torch.Tensor
    k_ref: torch.Tensor
    k_src: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    src_valid: torch.Tensor
    src_images: torch.Tensor


def _prepare(problem: PatchMatchProblem, sampling: str) -> _Prepared:
    dtype = problem.ref_image.dtype
    src = problem.src_images.to(dtype).contiguous()
    return _Prepared(
        problem.ref_image.contiguous(),
        pc.build_pack(src) if sampling == "field" else None,
        _intrinsics4(problem.K_ref.to(dtype)), _intrinsics4(problem.K_src.to(dtype)),
        problem.R.to(dtype).contiguous(), problem.t.to(dtype).contiguous(),
        problem.src_valid.to(torch.bool).contiguous(), src)


def _geom_cost(prep: _Prepared, xx, yy, px, py, hz, src_depths, geom_weight,
               max_geom_error):
    """COLMAP's geometric-consistency term per source (S, H, W): the
    forward-backward reprojection error through the source's depth map,
    from the center warp (px, py, hz)."""
    k_src, R, t = prep.k_src, prep.R, prep.t
    fx, fy, cx, cy = prep.k_ref[0], prep.k_ref[1], prep.k_ref[2], prep.k_ref[3]
    d_src, d_inb = _bilinear(src_depths.to(px.dtype), px, py)

    def col(a, *idx):
        return a[(slice(None),) + idx][:, None, None]

    sxn = (px - col(k_src, 2)) / col(k_src, 0)
    syn = (py - col(k_src, 3)) / col(k_src, 1)
    Xs2 = (sxn * d_src - col(t, 0), syn * d_src - col(t, 1), d_src - col(t, 2))
    Xr = [(col(R, 0, i) * Xs2[0] + col(R, 1, i) * Xs2[1]) + col(R, 2, i) * Xs2[2]
          for i in range(3)]
    zr = torch.where(Xr[2].abs() < 1e-9, 1e-9, Xr[2])
    bx = fx * (Xr[0] / zr) + cx
    by = fy * (Xr[1] / zr) + cy
    err = torch.hypot(bx - xx, by - yy)
    ok = d_inb & (d_src > 1e-6) & (hz > 1e-9) & (zr > 1e-9)
    return geom_weight * torch.where(ok, torch.clamp(err, max=max_geom_error),
                                     max_geom_error)


def _field_geom(prep: _Prepared, depth, normal, src_depths, geom_weight, max_geom_error):
    xx, yy, xn, yn, _, ndq = pc.pixel_planes(prep.k_ref, depth, normal)
    _, _, _, hz, px, py = pc.center_warp(prep.R, prep.t, prep.k_src, xn, yn, ndq)
    return _geom_cost(prep, xx, yy, px, py, hz, src_depths, geom_weight,
                      max_geom_error).contiguous()


def _plane_costs_exact(prep: _Prepared, depth, normal, taps: pc.Taps, sigma_color,
                       src_depths, geom_weight, max_geom_error):
    """COLMAP's slanted window: every tap warped through the center pixel's
    plane and sampled bilinearly in every source."""
    H, W = depth.shape
    ref = prep.ref
    k_src, R, t = prep.k_src, prep.R, prep.t
    fx, fy, cx, cy = prep.k_ref[0], prep.k_ref[1], prep.k_ref[2], prep.k_ref[3]
    xx, yy, xn, yn, no, _ = pc.pixel_planes(prep.k_ref, depth, normal)
    two_sc2 = pc._divisor(pc.color_denominator(sigma_color), ref)

    def col(a, *idx):
        return a[(slice(None),) + idx][:, None, None]

    zero = torch.zeros((R.shape[0], H, W), dtype=ref.dtype, device=ref.device)
    sums = [zero] * 6
    for k, (du, dv) in enumerate(taps.offsets):
        qx = xx + float(du)
        qy = yy + float(dv)
        ref_val, ref_inb = _bilinear(ref, qx, qy)
        d = ref_val - ref
        w = taps.wsp[k] * torch.exp(-(d * d) / two_sc2) * ref_inb
        qxn = (qx - cx) / fx
        qyn = (qy - cy) / fy
        ndq = (no[0] * qxn + no[1] * qyn) + no[2]
        h = [((col(R, i, 0) * qxn + col(R, i, 1) * qyn) + col(R, i, 2)) + col(t, i) * ndq
             for i in range(3)]
        hz = torch.where(h[2].abs() < 1e-9, 1e-9, h[2])
        px = col(k_src, 0) * (h[0] / hz) + col(k_src, 2)
        py = col(k_src, 1) * (h[1] / hz) + col(k_src, 3)
        src_val, src_inb = _bilinear(prep.src_images, px, py)
        ws = w * src_inb * ~(hz <= 1e-9)
        r = ref_val
        sums = [sums[0] + ws, sums[1] + ws * r, sums[2] + ws * src_val,
                sums[3] + ws * (r * r), sums[4] + ws * (src_val * src_val),
                sums[5] + (ws * r) * src_val]
    geom = None
    if src_depths is not None:
        X = (xn * depth, yn * depth, depth)
        Xs = [((col(R, i, 0) * X[0] + col(R, i, 1) * X[1]) + col(R, i, 2) * X[2]) + col(t, i)
              for i in range(3)]
        zs = torch.where(Xs[2].abs() < 1e-9, 1e-9, Xs[2])
        px = col(k_src, 0) * (Xs[0] / zs) + col(k_src, 2)
        py = col(k_src, 1) * (Xs[1] / zs) + col(k_src, 3)
        geom = _geom_cost(prep, xx, yy, px, py, zs, src_depths, geom_weight, max_geom_error)
    bad = 2.0 if geom is None else 2.0 + geom_weight * max_geom_error
    return _ncc_finish(sums, len(taps.offsets), geom, prep.src_valid, bad)


def _field_bad(src_depths, geom_weight, max_geom_error):
    """A masked source's cost: the photometric maximum, plus the geometric
    term's maximum in a geometric pass."""
    return 2.0 if src_depths is None else 2.0 + geom_weight * max_geom_error


def _cost_call(prep: _Prepared, taps, sampling, sigma_color, src_depths, geom_weight,
               max_geom_error, cand_d, cand_n, weights=None):
    """The cost (H, W) of one candidate field."""
    if sampling == "exact":
        return _plane_costs_exact(prep, cand_d, cand_n, taps, sigma_color, src_depths,
                                  geom_weight, max_geom_error)
    if sampling != "field":
        raise ValueError(f"unknown sampling {sampling!r}")
    geom = None
    if src_depths is not None:
        geom = _field_geom(prep, cand_d, cand_n, src_depths, geom_weight, max_geom_error)
    return pc.plane_cost(prep.ref, prep.pack, prep.k_ref, prep.k_src, prep.R, prep.t,
                         prep.src_valid, taps, cand_d, cand_n, geom=geom,
                         sigma_color=sigma_color,
                         bad=_field_bad(src_depths, geom_weight, max_geom_error),
                         weights=weights)


def _sweep(prep: _Prepared, taps, sampling, sigma_color, src_depths, geom_weight,
           max_geom_error, cand_d, cand_n, state, weights=None):
    """One Jacobi sweep on the state (depth, normal, cost) in place: the
    ``SHIFTS`` neighbours' planes, then the fields cand_d (E, H, W) with
    cand_n (E, H, W, 3), each kept where its cost is strictly lower. With
    ``"field"`` sampling this is one call of kernel 4; its geometric term,
    where there is one, stays eager tensor operations per candidate."""
    depth, normal, cost = state

    def materialised():
        return ([(torch.roll(depth, s, (0, 1)), torch.roll(normal, s, (0, 1)))
                 for s in SHIFTS] + list(zip(cand_d, cand_n)))

    if sampling == "exact":
        for cd, cn in materialised():
            c = _plane_costs_exact(prep, cd, cn, taps, sigma_color, src_depths,
                                   geom_weight, max_geom_error)
            pc.jacobi_step(c, cd, cn, depth, normal, cost)
        return
    geom = None
    if src_depths is not None:
        geom = torch.stack([_field_geom(prep, cd, cn, src_depths, geom_weight,
                                        max_geom_error) for cd, cn in materialised()])
    pc.plane_cost_sweep(prep.ref, prep.pack, prep.k_ref, prep.k_src, prep.R, prep.t,
                        prep.src_valid, taps, depth, normal, cost, cand_d, cand_n,
                        geom=geom, sigma_color=sigma_color,
                        bad=_field_bad(src_depths, geom_weight, max_geom_error),
                        weights=weights)


def plane_costs(problem: PatchMatchProblem, depth: torch.Tensor, normal: torch.Tensor,
                window_radius: int = 3, window_step: int = 1, sigma_spatial: float = 3.0,
                sigma_color: float = 0.2, src_depths: Optional[torch.Tensor] = None,
                geom_weight: float = 0.3, max_geom_error: float = 3.0,
                sampling: str = "field") -> torch.Tensor:
    """Bilateral-NCC matching cost (H, W) in [0, 2] of a (depth, normal)
    field (lower is better); with ``src_depths`` (S, H, W), each source's
    cost gains ``geom_weight * min(err_fb, max_geom_error)`` (COLMAP's
    geometric consistency)."""
    prep = _prepare(problem, sampling)
    taps = pc.window_taps(window_radius, window_step, sigma_spatial, depth.device)
    dtype = prep.ref.dtype
    return _cost_call(prep, taps, sampling, sigma_color, src_depths, geom_weight,
                      max_geom_error, depth.to(dtype).contiguous(),
                      normal.to(dtype).contiguous())


def _random_normals(gauss: torch.Tensor) -> torch.Tensor:
    """Unit normals with n_z < 0 (facing the camera) from (..., 3) normal
    draws."""
    v = gauss / torch.clamp(torch.linalg.vector_norm(gauss, dim=-1, keepdim=True), min=1e-9)
    return torch.cat([v[..., :2], -v[..., 2:].abs()], dim=-1)


class Draws:
    """PatchMatch's random numbers from a ``torch.Generator``: the initial
    depth (uniform in [depth_min, depth_max)) and normal draws, and per
    sweep the perturbation (uniform in [-0.5, 0.5) and normal draws) and
    the fresh sample (a depth and normal draws). A replacement source needs
    the same two methods."""

    def __init__(self, generator: torch.Generator, depth_min: float, depth_max: float):
        self.gen, self.dmin, self.dmax = generator, depth_min, depth_max

    def _depth(self, H, W, dtype, device):
        u = torch.rand((H, W), generator=self.gen, dtype=dtype, device=device)
        return u * (self.dmax - self.dmin) + self.dmin

    def initial(self, H, W, dtype, device):
        return (self._depth(H, W, dtype, device),
                torch.randn((H, W, 3), generator=self.gen, dtype=dtype, device=device))

    def sweep(self, H, W, dtype, device):
        u = torch.rand((H, W), generator=self.gen, dtype=dtype, device=device) - 0.5
        g = torch.randn((H, W, 3), generator=self.gen, dtype=dtype, device=device)
        d = self._depth(H, W, dtype, device)
        gr = torch.randn((H, W, 3), generator=self.gen, dtype=dtype, device=device)
        return u, g, d, gr


def pm_generator(device, *indices) -> torch.Generator:
    """A generator seeded from ``indices`` alone (the stage's pass, ref and
    band), so a depth map does not depend on which others run."""
    seed = 0
    for i in indices:
        seed = (seed * 1_000_003 + int(i) + 1) % (1 << 62)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def patch_match(problem: PatchMatchProblem, num_iterations: int = 5, window_radius: int = 3,
                window_step: int = 1, sigma_spatial: float = 3.0, sigma_color: float = 0.2,
                src_depths: Optional[torch.Tensor] = None, geom_weight: float = 0.3,
                max_geom_error: float = 3.0, init_depth: Optional[torch.Tensor] = None,
                init_normal: Optional[torch.Tensor] = None, sampling: str = "field",
                generator: Optional[torch.Generator] = None,
                draws: Optional[Draws] = None) -> tuple:
    """(depth (H, W), normal (H, W, 3), cost (H, W)) of the ref view.
    ``draws`` replaces the generator's draws (see ``Draws``); without
    either, a generator seeded with 0 on the ref image's device."""
    ref = problem.ref_image
    H, W = ref.shape
    dtype, dev = ref.dtype, ref.device
    dmin = float(np.float32(problem.depth_min))
    dmax = float(np.float32(problem.depth_max))
    if draws is None:
        draws = Draws(generator if generator is not None else pm_generator(dev),
                      dmin, dmax)
    prep = _prepare(problem, sampling)
    taps = pc.window_taps(window_radius, window_step, sigma_spatial, dev)
    if src_depths is not None:
        src_depths = src_depths.to(dtype).contiguous()

    weights = pc.tap_weights(prep.ref, taps, sigma_color) if sampling == "field" else None
    args = (prep, taps, sampling, sigma_color, src_depths, geom_weight, max_geom_error)

    if init_depth is None or init_normal is None:
        d0, g0 = draws.initial(H, W, dtype, dev)
    depth = (init_depth.to(dtype) if init_depth is not None else d0).contiguous().clone()
    normal = (init_normal.to(dtype) if init_normal is not None
              else _random_normals(g0)).contiguous().clone()
    cost = _cost_call(*args, depth, normal, weights)

    for it in range(num_iterations):
        u, g, rd, gr = draws.sweep(H, W, dtype, dev)
        scale = 0.5 ** (it + 1.0)
        pd = torch.clamp(depth * (1.0 + scale * u), dmin, dmax)
        pn = normal + scale * g
        pn = pn / torch.clamp(torch.linalg.vector_norm(pn, dim=-1, keepdim=True), min=1e-9)
        pn = torch.cat([pn[..., :2], -pn[..., 2:].abs()], dim=-1)
        _sweep(*args, torch.stack([pd, rd]), torch.stack([pn, _random_normals(gr)]),
               (depth, normal, cost), weights)
    return depth, normal, cost


def patch_match_tiled(problem: PatchMatchProblem, tile_rows: int, halo_rows: int = 48,
                      seed: tuple = (), src_depths: Optional[torch.Tensor] = None,
                      init_depth: Optional[torch.Tensor] = None,
                      init_normal: Optional[torch.Tensor] = None, **kwargs) -> tuple:
    """``patch_match`` over horizontal bands of the ref image with an
    overlap halo: the per-pixel working set scales with the band, while
    the source images (and source depth maps) stay whole.

    Each band solves rows [y0 - halo, y0 + tile + halo) (one band height
    for all bands; edge bands shift inward) and keeps its center rows; the
    band's K_ref shifts cy by the crop. Band b draws from
    ``pm_generator(device, *seed, b)``. Without tiling (``tile_rows <= 0``
    or an image no taller than one band) this is ``patch_match`` with
    ``generator=pm_generator(device, *seed)``."""
    ref = problem.ref_image
    H = ref.shape[0]
    dev = ref.device
    if tile_rows <= 0 or H <= tile_rows + 2 * halo_rows:
        return patch_match(problem, src_depths=src_depths, init_depth=init_depth,
                           init_normal=init_normal, generator=pm_generator(dev, *seed),
                           **kwargs)
    outs = []
    for b in range(-(-H // tile_rows)):
        y0 = b * tile_rows
        y1 = min(y0 + tile_rows, H)
        hb = min(tile_rows + 2 * halo_rows, H)
        ya = min(max(0, y0 - halo_rows), H - hb)
        yb = ya + hb
        K_band = problem.K_ref.clone()
        K_band[1, 2] -= ya
        prob_b = problem._replace(ref_image=ref[ya:yb], K_ref=K_band)
        d, n, c = patch_match(
            prob_b, src_depths=src_depths,
            init_depth=None if init_depth is None else init_depth[ya:yb],
            init_normal=None if init_normal is None else init_normal[ya:yb],
            generator=pm_generator(dev, *seed, b), **kwargs)
        outs.append((d[y0 - ya:y1 - ya], n[y0 - ya:y1 - ya], c[y0 - ya:y1 - ya]))
    return tuple(torch.cat([o[i] for o in outs], dim=0) for i in range(3))
