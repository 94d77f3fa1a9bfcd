"""Kernel 4: PatchMatch's bilateral-NCC plane cost of a Jacobi sweep, with
the sweep's update (``csrc/plane_cost.cu``).

It replaces no Pallas kernel: on the TPU the JAX package leaves this cost to
XLA's fusion (``scanner_colmap_tpu/ops/patch_match.py::_plane_costs_field``).
Eagerly, that function is about 70 tensor operations per window offset,
121 offsets a candidate at the default radius 5, and ten candidates a
sweep; the kernel does a sweep in one wrapper call.

For each candidate (depth, normal) field, for every ref pixel p and every
source s, the cost:
- warps p through its own candidate plane into s (the center warp), and
  takes the nearest sample of the source's packed [value, gx, gy] with a
  first-order correction to the exact coordinates;
- accumulates the six bilateral-NCC moments over the window taps, each tap
  reconstructed from the neighbour's center warp plus the gradient times
  the offset between the neighbour's warp and p's own plane's warp of the
  tap (taps whose correction exceeds the 2 px trust radius are dropped);
- finishes as ``_ncc_finish``: NCC -> 1 - clip(NCC), plus the optional
  geometric term, the support and source-valid masks, and the mean of the
  best max(1, S // 2) sources.

The update keeps, per pixel, each candidate in order where its cost is
strictly lower than the running cost (the JAX scan's order, so ties resolve
as there).

Entries: ``plane_cost_sweep`` (one sweep in place: the state shifted by
``SHIFTS``, read in place, then the given extra fields), ``plane_cost``
(the initial pass: returns the cost of one field) and ``plane_cost_update``
(one given candidate in place). On CUDA tensors they launch the CUDA
kernels; only for CPU tensors do they take the plain PyTorch versions
(``plane_cost_sweep_plain``, ``plane_cost_plain``). The kernel reads each
tap's weight from the table of ``tap_weights``: a caller that makes many
calls on one ref image builds it once and passes it, else the wrapper
builds it. Each call adds one to ``plane_cost.launches``; on the card it
makes two device launches (the cost pass over (candidate x source, pixel
tile), then the finish), and a third where it builds the table. The plain
versions spell out every product and sum in the kernel's order, so on the
card the two routes agree to the last bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from scanner_colmap_tpu_torch.kernels import _build

S_MAX = 16          # sources per launch
R_MAX = 16          # window radius (the halo lives in shared memory)
C_MAX = 16          # candidates per launch
TRUST_PX = 2.0      # beyond this the first-order correction extrapolates
SUPPORT_FRAC = 0.1  # a source needs window weight > 0.1 * taps
# a sweep's neighbour candidates, in this order: the state rolled by (dy, dx)
# over (rows, columns), i.e. the planes of the neighbours at distance 1 and 3
SHIFTS = ((0, 1), (0, -1), (1, 0), (-1, 0), (0, 3), (0, -3), (3, 0), (-3, 0))


class Taps(NamedTuple):
    """The window: tap offsets in scan order (dv outer, du inner, as
    ``np.meshgrid`` ravels them) and their spatial weights. The offsets are
    the grid ``-radius + step * j`` in both directions."""
    du: torch.Tensor        # (nw,) int32
    dv: torch.Tensor        # (nw,) int32
    wsp: torch.Tensor       # (nw,) f32 exp(-(du^2 + dv^2) / (2 sigma^2))
    offsets: tuple          # ((du, dv), ...) on the host
    radius: int
    step: int


def window_taps(radius: int, step: int, sigma_spatial: float, device) -> Taps:
    r = np.arange(-radius, radius + 1, step)
    du, dv = np.meshgrid(r, r)
    du, dv = du.ravel(), dv.ravel()
    duf = torch.as_tensor(du.astype(np.float32), device=device)
    dvf = torch.as_tensor(dv.astype(np.float32), device=device)
    wsp = torch.exp(-(duf * duf + dvf * dvf) / (2.0 * sigma_spatial ** 2))
    return Taps(torch.as_tensor(du.astype(np.int32), device=device),
                torch.as_tensor(dv.astype(np.int32), device=device), wsp,
                tuple(zip(du.tolist(), dv.tolist())), int(radius), int(step))


def build_pack(src_images: torch.Tensor) -> torch.Tensor:
    """(S, Hs, Ws) sources -> (S, Hs, Ws, 3) [value, gx, gy], central
    differences with wraparound, built once per problem."""
    gx = 0.5 * (torch.roll(src_images, -1, 2) - torch.roll(src_images, 1, 2))
    gy = 0.5 * (torch.roll(src_images, -1, 1) - torch.roll(src_images, 1, 1))
    return torch.stack([src_images, gx, gy], dim=-1).contiguous()


def color_denominator(sigma_color: float) -> float:
    """2 sigma_color^2 as the f32 value both routes divide by."""
    return float(np.float32(2.0 * sigma_color ** 2))


def _divisor(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor on ``like``'s device: dividing by it is an IEEE
    division (PyTorch divides a CUDA tensor by a Python number as a
    multiplication by its reciprocal)."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def pixel_planes(k_ref: torch.Tensor, depth: torch.Tensor, normal: torch.Tensor):
    """Per-pixel rays and plane terms of a candidate field. k_ref is
    (fx, fy, cx, cy). Returns xx, yy, xn, yn, (no0, no1, no2) = n / (n.X),
    and ndq = (n / (n.X)) . [xn, yn, 1]."""
    H, W = depth.shape
    dtype, dev = depth.dtype, depth.device
    yy = torch.arange(H, dtype=dtype, device=dev)[:, None].expand(H, W)
    xx = torch.arange(W, dtype=dtype, device=dev)[None, :].expand(H, W)
    fx, fy, cx, cy = k_ref[0], k_ref[1], k_ref[2], k_ref[3]
    xn = (xx - cx) / fx
    yn = (yy - cy) / fy
    n0, n1, n2 = normal[..., 0], normal[..., 1], normal[..., 2]
    ndotX = (n0 * (xn * depth) + n1 * (yn * depth)) + n2 * depth
    ndotX = torch.where(ndotX.abs() < 1e-9, 1e-9, ndotX)
    no = (n0 / ndotX, n1 / ndotX, n2 / ndotX)
    ndq = (no[0] * xn + no[1] * yn) + no[2]
    return xx, yy, xn, yn, no, ndq


def center_warp(R: torch.Tensor, t: torch.Tensor, k_src: torch.Tensor,
                xn, yn, ndq):
    """h = R [xn, yn, 1] + t ndq per source (S, H, W), and its projection:
    (h0, h1, h2, hz, px, py), hz = h2 kept at least 1e-9 in magnitude."""
    def col(a, *idx):
        return a[(slice(None),) + idx][:, None, None]

    h = [((col(R, i, 0) * xn + col(R, i, 1) * yn) + col(R, i, 2)) + col(t, i) * ndq
         for i in range(3)]
    hz = torch.where(h[2].abs() < 1e-9, 1e-9, h[2])
    px = col(k_src, 0) * (h[0] / hz) + col(k_src, 2)
    py = col(k_src, 1) * (h[1] / hz) + col(k_src, 3)
    return h[0], h[1], h[2], hz, px, py


def sample_pack(pack: torch.Tensor, px: torch.Tensor, py: torch.Tensor, hz):
    """Nearest [value, gx, gy] at (px, py) with the first-order correction.
    Returns (warped, gx, gy, ok) per (S, H, W); ok is 0/1 f32."""
    S, Hs, Ws, _ = pack.shape
    xr = torch.round(px).clamp(0, Ws - 1)
    yr = torch.round(py).clamp(0, Hs - 1)
    inb = (px >= 0.0) & (px <= Ws - 1.0) & (py >= 0.0) & (py <= Hs - 1.0)
    sidx = torch.arange(S, device=pack.device)[:, None, None]
    flat = (sidx * Hs + yr.long()) * Ws + xr.long()
    smp = pack.reshape(-1, 3)[flat]
    gxw, gyw = smp[..., 1], smp[..., 2]
    warped = (smp[..., 0] + gxw * (px - xr)) + gyw * (py - yr)
    return warped, gxw, gyw, (inb & (hz > 1e-9)).to(px.dtype)


def ncc_finish(sums, nw: int, geom: Optional[torch.Tensor], src_valid: torch.Tensor,
               bad: float) -> torch.Tensor:
    """Moments (S, H, W) each -> NCC cost -> geometric term -> support and
    source masks -> mean of the best max(1, S // 2) sources, summed in
    ascending order. ``bad`` is the cost of a masked source."""
    sum_w, sum_r, sum_s, sum_rr, sum_ss, sum_rs = sums
    S = sum_w.shape[0]
    wsafe = torch.clamp(sum_w, min=1e-6)
    mr = sum_r / wsafe
    ms = sum_s / wsafe
    var_r = sum_rr / wsafe - mr * mr
    var_s = sum_ss / wsafe - ms * ms
    cov = sum_rs / wsafe - mr * ms
    ncc = cov / torch.sqrt(torch.clamp(var_r * var_s, min=1e-12))
    cost = 1.0 - torch.clamp(ncc, -1.0, 1.0)
    if geom is not None:
        cost = cost + geom
    cost = torch.where(sum_w > float(np.float32(SUPPORT_FRAC * nw)), cost, bad)
    cost = torch.where(src_valid[:, None, None], cost, bad)
    k = max(1, S // 2)
    best = torch.topk(cost, k, dim=0, largest=False, sorted=True).values
    acc = best[0]
    for j in range(1, k):
        acc = acc + best[j]
    return acc / _divisor(float(k), acc)


def tap_weights_plain(ref, taps: Taps, sigma_color: float = 0.2) -> torch.Tensor:
    """The tap weights (nw, H, W) of a ref image: wsp * exp(-dr^2 / (2
    sigma_color^2)) at each in-image tap, 0 where p + o leaves the canvas."""
    H, W = ref.shape
    two_sc2 = _divisor(color_denominator(sigma_color), ref)
    yy = torch.arange(H, device=ref.device)[:, None]
    xx = torch.arange(W, device=ref.device)[None, :]
    out = []
    for k, (du, dv) in enumerate(taps.offsets):
        d = torch.roll(ref, (-dv, -du), (0, 1)) - ref
        inb = ((xx + du >= 0) & (xx + du <= W - 1) & (yy + dv >= 0)
               & (yy + dv <= H - 1)).to(ref.dtype)
        out.append(taps.wsp[k] * torch.exp(-(d * d) / two_sc2) * inb)
    return torch.stack(out)


def plane_cost_plain(ref, pack, k_ref, k_src, R, t, src_valid, taps: Taps,
                     cand_depth, cand_normal, geom=None, sigma_color: float = 0.2,
                     bad: float = 2.0, weights=None) -> torch.Tensor:
    """The field cost (H, W) of one candidate, as tensor operations: the
    warped fields are rolled over the window, one offset at a time
    (wrapped taps get weight 0 from the canvas bounds test). ``weights``
    (nw, H, W) from ``tap_weights`` replaces the per-tap weights, which it
    holds to the bit."""
    H, W = ref.shape
    xx, yy, xn, yn, no, ndq = pixel_planes(k_ref, cand_depth, cand_normal)
    h0, h1, h2, hz, px, py = center_warp(R, t, k_src, xn, yn, ndq)
    warped, gxw, gyw, src_ok = sample_pack(pack, px, py, hz)
    two_sc2 = _divisor(color_denominator(sigma_color), ref)
    dun_all = taps.du.to(ref.dtype) / k_ref[0]
    dvn_all = taps.dv.to(ref.dtype) / k_ref[1]

    def col(a, *idx):
        return a[(slice(None),) + idx][:, None, None]

    zero = torch.zeros((R.shape[0], H, W), dtype=ref.dtype, device=ref.device)
    sum_w, sum_r, sum_s, sum_rr, sum_ss, sum_rs = (zero,) * 6
    for k, (du, dv) in enumerate(taps.offsets):
        # the value at p + o is a roll by -o
        shift2 = (-dv, -du)
        r = torch.roll(ref, shift2, (0, 1))
        if weights is None:
            xb = xx + du
            yb = yy + dv
            inb_ref = ((xb >= 0) & (xb <= W - 1) & (yb >= 0) & (yb <= H - 1)).to(ref.dtype)
            d = r - ref
            w = taps.wsp[k] * torch.exp(-(d * d) / two_sc2) * inb_ref
        else:
            w = weights[k]
        dun, dvn = dun_all[k], dvn_all[k]
        nn = no[0] * dun + no[1] * dvn
        ho = [((h + dun * col(R, i, 0)) + dvn * col(R, i, 1)) + col(t, i) * nn
              for i, h in enumerate((h0, h1, h2))]
        hzo = torch.where(ho[2].abs() < 1e-9, 1e-9, ho[2])
        dx = (col(k_src, 0) * (ho[0] / hzo) + col(k_src, 2)) - torch.roll(px, shift2, (1, 2))
        dy = (col(k_src, 1) * (ho[1] / hzo) + col(k_src, 3)) - torch.roll(py, shift2, (1, 2))
        s = ((torch.roll(warped, shift2, (1, 2)) + torch.roll(gxw, shift2, (1, 2)) * dx)
             + torch.roll(gyw, shift2, (1, 2)) * dy)
        ok = (torch.roll(src_ok, shift2, (1, 2)) * (dx.abs() < TRUST_PX)
              * (dy.abs() < TRUST_PX) * (hzo > 1e-9))
        ws = w * ok
        sum_w = sum_w + ws
        sum_r = sum_r + ws * r
        sum_s = sum_s + ws * s
        sum_rr = sum_rr + ws * (r * r)
        sum_ss = sum_ss + ws * (s * s)
        sum_rs = sum_rs + (ws * r) * s
    return ncc_finish((sum_w, sum_r, sum_s, sum_rr, sum_ss, sum_rs), len(taps.offsets),
                      geom, src_valid, bad)


def jacobi_step(c, cand_depth, cand_normal, depth, normal, cost) -> None:
    """Where ``c`` is strictly below ``cost``, the state takes the candidate."""
    better = c < cost
    depth.copy_(torch.where(better, cand_depth, depth))
    normal.copy_(torch.where(better[..., None], cand_normal, normal))
    cost.copy_(torch.where(better, c, cost))


def plane_cost_sweep_plain(ref, pack, k_ref, k_src, R, t, src_valid, taps: Taps, depth,
                           normal, cost, extra_d, extra_n, geom=None,
                           sigma_color: float = 0.2, bad: float = 2.0, weights=None,
                           means=None) -> None:
    """``plane_cost_sweep`` as tensor operations: the shifted candidates are
    materialised from the sweep-start state, then each candidate's cost is
    ``plane_cost_plain`` and the state takes it where it is strictly
    better, in order."""
    cands = [(torch.roll(depth, s, (0, 1)), torch.roll(normal, s, (0, 1))) for s in SHIFTS]
    cands += list(zip(extra_d, extra_n))
    for c, (cd, cn) in enumerate(cands):
        m = plane_cost_plain(ref, pack, k_ref, k_src, R, t, src_valid, taps, cd, cn,
                             None if geom is None else geom[c], sigma_color, bad, weights)
        if means is not None:
            means[c] = m
        jacobi_step(m, cd, cn, depth, normal, cost)


def _check(ref, pack, k_ref, k_src, R, t, src_valid, taps, fields, n_shift=0):
    """Validate one call. ``fields`` lists (name, tensor or None, shape) of
    the call's own tensors, each shape a string over H, W, S, nw, E (the
    first dimension of extra_d) and C (the candidates: n_shift + E)."""
    for name, a in (("ref", ref), ("pack", pack), ("taps.wsp", taps.wsp)):
        if a.dtype != torch.float32:
            raise ValueError(f"{name} must be f32, got {a.dtype}")
    if ref.dim() != 2:
        raise ValueError(f"ref must be (H, W), got {tuple(ref.shape)}")
    if pack.dim() != 4 or pack.shape[3] != 3:
        raise ValueError(f"pack must be (S, Hs, Ws, 3), got {tuple(pack.shape)}")
    if not 1 <= pack.shape[0] <= S_MAX:
        raise ValueError(f"1 to {S_MAX} sources per launch, got {pack.shape[0]}")
    if not 0 <= taps.radius <= R_MAX:
        raise ValueError(f"window radius at most {R_MAX}, got {taps.radius}")
    extra = {name: a for name, a, _ in fields}.get("extra_d")
    E = extra.shape[0] if extra is not None and extra.dim() else 1
    sizes = dict(zip("HW", ref.shape), S=pack.shape[0], nw=len(taps.offsets), E=E,
                 C=n_shift + E)
    if not 1 <= sizes["C"] <= C_MAX:
        raise ValueError(f"1 to {C_MAX} candidates per launch, got {sizes['C']}")
    fields = [("k_ref", k_ref, "4"), ("k_src", k_src, "S 4"), ("R", R, "S 3 3"),
              ("t", t, "S 3"), ("src_valid", src_valid, "S")] + list(fields)
    for name, a, spec in fields:
        if a is None:
            continue
        shape = tuple(sizes[d] if d in sizes else int(d) for d in spec.split())
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(a.shape)}")
        want = torch.bool if name == "src_valid" else torch.float32
        if a.dtype != want:
            raise ValueError(f"{name} must be {want}, got {a.dtype}")
    tensors = [ref, pack, taps.du, taps.dv, taps.wsp] + [a for _, a, _ in fields
                                                          if a is not None]
    devs = {a.device for a in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    if ref.is_cuda:
        for a in tensors:
            if not a.is_contiguous():
                raise ValueError("every input must be contiguous")


def _ptr(a):
    return None if a is None else a.data_ptr()


def _launch(ref, pack, k_ref, k_src, R, t, src_valid, taps, extra_d, extra_n, geom,
            sigma_color, bad, weights, cost, state=None, n_shift=0, means=None):
    """Both launches of one call: the cost pass over (C x S, pixel tiles) into
    a (C, S, H, W) scratch, then the finish into ``cost`` (and, with
    ``state`` (depth, normal), the update in place). Without ``weights`` the
    tap-weight table is built first."""
    if weights is None:
        weights = tap_weights(ref, taps, sigma_color)
    H, W = ref.shape
    S, Hs, Ws, _ = pack.shape
    C = n_shift + extra_d.shape[0]
    costs = torch.empty((C, S, H, W), dtype=ref.dtype, device=ref.device)
    # the update overwrites the state the shifted candidates are read from
    snap = torch.empty((H, W, 4), dtype=ref.dtype, device=ref.device) if n_shift else None
    depth, normal = state if state is not None else (None, None)
    shifts = (ctypes.c_int * (2 * len(SHIFTS)))(*[v for s in SHIFTS[:n_shift] for v in s])
    nw = len(taps.offsets)
    _build.check(_lib().plane_cost_launch(
        ref.data_ptr(), pack.data_ptr(), k_ref.data_ptr(), k_src.data_ptr(), R.data_ptr(),
        t.data_ptr(), src_valid.data_ptr(), taps.du.data_ptr(), taps.dv.data_ptr(),
        weights.data_ptr(), _ptr(depth), _ptr(normal), extra_d.data_ptr(),
        extra_n.data_ptr(), _ptr(geom), costs.data_ptr(), _ptr(snap), cost.data_ptr(),
        _ptr(means), shifts, n_shift, C - n_shift, H, W, S, Hs, Ws, nw, taps.radius,
        taps.step, float(np.float32(SUPPORT_FRAC * nw)), float(bad), int(state is not None),
        torch.cuda.current_stream(ref.device).cuda_stream), "plane_cost")
    plane_cost.launches += 1


def tap_weights(ref, taps: Taps, sigma_color: float = 0.2) -> torch.Tensor:
    """The tap weights (nw, H, W) of a ref image (``tap_weights_plain`` on
    the CPU), which the kernel reads instead of computing each tap's weight
    once per candidate and source. One launch."""
    if ref.dim() != 2 or ref.dtype != torch.float32:
        raise ValueError(f"ref must be (H, W) f32, got {tuple(ref.shape)} {ref.dtype}")
    if len({a.device for a in (ref, taps.du, taps.dv, taps.wsp)}) != 1:
        raise ValueError("ref and taps on several devices")
    if not ref.is_cuda:
        return tap_weights_plain(ref, taps, sigma_color)
    if not ref.is_contiguous():
        raise ValueError("every input must be contiguous")
    H, W = ref.shape
    out = torch.empty((len(taps.offsets), H, W), dtype=ref.dtype, device=ref.device)
    _build.check(_lib().plane_weight_launch(
        ref.data_ptr(), taps.du.data_ptr(), taps.dv.data_ptr(), taps.wsp.data_ptr(),
        out.data_ptr(), H, W, len(taps.offsets), color_denominator(sigma_color),
        torch.cuda.current_stream(ref.device).cuda_stream), "plane_weight")
    return out


def plane_cost_sweep(ref, pack, k_ref, k_src, R, t, src_valid, taps: Taps, depth, normal,
                     cost, extra_d, extra_n, geom=None, sigma_color: float = 0.2,
                     bad: float = 2.0, weights=None, means=None) -> None:
    """One Jacobi sweep in place. The candidates, in order: the state at the
    sweep's start rolled by each of ``SHIFTS`` (``torch.roll(depth, shift,
    (0, 1))``, read in place), then extra_d (E, H, W) with extra_n (E, H, W,
    3). (depth (H, W), normal (H, W, 3), cost (H, W)) take each candidate
    where its cost is strictly below the running cost. geom (C, S, H, W),
    C = 8 + E, is the optional geometric term; weights (nw, H, W) from
    ``tap_weights`` (built here when not given); means, an optional (C, H,
    W) output, receives each candidate's cost. The other arguments as
    ``plane_cost``; the extras must not alias the state. On the card the
    canvas spans at most 65535 pixel tiles each way."""
    _check(ref, pack, k_ref, k_src, R, t, src_valid, taps, (
        ("depth", depth, "H W"), ("normal", normal, "H W 3"), ("cost", cost, "H W"),
        ("extra_d", extra_d, "E H W"), ("extra_n", extra_n, "E H W 3"),
        ("geom", geom, "C S H W"), ("weights", weights, "nw H W"),
        ("means", means, "C H W")), n_shift=len(SHIFTS))
    if not ref.is_cuda:
        plane_cost_sweep_plain(ref, pack, k_ref, k_src, R, t, src_valid, taps, depth, normal,
                               cost, extra_d, extra_n, geom, sigma_color, bad, weights, means)
        return
    _launch(ref, pack, k_ref, k_src, R, t, src_valid, taps, extra_d, extra_n, geom,
            sigma_color, bad, weights, cost, (depth, normal), len(SHIFTS), means)


def _one_field(cand_depth, cand_normal, geom):
    """A given candidate (and its geometric term) as a sweep of one."""
    return (cand_depth[None], cand_normal[None], None if geom is None else geom[None])


def plane_cost(ref, pack, k_ref, k_src, R, t, src_valid, taps: Taps, cand_depth,
               cand_normal, geom=None, sigma_color: float = 0.2,
               bad: float = 2.0, weights=None) -> torch.Tensor:
    """The cost (H, W) of one candidate field (the initial pass).

    ref (H, W); pack (S, Hs, Ws, 3) from ``build_pack``; k_ref (4,) and
    k_src (S, 4) as (fx, fy, cx, cy); R (S, 3, 3) and t (S, 3) ref camera
    -> source camera; src_valid (S,) bool; cand_depth (H, W); cand_normal
    (H, W, 3); geom (S, H, W) the optional geometric term; weights (nw, H,
    W) the table from ``tap_weights`` (built here when not given); all f32
    on one device. ``bad`` is a masked source's cost."""
    _check(ref, pack, k_ref, k_src, R, t, src_valid, taps, (
        ("cand_depth", cand_depth, "H W"), ("cand_normal", cand_normal, "H W 3"),
        ("geom", geom, "S H W"), ("weights", weights, "nw H W")))
    if not ref.is_cuda:
        return plane_cost_plain(ref, pack, k_ref, k_src, R, t, src_valid, taps,
                                cand_depth, cand_normal, geom, sigma_color, bad, weights)
    cost = torch.empty_like(ref)
    _launch(ref, pack, k_ref, k_src, R, t, src_valid, taps,
            *_one_field(cand_depth, cand_normal, geom), sigma_color, bad, weights, cost)
    return cost


def plane_cost_update(ref, pack, k_ref, k_src, R, t, src_valid, taps: Taps, cand_depth,
                      cand_normal, depth, normal, cost, geom=None,
                      sigma_color: float = 0.2, bad: float = 2.0) -> None:
    """One Jacobi step in place: where the candidate's cost is strictly
    below ``cost``, (depth, normal, cost) take the candidate's values. The
    candidate must not alias the state. Arguments as ``plane_cost``."""
    _check(ref, pack, k_ref, k_src, R, t, src_valid, taps, (
        ("cand_depth", cand_depth, "H W"), ("cand_normal", cand_normal, "H W 3"),
        ("depth", depth, "H W"), ("normal", normal, "H W 3"), ("cost", cost, "H W"),
        ("geom", geom, "S H W")))
    if not ref.is_cuda:
        c = plane_cost_plain(ref, pack, k_ref, k_src, R, t, src_valid, taps,
                             cand_depth, cand_normal, geom, sigma_color, bad)
        jacobi_step(c, cand_depth, cand_normal, depth, normal, cost)
        return
    _launch(ref, pack, k_ref, k_src, R, t, src_valid, taps,
            *_one_field(cand_depth, cand_normal, geom), sigma_color, bad, None, cost,
            (depth, normal))


plane_cost.launches = 0


def occupancy(taps: Taps):
    """(cost-pass blocks resident on one SM at this window, the (width,
    height) pixel tile the kernel was built with)."""
    blocks, tile = ctypes.c_int(0), (ctypes.c_int * 2)()
    _build.check(_lib().plane_cost_occupancy(taps.radius, len(taps.offsets),
                                             ctypes.byref(blocks), tile), "plane_cost occupancy")
    return blocks.value, tuple(tile)


def _lib():
    lib = _build.load_library("plane_cost")
    for fn, argtypes in (
            (lib.plane_cost_launch, [ctypes.c_void_p] * 20 + [ctypes.c_int] * 10
             + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]),
            (lib.plane_weight_launch, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
             + [ctypes.c_float, ctypes.c_void_p]),
            (lib.plane_cost_occupancy, [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)):
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib
