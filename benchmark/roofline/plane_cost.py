"""Kernel 4 (``kernels/plane_cost.py``: PatchMatch's bilateral-NCC plane
cost, f32), frozen from ``chip_smoke.py``'s ``k4_bound``.

Operations: per in-image tap of the window, OPS_PER_TAP for its weight
(once: it depends on the reference image alone), and OPS_PER_TAP_SOURCE
per (tap, candidate, source); plus OPS_PER_PIXEL_SOURCE per (pixel,
candidate, source) for the center warp and the NCC finish. Bytes: the
inputs read once (reference, the sources' [value, gx, gy] pack, the given
candidate fields, the state or the candidate field) and the outputs
written once.

A sweep (``plane_cost_sweep``) evaluates SWEEP_CANDIDATES candidates: the
state rolled by each of eight shifts, then SWEEP_EXTRA given fields, and
reads and writes the state (depth, normal, cost: 20 bytes a pixel). The
initial pass (``plane_cost``) evaluates one given field and writes its
cost.
"""

KIND = "f32"
DEVICE_KERNELS = ("plane_cost", "plane_weight")
SWEEP_CANDIDATES = 10
SWEEP_EXTRA = 2
OPS_PER_TAP = 9
OPS_PER_TAP_SOURCE = 50
OPS_PER_PIXEL_SOURCE = 50


def window_offsets(radius: int, step: int = 1):
    """The window's (du, dv) taps, as the kernel's ``window_taps`` lays
    them out."""
    r = range(-radius, radius + 1, step)
    return [(du, dv) for dv in r for du in r]


def in_image_taps(H: int, W: int, offsets) -> int:
    return sum((W - abs(du)) * (H - abs(dv)) for du, dv in offsets)


def _ops(H, W, S, offsets, C):
    return (in_image_taps(H, W, offsets) * (OPS_PER_TAP + C * S * OPS_PER_TAP_SOURCE)
            + C * H * W * S * OPS_PER_PIXEL_SOURCE)


def sweep_work(H: int, W: int, S: int, offsets, Hs: int, Ws: int, geom: bool = False):
    """(operations, bytes) of one sweep call on an (H, W) reference with S
    (Hs, Ws) sources."""
    C = SWEEP_CANDIDATES
    nbytes = (H * W * 4 + S * Hs * Ws * 12 + SWEEP_EXTRA * H * W * 16 + 2 * H * W * 20
              + S * 64 + (C * S * H * W * 4 if geom else 0))
    return _ops(H, W, S, offsets, C), nbytes


def initial_work(H: int, W: int, S: int, offsets, Hs: int, Ws: int, geom: bool = False):
    """(operations, bytes) of one initial-pass call: one given field."""
    nbytes = (H * W * 4 + S * Hs * Ws * 12 + H * W * 16 + H * W * 4 + S * 64
              + (S * H * W * 4 if geom else 0))
    return _ops(H, W, S, offsets, 1), nbytes
