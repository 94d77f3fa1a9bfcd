"""Kernel 2 (``kernels/schur.py``: S = sum_p B_p Vinv_p B_p^T of the
reduced camera system, f32), frozen from ``chip_smoke.py``'s kernel-2
measure.

Per point with L live observation slots: Wc[t] Vinv (8x3x3) for each, then
(Wc Vinv)[t1] Wc[t2]^T (8x3x8) for each pair, 2 x (72 L + 192 L^2)
operations. A slot is live where its Wc block is not all zero: the count
is of the live observations, not of the padded capacity. Bytes likewise:
the camera index and the Wc block of each live slot and the Vinv of each
point with a live slot read once, S written once. Where every slot is live
this is the padded inputs' size.
"""

KIND = "f32"
DEVICE_KERNELS = ("schur_kernel",)


def live_ops(live_sum: float, live_sq_sum: float) -> float:
    """Operations of points whose live slots L sum to ``live_sum`` and
    whose L^2 sum to ``live_sq_sum``."""
    return 2.0 * (72.0 * live_sum + 192.0 * live_sq_sum)


def live_bytes(live_sum: float, live_points: float, s_elements: int) -> float:
    """Bytes of a call whose live slots sum to ``live_sum``, over
    ``live_points`` points with a live slot, into an S of ``s_elements``
    f32 entries: per live slot its int32 camera index and 8x3 f32 Wc block,
    per live point its 3x3 f32 Vinv."""
    return 4.0 * (live_sum * (1 + 8 * 3) + live_points * 3 * 3 + s_elements)


def work(live_sum: float, live_sq_sum: float, live_points: float, s_elements: int):
    """(operations, bytes) of one call."""
    return live_ops(live_sum, live_sq_sum), live_bytes(live_sum, live_points, s_elements)
