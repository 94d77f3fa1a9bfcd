"""The H100's peaks, frozen from the port's ``utils/flops.py``
``H100_PEAKS`` (NVIDIA's data sheet, dense rates at the full 700 W power
limit), keyed by the names ``torch.cuda.get_device_name`` returns.

A roofline share is the least time the card could take for a kernel's
calls, over their device time. The least time of one call is the larger
of its operations over the peak for their type and its bytes (each input
read once, each output written once) over the memory bandwidth.
"""

from __future__ import annotations

# name -> (bf16 dense tensor-core FLOP/s, f32 FLOP/s without the tensor
# cores, HBM bytes/s); the PCIe and NVL parts clock lower than the SXM part
H100_PEAKS = {
    "H100 80GB HBM3": (989e12, 67e12, 3.35e12),   # SXM5
    "H100 SXM": (989e12, 67e12, 3.35e12),
    "H100 NVL": (835e12, 60e12, 3.9e12),
    "H100 PCIe": (756e12, 51e12, 2.0e12),
}
SXM = H100_PEAKS["H100 80GB HBM3"]


def peaks(device_name: str):
    """(bf16 FLOP/s, f32 FLOP/s, bytes/s) of the card, or None for a card
    the table does not know."""
    for key, p in H100_PEAKS.items():
        if key.lower() in str(device_name).lower():
            return p
    return None


def least_seconds(flops: float, nbytes: float, kind: str, card=SXM) -> float:
    """The least time of one call: operations of ``kind`` ("bf16" or
    "f32") over their peak, or bytes over the bandwidth, the larger."""
    peak = card[0] if kind == "bf16" else card[1]
    return max(flops / peak, nbytes / card[2])
