"""What the program records of itself, for the per-layer readers: its
spans and counters (``scanner_colmap_tpu_torch/utils/metrics``), by the
program's stage names (``mapping``, ``prepare_patch_match``, ...).

``run_all`` resets the program's ``GLOBAL_METRICS`` when it starts, and
turns its spans and counters on for a run that starts under a running
profiler, as the traced pass does; so once the traced pass is over they
hold that pass's. A span's seconds are host time, lengthened where the
profiler's own work lies in it. A program that records none of them
leaves the readers nothing: every function here then returns None.
"""

from __future__ import annotations

import numpy as np

from benchmark.harness.trace import _union


def _registry():
    try:
        from scanner_colmap_tpu_torch.utils import metrics
    except ImportError:
        return None
    return getattr(metrics, "GLOBAL_METRICS", None)


def _total(stage, keys):
    reg = _registry()
    if reg is None:
        return None
    data = reg.to_dict()
    stages = list(data) if stage is None else [stage]
    got = [data[s][k] for s in stages if s in data for k in keys if k in data[s]]
    return float(sum(got)) if got else None


def span_seconds(stage, *names):
    """Summed seconds of the named spans in the program's ``stage`` (every
    stage where None), or None where none of them ran."""
    return _total(stage, [f"span.{n}.s" for n in names])


def counter(stage, name):
    """The program's counter ``name`` in ``stage`` (every stage where None),
    or None where it never counted."""
    return _total(stage, [f"count.{name}"])


def span_intervals(stage, name):
    """(n, 2) seconds from the stage's opening of each ``name`` span of the
    program's ``stage``, or None where it has none."""
    timeline = getattr(_registry(), "timeline", None)
    if timeline is None:
        return None
    iv = timeline(stage).get(name)
    return np.asarray(iv, np.float64).reshape(-1, 2) if iv else None


def covered_s(busy: np.ndarray, spans: np.ndarray) -> float:
    """Seconds of the disjoint sorted intervals ``busy`` that lie inside the
    disjoint sorted intervals ``spans``."""
    total = 0.0
    for a, b in spans:
        lo = np.searchsorted(busy[:, 1], a, side="right")
        hi = np.searchsorted(busy[:, 0], b, side="left")
        seg = busy[lo:hi]
        total += float(np.clip(np.minimum(seg[:, 1], b) - np.maximum(seg[:, 0], a),
                               0.0, None).sum())
    return total


def idle_share_in(t, stage: str, program_stage: str, name: str):
    """The share of the union of the program's ``name`` spans, in the traced
    pass's ``stage`` (the harness's name; ``program_stage`` the program's),
    in which the device ran nothing, in percent; None where the trace or
    the program has nothing to read. The spans are placed on the trace's
    clock from the opening of the harness's span of the stage, which the
    program's own opening of it precedes by the harness wrapper's call."""
    iv = span_intervals(program_stage, name)
    if iv is None or stage not in t.stage_windows or not len(t.busy):
        return None
    spans = _union(iv + t.stage_windows[stage][0])
    length = float((spans[:, 1] - spans[:, 0]).sum())
    if length <= 0:
        return None
    return 100.0 * (1.0 - covered_s(t.busy, spans) / length)
