"""Structured metrics and device tracing (port of ``utils/metrics.py``).

- ``Metrics``: named counters and gauges grouped by stage, dumpable as one
  JSON blob. ``GLOBAL_METRICS`` is the process-wide one: ``run_all``
  resets it at its start and ``_run_stage`` opens each stage in it.
- ``span`` and ``count``: the program's own spans and counters, added into
  ``GLOBAL_METRICS`` under the open stage (``RUN`` while none is) as
  ``span.<name>.n``, ``span.<name>.s``, ``span.<name>.self_s`` and
  ``count.<name>``. They record only while tracing is on
  (``set_tracing``); off, the default, ``span`` hands back one shared
  no-op and ``count`` returns after one flag test. Neither synchronizes
  with the device or reads from it: a span times the host, and where its
  code waits for the device, the wait is in its time. Each stage keeps
  its spans' intervals (``Metrics.timeline``), which a caller's own
  profiler trace can be laid against.
- ``device_trace``: a ``torch.profiler`` trace of CPU and CUDA activity,
  written as a Chrome trace into a directory, flushed even when the body
  raises. Tracing is on inside it, and each span is a ``record_function``
  range of the trace named ``SPAN_PREFIX + name``, beside the device's
  activities. A caller's profiler gets no ranges from the program.
- ``reconstruction_metrics``: the numbers COLMAP reports for a sparse model.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "scanner."   # the profiler's name of a span: SPAN_PREFIX + name
RUN = "run"                # the stage of spans and counters while no stage is open

_tracing = False
_ranges = False             # spans are record_function ranges (inside device_trace)
_local = threading.local()  # each thread's stack of open spans


def set_tracing(on: bool) -> bool:
    """Turn the program's spans and counters on or off, for the whole
    process; returns the setting it replaces."""
    global _tracing
    was, _tracing = _tracing, bool(on)
    return was


def tracing() -> bool:
    return _tracing


def profiler_running() -> bool:
    """Whether a ``torch.profiler`` (or the autograd profiler) is recording."""
    return bool(torch._C._autograd._profiler_enabled())


class Metrics:
    """Process-wide structured metrics, grouped by stage."""

    def __init__(self):
        self._data: Dict[str, Dict[str, float]] = defaultdict(dict)
        self._timeline: Dict[str, Dict[str, list]] = defaultdict(lambda: defaultdict(list))
        self._lock = threading.Lock()
        self._stage: Optional[str] = None
        self._stage_t0 = time.perf_counter()

    def reset(self):
        """Forget everything, and close the open stage."""
        with self._lock:
            self._data.clear()
            self._timeline.clear()
        self.set_stage(None)

    def set_stage(self, stage: Optional[str]):
        """Open ``stage`` (None closes the open one): spans and counters go
        under it, and its timeline counts from now."""
        self._stage = stage
        self._stage_t0 = time.perf_counter()

    def current_stage(self) -> str:
        return self._stage or RUN

    def set(self, stage: str, name: str, value):
        with self._lock:
            self._data[stage][name] = float(value)

    def inc(self, stage: str, name: str, delta: float = 1.0):
        with self._lock:
            self._data[stage][name] = self._data[stage].get(name, 0.0) + delta

    def add_span(self, name: str, t0: float, t1: float, self_s: float):
        """One finished span, [t0, t1] on ``time.perf_counter``'s clock, of
        which ``self_s`` seconds were outside its child spans."""
        stage, base = self.current_stage(), self._stage_t0
        key = "span." + name
        with self._lock:
            d = self._data[stage]
            d[key + ".n"] = d.get(key + ".n", 0.0) + 1.0
            d[key + ".s"] = d.get(key + ".s", 0.0) + (t1 - t0)
            d[key + ".self_s"] = d.get(key + ".self_s", 0.0) + self_s
            self._timeline[stage][name].append((t0 - base, t1 - base))

    @contextlib.contextmanager
    def timer(self, stage: str, name: str = "wall_s", items_name: Optional[str] = None,
              items: Optional[int] = None):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.set(stage, name, dt)
        if items_name and items is not None:
            self.set(stage, items_name, items / max(dt, 1e-9))

    def stage(self, stage: str) -> Dict[str, float]:
        with self._lock:
            return dict(self._data.get(stage, {}))

    def timeline(self, stage: str) -> Dict[str, List[Tuple[float, float]]]:
        """{span: [(start_s, end_s), ...]} of the stage's spans, in seconds
        from the stage's opening, in the order they ended."""
        with self._lock:
            return {k: list(v) for k, v in self._timeline.get(stage, {}).items()}

    def to_dict(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: dict(v) for k, v in self._data.items()}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def dump(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json())


GLOBAL_METRICS = Metrics()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "t0", "children_s", "mark")

    def __init__(self, name: str):
        self.name = name
        self.children_s = 0.0
        self.mark = None

    def __enter__(self):
        if _ranges:
            self.mark = torch.profiler.record_function(SPAN_PREFIX + self.name)
            self.mark.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        total = t1 - self.t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].children_s += total
        GLOBAL_METRICS.add_span(self.name, self.t0, t1, total - self.children_s)
        if self.mark is not None:
            self.mark.__exit__(*exc)
        return False


def span(name: str):
    """A context manager timing its block as the span ``name`` while
    tracing is on; nested spans of one thread give their parent its self
    time. Off, the shared no-op."""
    return _Span(name) if _tracing else _NO_SPAN


def count(name: str, n: float = 1):
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _tracing:
        GLOBAL_METRICS.inc(GLOBAL_METRICS.current_stage(), "count." + name, n)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str], summary: Optional[dict] = None):
    """``torch.profiler`` trace scope (CPU, and CUDA where a card is
    visible), exported to ``log_dir/trace.json`` when the scope ends, also
    when it raises; tracing (``span``, ``count``) is on inside it, each
    span a range of the trace. A no-op when log_dir is None. With a dict
    ``summary``, the scope's device work is added to it
    (``device_work``)."""
    global _ranges
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    was, was_ranges = set_tracing(True), _ranges
    prof.start()
    _ranges = True
    try:
        yield prof
    finally:
        _ranges = was_ranges
        prof.stop()
        set_tracing(was)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        if summary is not None:
            summary.update(device_work(prof))


def busy_ns(intervals) -> int:
    """Length of the union of (start, end) intervals: time covered by at
    least one of them, so overlapping intervals count once."""
    total, reach = 0, None
    for a, b in sorted(intervals):
        if reach is None or a > reach:
            total += b - a
            reach = b
        elif b > reach:
            total += b - reach
            reach = b
    return total


def device_work(prof) -> Dict[str, float]:
    """Device activities (kernels, copies and sets) of a finished
    ``torch.profiler`` run and the time in which the device ran any of
    them (``device_busy_ms``: the union of their intervals, so streams that
    overlap count once). The device's mirrors of ``record_function``
    ranges are not activities."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())

    def mark(e):
        return bool(getattr(e, "is_user_annotation", lambda: False)())

    marks = {e.name() for e in events if mark(e)}
    iv = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
          if e.device_type() == DeviceType.CUDA and not mark(e) and e.name() not in marks]
    return {"device_kernels": len(iv), "device_busy_ms": busy_ns(iv) / 1e6}


def reconstruction_metrics(rec) -> Dict[str, float]:
    """Standard sparse-model quality metrics (the numbers COLMAP reports)."""
    return {
        "num_registered_images": rec.num_registered,
        "num_points3D": len(rec.points3D),
        "mean_track_length": rec.mean_track_length(),
        "mean_reprojection_error_px": rec.mean_reprojection_error(),
        "num_observations": float(sum(p.track_length for p in rec.points3D.values())),
    }
