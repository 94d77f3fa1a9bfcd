"""The traced pass, reduced to what the per-layer readers read.

``torch.profiler`` (CPU and CUDA) runs over one whole pass of the window.
From its events the harness keeps the device's activities (kernels, copies
and sets), the stage spans the ``Recorder`` annotated, and the pass's own
span. The device's busy time is the union of its activity intervals, so
kernels that overlap on different streams count once.
"""

from __future__ import annotations

import collections
import json
import os

import numpy as np
from torch.autograd import DeviceType

from benchmark.harness.record import SPAN_PREFIX
from benchmark.roofline import peaks as peaks_mod

PASS_SPAN = SPAN_PREFIX + "pass"


def _union(iv: np.ndarray) -> np.ndarray:
    """Disjoint, sorted intervals covering (n, 2) intervals."""
    if not len(iv):
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    group = np.cumsum(new) - 1
    stops = np.zeros(len(starts))
    np.maximum.at(stops, group, iv[:, 1])
    return np.stack([starts, stops], 1)


class TraceView:
    """One traced pass, and the untraced window's stage spans: what the
    per-layer readers are given.

    ``images``: images offered in the traced pass; ``spans``: {stage:
    seconds} on the host clock, summed over the untraced window's passes,
    which offered ``window_images`` images (the profiler lengthens the
    traced pass's host work, so its own spans are kept for the dump only);
    ``stage_windows``: {stage: (start_s, end_s)} and
    ``window``: the pass's (start_s, end_s), on the profiler's clock from
    the pass's start;
    ``names``, ``iv``: each device activity's name and (start_s, end_s);
    ``work``: {kernel: [(operations, bytes), ...]} of the calls tapped in
    the set-up's pass; ``launches``: {kernel: (calls tapped, launches in
    the traced pass)}; ``card``: the card's peaks."""

    def __init__(self, images, spans, window_images, events, work, launches, device_name):
        self.images = images
        self.spans = dict(spans)
        self.window_images = window_images
        self.work = work
        self.launches = launches
        self.card = peaks_mod.peaks(device_name)
        names, iv, host, spans_ns = [], [], [], {}
        for e in events:
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                # a kernel, copy or set, or the device's mirror of a span
                if not name.startswith(SPAN_PREFIX):
                    t0 = e.start_ns()
                    names.append(name)
                    iv.append((t0, t0 + e.duration_ns()))
                continue
            host.append(name)
            if name.startswith(SPAN_PREFIX):
                t0 = e.start_ns()
                spans_ns[name[len(SPAN_PREFIX):]] = (t0, t0 + e.duration_ns())
        # nanoseconds from the pass's start, exact in integers, then seconds
        base = spans_ns.get("pass", (0, 0))[0]
        self.stage_windows = {k: ((a - base) * 1e-9, (b - base) * 1e-9)
                              for k, (a, b) in spans_ns.items()}
        self.window = self.stage_windows.pop("pass", None)
        self.host_ops = collections.Counter(host)     # the host's events by name
        self.names = np.asarray(names, dtype=object)
        self.iv = (np.asarray(iv, np.int64).reshape(-1, 2) - base) * 1e-9
        self.busy = _union(self.iv)

    # -- what the readers ask ------------------------------------------------

    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """Seconds in which the device ran anything, inside the pass."""
        if self.window is None or not len(self.busy):
            return 0.0
        b = np.clip(self.busy, *self.window)
        return float((b[:, 1] - b[:, 0]).sum())

    def stage_ms_per_image(self, *stages):
        """Summed host-clock span of the stages over the untraced window,
        ms per image it offered, or None where none of them ran."""
        got = [self.spans[s] for s in stages if s in self.spans]
        return 1e3 * sum(got) / self.window_images if got else None

    def device_activities_in(self, stage: str) -> int:
        """Device activities that started inside the stage's span."""
        if stage not in self.stage_windows or not len(self.iv):
            return 0
        t0, t1 = self.stage_windows[stage]
        return int(((self.iv[:, 0] >= t0) & (self.iv[:, 0] < t1)).sum())

    def kernel_seconds(self, substrings) -> float:
        """Summed device time of the activities whose name holds one of
        ``substrings``."""
        if not len(self.iv):
            return 0.0
        hit = np.array([any(s in n for s in substrings) for n in self.names], bool)
        return float((self.iv[hit, 1] - self.iv[hit, 0]).sum())

    def roofline(self, kernel_module, name: str):
        """Sum over the tapped calls of the least time, over the kernel's
        device time in the traced pass, in percent; None where the kernel
        did not run there or the card has no entry in the peaks table. The
        set-up's pass and the traced pass run the same work; where their
        launches differ, the sum is scaled by the traced pass's launches
        over the calls tapped."""
        calls = self.work.get(name)
        dev_s = self.kernel_seconds(kernel_module.DEVICE_KERNELS)
        if not calls or dev_s <= 0 or self.card is None:
            return None
        least = sum(peaks_mod.least_seconds(f, b, kernel_module.KIND, self.card)
                    for f, b in calls)
        tapped, launched = self.launches.get(name, (len(calls), len(calls)))
        return 100.0 * least * (launched / tapped) / dev_s

    # -- the breakdown -----------------------------------------------------

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        time by the stage the host was in."""
        ops = {}
        for n, (a, b) in zip(self.names, self.iv):
            ops[n] = ops.get(n, 0.0) + (b - a)
        device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        gaps = {}
        if self.window is not None:
            w0, w1 = self.window
            b = np.clip(self.busy, w0, w1) if len(self.busy) else np.zeros((0, 2))
            edges = np.concatenate([[w0], b.ravel(), [w1]]).reshape(-1, 2)
            for g0, g1 in edges:
                if g1 <= g0:
                    continue
                mid = 0.5 * (g0 + g1)
                where = next((s for s, (a, z) in self.stage_windows.items() if a <= mid < z),
                             "between stages")
                gaps[where] = gaps.get(where, 0.0) + (g1 - g0)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[str(n), float(s)] for n, s in device_ops],
                "idle_gaps": [[f"idle in {n}", float(s)] for n, s in idle]}

    def key_averages(self):
        """[name, count, seconds] of the device's activities by name, the
        longest first, and [name, count] of the host's events, the most
        frequent first."""
        dev = {}
        for n, (a, b) in zip(self.names, self.iv):
            agg = dev.setdefault(n, [0, 0.0])
            agg[0] += 1
            agg[1] += b - a
        return {"device": sorted(([k, *v] for k, v in dev.items()), key=lambda r: -r[2]),
                "host": [[k, c] for k, c in self.host_ops.most_common()]}

    def dump(self, path: str):
        """The spans, the tapped work and the key averages as one JSON file
        (not the whole Chrome trace)."""
        out = {"window_spans": self.spans, "window_images": self.window_images,
               "stage_windows": self.stage_windows,
               "window": self.window, "busy_s": self.busy_s(),
               "work": self.work, "launches": self.launches,
               "breakdown": self.breakdown(top=40), "key_averages": self.key_averages()}
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f)
