"""The port's spans and counters (``utils/metrics``), on the CPU.

- off (the default), ``span`` is one shared no-op, ``count`` records
  nothing, and a ``torch.profiler`` run sees no program event;
- on, nested spans give their counts, totals, self times and stage, spans
  from a thread pool add up under the lock, counters add up, and the
  stage's timeline holds each span's interval;
- inside ``device_trace`` each span is a ``record_function`` range of the
  trace, with the program's prefix; a caller's profiler sees none;
- a CG bundle adjustment records the ``ba.cg.*`` spans and one
  ``ba.lm_trials`` and one ``host_reads`` a trial;
- ``device_work``'s busy time is the union of the device's intervals, so
  overlapping activities count once and the device's mirror of a
  ``record_function`` range is no activity.

The whole runs (tracing on and off, every span and counter) are in
tests/test_torch_cli.py; the host reads of a device map against their
sites' hand count in tests/test_torch_batch_mapper.py.
"""

import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from scanner_colmap_tpu_torch.ops import ba as tba
from scanner_colmap_tpu_torch.utils import metrics as tm

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def fresh():
    """A reset registry, tracing off, before and after each test."""
    was = tm.set_tracing(False)
    tm.GLOBAL_METRICS.reset()
    yield tm.GLOBAL_METRICS
    tm.set_tracing(was)
    tm.GLOBAL_METRICS.reset()


def _program_events(prof):
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.name().startswith(tm.SPAN_PREFIX)]


def test_off_records_nothing(fresh):
    assert not tm.tracing()
    a, b = tm.span("x"), tm.span("y")
    assert a is b
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with a:
            with tm.span("x.inner"):
                torch.ones(4).sum()
        tm.count("c", 5)
    assert fresh.to_dict() == {}
    assert _program_events(prof) == []


def test_nested_spans_give_totals_self_time_and_stage(fresh):
    tm.set_tracing(True)
    fresh.set_stage("mapping")
    with tm.span("outer"):
        time.sleep(0.02)
        for _ in range(2):
            with tm.span("inner"):
                time.sleep(0.03)
    tm.count("reads")
    tm.count("reads", 2)
    fresh.set_stage(None)
    with tm.span("outside"):
        pass
    d = fresh.to_dict()
    m = d["mapping"]
    assert m["span.outer.n"] == 1 and m["span.inner.n"] == 2 and m["count.reads"] == 3
    assert m["span.inner.s"] >= 0.06 and m["span.outer.s"] >= m["span.inner.s"] + 0.02
    assert m["span.outer.self_s"] == pytest.approx(m["span.outer.s"] - m["span.inner.s"])
    assert m["span.inner.self_s"] == m["span.inner.s"]
    assert d[tm.RUN]["span.outside.n"] == 1
    line = fresh.timeline("mapping")
    assert len(line["inner"]) == 2 and len(line["outer"]) == 1
    (o0, o1), = line["outer"]
    assert all(o0 <= a < b <= o1 for a, b in line["inner"])


def test_spans_of_a_thread_pool_add_up(fresh):
    tm.set_tracing(True)
    fresh.set_stage("extraction")

    def work(_):
        with tm.span("image.decode"):
            time.sleep(0.005)
        tm.count("decoded")

    with tm.span("stage.body"):
        with ThreadPoolExecutor(max_workers=4) as pool:
            list(pool.map(work, range(40)))
    d = fresh.stage("extraction")
    assert d["span.image.decode.n"] == 40 and d["count.decoded"] == 40
    assert d["span.image.decode.s"] >= 40 * 0.005
    # the pool's spans are their own threads' roots: the body keeps its self time
    assert d["span.stage.body.self_s"] == d["span.stage.body.s"]


def test_spans_are_ranges_of_the_programs_own_trace(fresh, tmp_path):
    """Inside ``device_trace`` (``--profile_dir``) tracing is on and each
    span is a range of the trace; a caller's profiler gets no ranges from
    the program, also with tracing on."""
    with tm.device_trace(str(tmp_path / "trace")) as prof:
        assert tm.tracing()
        with tm.span("mapping.ba"):
            torch.ones(4).sum()
    assert not tm.tracing()
    assert _program_events(prof) == [tm.SPAN_PREFIX + "mapping.ba"]
    tm.set_tracing(True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tm.span("mapping.ba"):
            torch.ones(4).sum()
    assert _program_events(prof) == []
    assert fresh.stage(tm.RUN)["span.mapping.ba.n"] == 2


def test_cg_bundle_adjustment_records_its_spans_and_trials(fresh):
    params, obs, cfg = tba.synthetic_bundle(M=4, P=64, T=3, seed=1, device=CPU)
    tm.set_tracing(True)
    _, info = tba.bundle_adjust(params, obs, cfg, max_iterations=3, solver="cg", cg_iters=4)
    d = fresh.stage(tm.RUN)
    for name in ("ba.cg.matvec", "ba.cg.gather", "ba.cg.einsum", "ba.cg.segsum"):
        assert d[f"span.{name}.n"] == 4 * info["iterations"] and d[f"span.{name}.s"] > 0
    # on the CPU no CamSegments plan is built: one read a trial, its stop
    assert d["count.ba.lm_trials"] == info["iterations"] == d["count.host_reads"]


class _Event:
    def __init__(self, name, device, start, end, mark=False):
        self._v = (name, device, start, end, mark)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def is_user_annotation(self):
        return self._v[4]


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "R", (), {"events": staticmethod(lambda: events)})()})()


def test_busy_time_is_the_union_of_the_device_intervals():
    assert tm.busy_ns([(0, 10), (5, 20)]) == 20
    assert tm.busy_ns([(30, 40), (0, 10)]) == 20
    assert tm.busy_ns([(0, 10), (2, 4), (10, 12)]) == 12
    assert tm.busy_ns([]) == 0
    from torch.autograd import DeviceType

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    prof = _Prof([_Event("scanner.mapping.ba", cpu, 0, 100_000_000, mark=True),
                  _Event("scanner.mapping.ba", cuda, 0, 100_000_000),     # its mirror
                  _Event("gemm", cuda, 1_000_000, 3_000_000),             # two streams
                  _Event("gather", cuda, 2_000_000, 4_000_000),
                  _Event("aten::mm", cpu, 0, 5_000_000)])
    assert tm.device_work(prof) == {"device_kernels": 2, "device_busy_ms": 3.0}
