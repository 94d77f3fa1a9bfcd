"""The readers of what the program records of itself (``harness/program.py``
and the eight metrics on it), on a synthetic traced pass: each reads its
value from the program's spans and counters, and None where the program
has none (a program without them, as before they were added, or a run
that recorded none). The existing readers and the breakdown read the same
whatever the program recorded."""

import numpy as np
import pytest
from torch.autograd import DeviceType

from benchmark.harness import cell as cell_mod
from benchmark.harness import program
from benchmark.harness.trace import TraceView
from scanner_colmap_tpu_torch.utils import metrics as tm

NEW = ("mapping_ba_ms_per_image", "mapping_host_ms_per_image", "mapping_ba_idle_share",
       "lm_trials_per_image", "host_reads_per_image", "depth_ranges_ms_per_image",
       "decode_ms_per_image", "store_ms_per_image")
IMAGES = 10


class _Event:
    def __init__(self, name, device, start_s, end_s):
        self._v = (name, device, int(start_s * 1e9), int((end_s - start_s) * 1e9))

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]


def _view():
    """A pass of 10 s from 100 s on the profiler's clock: mapping from 2 to
    6 s, the host stage from 6 to 8 s, and four device kernels."""
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    t = 100.0
    events = [_Event("bench.pass", cpu, t, t + 10), _Event("bench.run_mapping", cpu, t + 2, t + 6),
              _Event("bench.run_prepare_patch_match", cpu, t + 6, t + 8),
              _Event("gemm", cuda, t + 2.1, t + 2.2), _Event("gemm", cuda, t + 2.4, t + 2.6),
              _Event("gather", cuda, t + 3.5, t + 5.0), _Event("bench.run_mapping", cuda, t + 2,
                                                               t + 6)]
    return TraceView(IMAGES, {"run_mapping": 1.0}, 3 * IMAGES, events, {}, {}, "cpu")


@pytest.fixture
def recorded():
    """The program's registry as a traced pass leaves it."""
    reg = tm.GLOBAL_METRICS
    reg.reset()
    reg.set_stage("mapping")
    base = reg._stage_t0
    for a, b in ((0.0, 0.5), (1.0, 2.0)):            # on the trace: 2-2.5 s, 3-4 s
        reg.add_span("mapping.ba", base + a, base + b, b - a)
    reg.add_span("mapping.prepare", base, base + 0.03, 0.03)
    reg.add_span("mapping.unpack", base, base + 0.02, 0.02)
    reg.inc("mapping", "count.ba.lm_trials", 150)
    reg.inc("mapping", "count.host_reads", 250)
    reg.add_span("store.read", base, base + 0.01, 0.01)
    reg.set_stage("prepare_patch_match")
    base = reg._stage_t0
    reg.add_span("prepare_patch_match.depth_ranges", base, base + 0.8, 0.8)
    reg.add_span("image.decode", base, base + 0.2, 0.2)
    reg.add_span("store.write", base, base + 0.04, 0.04)
    reg.set_stage("extraction")
    reg.add_span("image.decode", base, base + 0.3, 0.3)
    reg.set_stage(None)
    yield reg
    reg.reset()


def _read(view):
    return {m: cell_mod.reader(m)(view) for m in NEW}


def test_readers_read_the_programs_spans_and_counters(recorded):
    got = _read(_view())
    want = {"mapping_ba_ms_per_image": 150.0, "mapping_host_ms_per_image": 5.0,
            "lm_trials_per_image": 15.0, "host_reads_per_image": 25.0,
            "depth_ranges_ms_per_image": 80.0, "decode_ms_per_image": 50.0,
            "store_ms_per_image": 5.0,
            # the device ran 0.1 + 0.1 s of 2-2.5 s and 0.5 s of 3-4 s
            "mapping_ba_idle_share": 100.0 * (1 - 0.7 / 1.5)}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-6), k


def test_readers_read_none_without_the_programs_data(monkeypatch):
    tm.GLOBAL_METRICS.reset()
    assert all(v is None for v in _read(_view()).values())

    class Old:                          # a registry without spans, counters or timeline
        def to_dict(self):
            return {"mapping": {"wall_s": 3.0}}

    monkeypatch.setattr(program, "_registry", lambda: Old())
    assert all(v is None for v in _read(_view()).values())
    monkeypatch.setattr(program, "_registry", lambda: None)
    assert all(v is None for v in _read(_view()).values())


def test_idle_share_needs_the_stage_and_the_device(recorded):
    view = _view()
    view.stage_windows.pop("run_mapping")
    assert cell_mod.reader("mapping_ba_idle_share")(view) is None
    view = _view()
    view.busy = np.zeros((0, 2))
    assert cell_mod.reader("mapping_ba_idle_share")(view) is None


def test_existing_readers_read_the_same(recorded):
    """The accepted readers and the breakdown do not read the program's
    registry: the same values with and without what it recorded."""
    bench = cell_mod.manifest()
    old = [m["name"] for m in bench["per_layer"] if m["name"] not in NEW]
    view = _view()
    with_data = ({m: cell_mod.reader(m)(view) for m in old}, view.breakdown())
    tm.GLOBAL_METRICS.reset()
    view = _view()
    assert ({m: cell_mod.reader(m)(view) for m in old}, view.breakdown()) == with_data
    assert with_data[0]["mapping_device_kernels_per_image"] == 0.3


def test_covered_seconds_clip_to_the_spans():
    busy = np.array([[0.0, 1.0], [2.0, 3.0], [4.0, 6.0]])
    spans = np.array([[0.5, 2.5], [5.0, 7.0]])
    assert program.covered_s(busy, spans) == pytest.approx(0.5 + 0.5 + 1.0)
    assert program.covered_s(busy, np.array([[3.2, 3.8]])) == 0.0
