"""The readers of the merge's triangulation span and the mapper's drop
counter (``triangulate_ms_per_image``, ``tracks_dropped_per_image``) on
a hand-made traced pass: each reads the program's registry, 0 drops where
the program counted none, and None where the program records neither (the
parent of the change that added them)."""

import pytest

from benchmark.harness import cell as cell_mod
from benchmark.harness import program
from benchmark.tests.test_bench_program import IMAGES, _view
from scanner_colmap_tpu_torch.utils import metrics as tm

NEW = ("triangulate_ms_per_image", "tracks_dropped_per_image")


@pytest.fixture
def registry():
    reg = tm.GLOBAL_METRICS
    reg.reset()
    yield reg
    reg.reset()


def _read():
    view = _view()
    return {m: cell_mod.reader(m)(view) for m in NEW}


def test_readers_read_the_span_and_the_counter(registry):
    registry.set_stage("mapping")
    base = registry._stage_t0
    registry.inc("mapping", "count.mapping.tracks_dropped", 0)
    registry.inc("mapping", "count.mapping.tracks_dropped", 250)
    registry.add_span("triangulate.dlt", base, base + 0.1, 0.1)      # a host retry
    registry.set_stage("merge")
    base = registry._stage_t0
    registry.add_span("triangulate.dlt", base, base + 0.4, 0.4)
    registry.add_span("triangulate.dlt", base + 1, base + 1.5, 0.5)
    registry.inc("merge", "count.triangulate.tracks", 40000)
    registry.set_stage(None)
    got = _read()
    assert got["triangulate_ms_per_image"] == pytest.approx(1e3 * 1.0 / IMAGES)
    assert got["tracks_dropped_per_image"] == pytest.approx(25.0)


def test_no_drop_reads_zero(registry):
    registry.set_stage("mapping")
    for _ in range(3):
        registry.inc("mapping", "count.mapping.tracks_dropped", 0)
    registry.set_stage(None)
    got = _read()
    assert got["tracks_dropped_per_image"] == 0.0
    assert got["triangulate_ms_per_image"] is None


def test_readers_read_none_without_the_programs_data(registry, monkeypatch):
    assert all(v is None for v in _read().values())

    class Old:                          # a registry without spans or counters
        def to_dict(self):
            return {"mapping": {"wall_s": 3.0}, "merge": {"wall_s": 1.0}}

    monkeypatch.setattr(program, "_registry", lambda: Old())
    assert all(v is None for v in _read().values())
    monkeypatch.setattr(program, "_registry", lambda: None)
    assert all(v is None for v in _read().values())


def test_both_cells_report_them():
    bench = cell_mod.manifest()
    for name in ("scanner_default.seq_full", "colmap_capacity.seq_sparse"):
        cell = cell_mod.load(name, bench)
        assert set(NEW) <= set(cell.per_layer)
        assert "images_per_s" in cell.end_to_end
