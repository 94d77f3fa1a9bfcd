"""A cell as the files name it: the ``workloads`` entry of
``BENCHMARK.json``, its configuration (``configs/<config>.json``), its
traffic mix (``traffic/<traffic>.json``), the limits of its check
(``limits/<cell>.json``) and the per-layer readers it reports
(``metrics/<metric>.py``). Nothing here knows a cell by name.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest() -> dict:
    return _load_json(ROOT, "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    limits: dict          # limits/<cell>.json: {number: limit}
    end_to_end: list      # names of the end-to-end metrics it reports
    per_layer: list       # names of the per-layer metrics it reports


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; KeyError if there is none."""
    bench = bench or manifest()
    work = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    return Cell(
        name=name, chips=int(work["chips"]),
        config=_load_json(ROOT, conf["file"]),
        traffic=_load_json(BENCH_DIR, "traffic", work["traffic"] + ".json"),
        limits=_load_json(BENCH_DIR, "limits", name + ".json")["limits"],
        end_to_end=[m["name"] for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m["name"] for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read(trace_view)``."""
    return importlib.import_module(f"benchmark.metrics.{metric}").read


def pipeline_config(cell: Cell, image_dir: str, control: bool = False):
    """The program's ``PipelineConfig`` for the cell: defaults, then the
    configuration's dotted overrides; with ``control``, also the traffic's
    ``control_overrides`` (the guarantees the control breaks)."""
    from scanner_colmap_tpu_torch.utils.config import PipelineConfig

    cfg = PipelineConfig()
    cfg.apply_overrides(cell.config.get("overrides", {}))
    if control:
        cfg.apply_overrides(cell.traffic.get("control_overrides", {}))
    cfg.image_path = image_dir
    return cfg
