"""BENCHMARK.json against the contract the benchmark is held to, and the
files it names."""

import json
import os
import re

import pytest

from benchmark.harness import cell as cell_mod

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# a full check: 2 + 14 runs a cell, each run_seconds + 60 s, 2 x 90 s a
# cell to compile, 1200 s spare, for the 24 cells later PRs may reach
CHECK_SECONDS, MAX_CELLS = 43200, 24


@pytest.fixture(scope="module")
def bench():
    return cell_mod.manifest()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_units(bench):
    assert set(bench) == TOP_KEYS
    assert len(json.dumps(bench)) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert not any(w.startswith("/") or ".." in w for w in bench["command"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in bench[group]]
        assert len(names) == len(set(names)), group
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(
        bench["workloads"])
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * MAX_CELLS) * (rs + 60) + MAX_CELLS * 180 + 1200 <= CHECK_SECONDS


def test_every_cell_reports_what_it_must(bench):
    cells = {w["name"] for w in bench["workloads"]}
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for name in cells:
        cell = cell_mod.load(name, bench)
        assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
        assert cell.per_layer
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells
            assert m["moves"] in cell_mod.load(w, bench).end_to_end
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert m["better"] == "higher"
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_files_exist_and_apply(bench):
    from scanner_colmap_tpu_torch.utils.config import PipelineConfig

    for w in bench["workloads"]:
        cell = cell_mod.load(w["name"], bench)
        cfg = cell_mod.pipeline_config(cell, "images")
        base = PipelineConfig()
        for key, val in cell.config["overrides"].items():
            section, field = key.split(".")
            assert hasattr(getattr(base, section), field), key
            assert getattr(getattr(cfg, section), field) == val
        for key in cell.traffic.get("control_overrides", {}):
            section, field = key.split(".")
            assert hasattr(getattr(base, section), field), key
        conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
        assert set(conf["reduced"]) == set(cell.config["reduced"])
        assert cell.traffic["track"] in ("arc", "out_and_back")
        assert cell.limits and all(v > 0 for v in cell.limits.values())
        for m in cell.per_layer:
            assert callable(cell_mod.reader(m))


def test_command_names_only_files_under_paths(bench):
    root = cell_mod.ROOT
    for word in bench["command"][1:]:
        if os.path.exists(os.path.join(root, word)):
            assert any(word.startswith(p + "/") for p in bench["paths"])
