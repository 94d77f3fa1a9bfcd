"""Nothing under benchmark/ imports JAX or the JAX package, compared by the
whole top-level module name (the port's name begins with the JAX
package's), and the command gives no result without a card."""

import ast
import json
import os
import shutil
import subprocess
import sys

from benchmark.harness import cell as cell_mod
from benchmark.harness.main import FORBIDDEN

BENCH = cell_mod.BENCH_DIR


def _sources():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_levels(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_imports_jax():
    found = {(os.path.relpath(p, BENCH), m) for p in _sources() for m in _top_levels(p)
             if m in FORBIDDEN}
    assert not found
    # the port's name is allowed: the comparison is of whole names
    assert "scanner_colmap_tpu_torch" not in FORBIDDEN


def test_nothing_loads_jax():
    mods = sorted(os.path.relpath(p, cell_mod.ROOT)[:-3].replace(os.sep, ".")
                  for p in _sources() if not p.endswith("__init__.py"))
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import scanner_colmap_tpu_torch.pipeline.stages\n"
            f"bad = {{m.split('.')[0] for m in sys.modules}} & set({FORBIDDEN!r})\n"
            "print(sorted(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=cell_mod.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "scanner_default.seq_full", "--seed", "2147483659",
                           "--seconds", "1", "--trace", "0"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def _no_result(out):
    last = (out.stdout.strip().splitlines() or [""])[-1]
    try:
        return not isinstance(json.loads(last), dict)
    except ValueError:
        return True


def test_no_card_no_result():
    out = _run(cell_mod.ROOT)
    assert out.returncode != 0 and _no_result(out)


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(cell_mod.ROOT, "BENCHMARK.json"), tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0 and _no_result(out)
