"""Runs of one benchmark cell in turns, with the program's tracing off or
forced on, and optionally from another checkout, on one CUDA card, so the
cost of tracing (and a parent against a change) is measured in one call.

    python tools/exp_tracing_cost.py --seeds S1,S2,... [--plan off,on]
        [--parent DIR] [--workload scanner_default.seq_full] [--seconds 51]
        [--out chiprun_out/tracing_cost.json]

Each token of ``--plan`` is one run of ``benchmark/run.py --trace 0`` in a
process of its own: ``off`` from this checkout as the benchmark runs it,
``on`` from this checkout with ``utils.metrics.set_tracing(True)`` before
the harness starts (``run_all`` keeps it on, so every pass of the window
records the program's spans and counters), ``parent`` from ``--parent``
(an unpacked ``git archive`` of another commit). The plan runs once a
seed, reversed on every other seed. A run's result line gives
``images_per_s``, ``setup_s`` and the harness's stage spans; an ``on`` run
adds the program's spans and counters summed over the window's passes
(``program``: {stage: {name: value}}). Writes every run as JSON to
``--out`` and prints a summary line per arm.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(argv, program_out):
    """One benchmark run with the program's tracing on; the program's
    metrics of every ``run_all`` in the window are summed into
    ``program_out``."""
    t_start = time.perf_counter()
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "4")
    sys.path.insert(0, ROOT)
    from benchmark.harness import main as harness
    from scanner_colmap_tpu_torch.pipeline import stages
    from scanner_colmap_tpu_torch.utils import metrics

    runs, run_all = [], stages.run_all

    def recorded(*a, **kw):
        out = run_all(*a, **kw)
        runs.append(metrics.GLOBAL_METRICS.to_dict())
        return out

    stages.run_all = recorded
    metrics.set_tracing(True)
    rc = harness.main(argv, t_start)
    window = runs[1:]                  # the first run is the set-up's pass
    total = {}
    for r in window:
        for stage, kv in r.items():
            for k, v in kv.items():
                if k.startswith(("span.", "count.")):
                    total.setdefault(stage, {})
                    total[stage][k] = total[stage].get(k, 0.0) + v
    with open(program_out, "w") as f:
        json.dump({"passes": len(window), "program": total}, f)
    return rc


def one_run(arm, seed, a, tmp):
    cwd = a.parent if arm == "parent" else ROOT
    args = ["--workload", a.workload, "--seed", str(seed), "--seconds", str(a.seconds),
            "--trace", "0"]
    prog = os.path.join(tmp, f"{arm}.{seed}.program.json")
    cmd = ([sys.executable, os.path.abspath(__file__), "--child", prog] + args
           if arm == "on" else [sys.executable, "benchmark/run.py"] + args)
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
    out = {"arm": arm, "seed": seed, "rc": p.returncode,
           "process_s": time.perf_counter() - t0}
    try:
        line = json.loads(p.stdout.strip().splitlines()[-1])
        out.update(images_per_s=line["metrics"]["images_per_s"]["value"],
                   setup_s=line["metrics"]["setup_s"]["value"], correct=line["correct"],
                   passes=line["passes"], pass_s=line["pass_s"], stage_s=line["stage_s"],
                   card=line["device"].get("card"))
    except (IndexError, ValueError, KeyError):
        out["stderr"] = p.stderr[-3000:]
    if arm == "on" and os.path.exists(prog):
        with open(prog) as f:
            out.update(json.load(f))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0], allow_abbrev=False)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--plan", default="off,on")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--workload", default="scanner_default.seq_full")
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--out", default="chiprun_out/tracing_cost.json")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    a, rest = ap.parse_known_args()
    if a.child:
        return child(["--workload", a.workload, "--seconds", str(a.seconds)] + rest, a.child)
    plan = a.plan.split(",")
    if "parent" in plan and not a.parent:
        raise SystemExit("--plan names parent: give --parent DIR")
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for n, seed in enumerate(int(s) for s in a.seeds.split(",")):
            for arm in (plan if n % 2 == 0 else plan[::-1]):
                r = one_run(arm, seed, a, tmp)
                runs.append(r)
                print(json.dumps({k: r.get(k) for k in ("arm", "seed", "rc", "images_per_s",
                                                        "setup_s", "correct", "passes")}),
                      flush=True)
                os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
                with open(a.out, "w") as f:
                    json.dump(runs, f)
    for arm in dict.fromkeys(plan):
        got = [r["images_per_s"] for r in runs if r["arm"] == arm and "images_per_s" in r]
        if got:
            print(json.dumps({"arm": arm, "runs": len(got),
                              "images_per_s_median": statistics.median(got),
                              "images_per_s": got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
