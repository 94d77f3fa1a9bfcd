"""Kernel 4 (``scanner_colmap_tpu_torch/kernels/csrc/plane_cost.cu``) on one
CUDA card: one Jacobi sweep (ten candidates) per variant at the shapes of
``chip_smoke.py`` phase 12, beside an earlier per-candidate kernel.

    python tools/exp_plane_cost_cuda.py [--old OLD_plane_cost.cu]
                                        [--tiles 16x16,16x8,8x8] [--reps 20]

At 96x96 and 160x192 with 4 sources (the 192-px configuration's coarse and
fine shapes) and 384x480 with 8 (the 480-px one), radius 5, it builds
``chip_smoke.k4_problem``'s state and two extra fields, then times one
``plane_cost_sweep`` call by graph replay (``chip_smoke.cuda_ms``, median
of ``--reps``) for every tile of ``--tiles`` (the kernel built with
``-DTILE_W -DTILE_H``), and at 16x16 for an inline-weight variant, in two
rounds (the variants forward, then backward). Each variant's state and
per-candidate costs must equal the plain sweep's to the bit. It prints the
resident blocks per SM of each variant, and the table's build time.

The inline-weight variant is the kernel's source with its table read
``__ldg(wk)`` replaced by the weight computed per (candidate, source, tap)
as the plain version computes it, ``wsp * exp(-dr^2 / (2 sigma_c^2))``,
with ``wsp`` read from the first ``nw`` floats of the table pointer and
``2 sigma_c^2`` a literal; it shows what the table saves.

``--old``: a per-candidate kernel built from the given file into the
package's build directory, e.g. the first kernel 4 (``git show
58b220f:scanner_colmap_tpu_torch/kernels/csrc/plane_cost.cu``):
``plane_cost_launch(ref, pack, kref, ksrc, R, t, valid, du, dv, wsp,
cand_d, cand_n, geom, depth, normal, cost, H, W, S, Hs, Ws, nw, R, two_sc2,
support, bad, update, stream)``, launched once per candidate on the
candidates materialised beforehand, ten launches in one graph, timed in
the same rounds; its state after the sweep must equal the plain sweep's.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from scanner_colmap_tpu_torch.kernels import _build, plane_cost as pc  # noqa: E402
from scanner_colmap_tpu_torch.ops import patch_match as pm_ops  # noqa: E402

SHAPES = (("coarse_192", 96, 96, 4, 1), ("fine_192", 160, 192, 4, 2),
          ("480px_8src", 384, 480, 8, 0))
RADIUS = 5
TABLE_READ = "const float w = __ldg(wk);"     # the tap loop's table read


def build(path, name, defines=()):
    """nvcc ``path`` into the package's (gitignored) build directory."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"exp_plane_cost_{name}.so")
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *[f"-D{d}" for d in defines],
                        "-o", out, path], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stderr)
    return ctypes.CDLL(out)


def build_inline():
    """The kernel with the tap weight computed inline (module docstring)."""
    with open(os.path.join(_build.CSRC_DIR, "plane_cost.cu")) as f:
        src = f.read()
    if src.count(TABLE_READ) != 1:
        raise RuntimeError("plane_cost.cu: the table read to replace is not there")
    two_sc2 = np.format_float_positional(np.float32(pc.color_denominator(0.2)))
    dr = "fsub(r, s_val[hc].z)"
    src = src.replace(TABLE_READ, f"const float w = fmul(__ldg(a.wtab + k), "
                                  f"expf(fdiv(-fmul({dr}, {dr}), {two_sc2}f)));")
    path = os.path.join(_build.BUILD_DIR, "exp_plane_cost_inline.cu")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with open(path, "w") as f:
        f.write(src)
    return build(path, "inline")


def with_lib(lib, fn):
    """fn() with the package's kernel-4 library replaced by ``lib``."""
    saved = _build._LIBS.get("plane_cost")
    _build._LIBS["plane_cost"] = pc._lib() if lib is None else lib
    try:
        if lib is not None:
            pc._lib()                   # its argument types
        return fn()
    finally:
        _build._LIBS["plane_cost"] = saved


def build_old(path):
    """The earlier per-candidate kernel's launch function."""
    fn = build(path, "old").plane_cost_launch
    fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [ctypes.c_float] * 3
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def old_sweep(fn, base, cands, state):
    """The earlier kernel: one update launch per materialised candidate."""
    ref, pack, k_ref, k_src, R, t, valid, taps = base
    H, W = ref.shape
    S, Hs, Ws, _ = pack.shape
    nw = len(taps.offsets)
    stream = torch.cuda.current_stream().cuda_stream
    for cd, cn in cands:
        _build.check(fn(ref.data_ptr(), pack.data_ptr(), k_ref.data_ptr(), k_src.data_ptr(),
                        R.data_ptr(), t.data_ptr(), valid.data_ptr(), taps.du.data_ptr(),
                        taps.dv.data_ptr(), taps.wsp.data_ptr(), cd.data_ptr(), cn.data_ptr(),
                        None, state[0].data_ptr(), state[1].data_ptr(), state[2].data_ptr(),
                        H, W, S, Hs, Ws, nw, taps.radius, pc.color_denominator(0.2),
                        float(np.float32(pc.SUPPORT_FRAC * nw)), 2.0, 1, stream), "old")


def shape_run(dev, label, H, W, S, seed, libs, reps, old_fn):
    prob, (d0, n0), (d1, n1) = chip_smoke.k4_problem(dev, H, W, S, seed)
    _, (d2, n2), _ = chip_smoke.k4_problem(dev, H, W, S, seed + 10)
    prep = pm_ops._prepare(prob, "field")
    taps = pc.window_taps(RADIUS, 1, 5.0, dev)
    base = (prep.ref, prep.pack, prep.k_ref, prep.k_src, prep.R, prep.t, prep.src_valid, taps)
    c0 = pc.plane_cost(*base, d0, n0)
    ed, en = torch.stack([d1, d2]), torch.stack([n1, n2])
    plain = [d0.clone(), n0.clone(), c0.clone()]
    plain_means = torch.empty((10, H, W), device=dev)
    pc.plane_cost_sweep_plain(*base, *plain, ed, en, means=plain_means)
    weights = pc.tap_weights(prep.ref, taps)
    table_ms = chip_smoke.cuda_ms(lambda: pc.tap_weights(prep.ref, taps), reps=reps, graph=True)

    # the inline variant reads wsp from the first nw floats of its table
    wsp_first = torch.zeros_like(weights)
    wsp_first.view(-1)[:len(taps.offsets)] = taps.wsp
    variants = {}
    for name, lib in libs.items():
        w = wsp_first if name.endswith("inline") else weights

        def run(state, means=None, lib=lib, w=w):
            with_lib(lib, lambda: pc.plane_cost_sweep(*base, *state, ed, en, weights=w,
                                                      means=means))
        variants[name] = (run, lib)
    if old_fn is not None:
        cands = [(torch.roll(d0, s, (0, 1)).contiguous(), torch.roll(n0, s, (0, 1)).contiguous())
                 for s in pc.SHIFTS] + [(d1, n1), (d2, n2)]
        variants["old_per_candidate"] = (
            lambda state, means=None: old_sweep(old_fn, base, cands, state), False)

    out = {"shape": [H, W, S, RADIUS], "table_build_ms": table_ms, "variants": {}}
    for name, (run, lib) in variants.items():
        state = [d0.clone(), n0.clone(), c0.clone()]
        ours = lib is not False
        means = torch.empty((10, H, W), device=dev) if ours else None
        run(state, means)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(state, plain))
        if ours:
            same = same and torch.equal(means, plain_means)
        out["variants"][name] = {"bitwise_plain": same, "ms": []}
        if ours:
            blocks, tile = with_lib(lib, lambda: pc.occupancy(taps))
            out["variants"][name].update(blocks_per_sm=blocks, tile=list(tile))
    order = list(variants)
    for names in (order, order[::-1]):
        for name in names:
            run = variants[name][0]
            state = [d0.clone(), n0.clone(), c0.clone()]
            out["variants"][name]["ms"].append(
                chip_smoke.cuda_ms(lambda: run(state), reps=reps, graph=True))
    for v in out["variants"].values():
        v["ms_per_candidate"] = [m / 10 for m in v["ms"]]
    nbytes, ops = chip_smoke.k4_bound(H, W, S, taps, H, W)
    out["bound_ms_per_candidate"] = chip_smoke.bound(nbytes, ops, chip_smoke.F32_FLOPS)[0] / 10
    print(f"{label}: " + json.dumps(out), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", help="an earlier per-candidate plane_cost.cu")
    ap.add_argument("--tiles", default="16x16,16x8,8x8")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("exp_plane_cost_cuda: needs a CUDA card")
    dev = torch.device("cuda:0")
    print(chip_smoke.gpu_line(), flush=True)
    pc._lib()
    print(_build.BUILD_INFO["plane_cost"]["ptxas"], flush=True)
    old_fn = build_old(args.old) if args.old else None
    src = os.path.join(_build.CSRC_DIR, "plane_cost.cu")
    libs = {}                           # None: the package's own build (16x16)
    for t in args.tiles.split(","):
        tw, th = (int(v) for v in t.split("x"))
        libs[f"{t}_table"] = (None if (tw, th) == (16, 16)
                              else build(src, t, (f"TILE_W={tw}", f"TILE_H={th}")))
    libs["16x16_inline"] = build_inline()
    res = {label: shape_run(dev, label, H, W, S, seed, libs, args.reps, old_fn)
           for label, H, W, S, seed in SHAPES}
    bad = [(k, n) for k, r in res.items() for n, v in r["variants"].items()
           if not v["bitwise_plain"]]
    if bad:
        raise SystemExit(f"not bitwise equal to the plain sweep: {bad}")


if __name__ == "__main__":
    main()
