"""Kernel 2 (``scanner_colmap_tpu_torch/kernels/csrc/schur.cu``) on one CUDA
card, at the main path's own inputs, beside earlier kernels.

    python tools/exp_schur_cuda.py [--atomics OLD.cu] [--tickets OLD.cu]
                                   [--splits 16,32,64]

It runs the bf16 slice of ``chip_smoke.py`` once (cold) and records the
inputs of every ``schur_accumulate`` call that mapping and the merge make.
On each recorded call it times the repository's kernel (its own plan;
through its wrapper, and launched bare) and each other kernel given, in
turns (A B .. B A), and prints per stage and shape the number of calls,
their live slots, the worst error against the f64 sum (over the norm of
the sum of the products' magnitudes), and the sum over the calls
of the time per call in a CUDA graph of 20 calls (the device's time) and
of one eager call (the host's launch included), both from
``chip_smoke.cuda_ms``. ``--splits`` adds the repository's kernel with
that many blocks per tile in place of its plan's (at most what one
cooperative launch may hold). Then the same at
``ba.synthetic_bundle``'s M=16, P=2048, T=16 and M=256, P=8192, T=16
(every slot live).

Other kernels, built from the given file into the package's build
directory:
  --atomics: the first port's kernel (``git show 37cf51a:scanner_colmap_tpu_
    torch/kernels/csrc/schur.cu``): ``schur_launch(cam, Wc, Vinv, P, T, M,
    S, stream)`` adding with atomics into a zeroed S;
  --tickets: a kernel that sums split tiles in clusters of 8 blocks and then
    by a ticket across clusters: ``schur_launch(cam, Wc, Vinv, P, T, M,
    windows, splits, S, ws, tickets, stream)``, splits a multiple of 8 up
    to 120, zeroed integer tickets.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from scanner_colmap_tpu_torch.kernels import _build, schur as sk  # noqa: E402
from scanner_colmap_tpu_torch.ops import ba  # noqa: E402

MC_TILE = (sk.WINDOW * sk.NUM_CAM_PARAMS) ** 2


def build(path, name):
    """nvcc ``path`` into the package's (gitignored) build directory."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"exp_{name}.so")
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out, path],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stderr)
    return ctypes.CDLL(out)


def atomics_call(lib):
    fn = lib.schur_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int

    def call(cam, Wc, Vinv, M):
        P, T = cam.shape
        S = torch.zeros((8 * M, 8 * M), device=Wc.device)
        _build.check(fn(cam.data_ptr(), Wc.data_ptr(), Vinv.data_ptr(), P, T, M,
                        S.data_ptr(), torch.cuda.current_stream().cuda_stream), "atomics")
        return S
    return call


def tickets_call(lib):
    fn = lib.schur_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    tickets = torch.zeros(120, dtype=torch.int32, device="cuda")

    def call(cam, Wc, Vinv, M):
        P, T = cam.shape
        windows = -(-M // sk.WINDOW)
        tiles = windows * (windows + 1) // 2
        clusters = min(120 // (tiles * 8), -(-P // 128))
        splits = clusters * 8 if clusters >= 1 else 1
        S = torch.empty((8 * M, 8 * M), device=Wc.device)
        ws = torch.empty(tiles * clusters * MC_TILE if clusters > 1 else 0, device=Wc.device)
        _build.check(fn(cam.data_ptr(), Wc.data_ptr(), Vinv.data_ptr(), P, T, M, windows,
                        splits, S.data_ptr(), ws.data_ptr(), tickets.data_ptr(),
                        torch.cuda.current_stream().cuda_stream), "tickets")
        return S
    return call


def splits_call(splits=None):
    """The repository's kernel launched without the wrapper's checks, with
    ``splits`` blocks per tile (at most what the launch may hold), or its
    plan's."""
    def call(cam, Wc, Vinv, M):
        P, T = cam.shape
        windows, tiles, n = sk.launch_plan(M, P)
        n = n if splits is None else min(splits, sk.MAX_SPLIT_BLOCKS // tiles)
        S = torch.empty((8 * M, 8 * M), device=Wc.device)
        ws = torch.empty(tiles * n * MC_TILE if n > 1 else 0, device=Wc.device)
        _build.check(sk._lib().schur_launch(
            cam.data_ptr(), Wc.data_ptr(), Vinv.data_ptr(), P, T, M, windows, max(n, 1),
            S.data_ptr(), ws.data_ptr(), torch.cuda.current_stream().cuda_stream), "schur")
        return S
    return call


def times(variants, cam, Wc, Vinv, M):
    """{name: (ms in a graph of 20, eager ms)}, each the mean of two turns."""
    order = list(variants.items())
    out = {name: [0.0, 0.0] for name in variants}
    for name, fn in order + order[::-1]:
        run = lambda: fn(cam, Wc, Vinv, M)  # noqa: E731
        out[name][0] += chip_smoke.cuda_ms(run, graph=True, calls=20) / 2
        out[name][1] += chip_smoke.cuda_ms(run) / 2
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--atomics")
    ap.add_argument("--tickets")
    ap.add_argument("--splits", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("exp_schur_cuda: needs a CUDA card")
    from scanner_colmap_tpu_torch import device as devlib
    from scanner_colmap_tpu_torch.pipeline import synth

    print(chip_smoke.gpu_line())
    devlib.setup_numerics()
    dev = torch.device("cuda:0")
    variants = {"current": sk.schur_accumulate, "current, bare launch": splits_call()}
    if args.atomics:
        variants["atomics"] = atomics_call(build(args.atomics, "atomics"))
    if args.tickets:
        variants["tickets"] = tickets_call(build(args.tickets, "tickets"))
    for n in filter(None, args.splits.split(",")):
        variants[f"splits={n}"] = splits_call(int(n))

    frames, gt = synth.render_dataset(num_images=16, width=480, height=360,
                                      num_blobs=500, seed=3)
    calls = []
    with tempfile.TemporaryDirectory(prefix="exp_schur_") as root:
        chip_smoke.run_slice(dev, frames, gt, root, "bf16", record=calls)
    groups = {}
    for stage, inputs in calls:
        cam, _, _, M = inputs
        groups.setdefault(f"{stage} M={M} P={cam.shape[0]} T={cam.shape[1]}", []).append(inputs)
    for M, P, T, seed in ((16, 2048, 16, 0), (256, 8192, 16, 1)):
        p, o, c = ba.synthetic_bundle(M=M, P=P, T=T, seed=seed, device=dev)
        groups[f"synthetic M={M} P={P} T={T}"] = [(*ba.schur_inputs(p, o, c), M)]

    for stage, inputs in groups.items():
        tot = {name: [0.0, 0.0] for name in variants}
        worst, shapes, live = 0.0, set(), []
        for cam, Wc, Vinv, M in inputs:
            R = sk.schur_accumulate_plain(cam, Wc.double(), Vinv.double(), M)
            terms = sk.schur_accumulate_plain(cam, Wc.double().abs(), Vinv.double().abs(), M)
            for name, fn in variants.items():
                S, again = fn(cam, Wc, Vinv, M), fn(cam, Wc, Vinv, M)
                worst = max(worst, ((S.double() - R).norm() / terms.norm()).item())
                if name != "atomics" and not torch.equal(S, again):
                    raise AssertionError(f"{name} is not bitwise reproducible ({stage})")
            for name, (g, e) in times(variants, cam, Wc, Vinv, M).items():
                tot[name][0] += g
                tot[name][1] += e
            shapes.add((M, *cam.shape, sk.launch_plan(M, cam.shape[0])[2]))
            lv = (Wc != 0).flatten(2).any(-1).sum(1)
            live.append((lv > 0).float().mean().item())
        print(f"{stage}: {len(inputs)} calls, (M, P, T, splits) {sorted(shapes)}, points "
              f"with a live slot {min(live):.3f}-{max(live):.3f}, worst error against "
              f"the f64 sum over the norm of the summed magnitudes {worst:.3g}; sum of ms "
              f"per call in a graph of 20 / eager:", flush=True)
        for name, (g, e) in tot.items():
            print(f"  {name}: {g:.4f} / {e:.4f}")


if __name__ == "__main__":
    main()
