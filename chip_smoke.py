"""Smoke run of the torch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; there is no CPU path):
  0 device: require CUDA, print the card's name and power limit
  1 build: compile the four hand-written kernels from csrc/ with nvcc, one
    nvcc per source, all started together
  2 kernel 1 (bf16 pair matcher, wgmma) against its plain version at the
    slice's shape (16 images, K=640, the 75 pairs of overlap 6) and at the
    reference capacity (K=8192, 32 pairs), timed beside its bound and its
    library route (bf16 torch.bmm, then topk and max)
  3 kernel 2 (Schur accumulation) against its plain version at M=16, P=2048,
    T=16 and at M=256, P=8192, T=16 (every slot live), and, after phase 6,
    at the main path's own inputs: the bf16 slice's merged model packed as
    the merge's global BA packs it, and every call that mapping and the
    merge made in the bf16 slice's cold pass (recorded); two runs must be
    bitwise equal; timed by graph replay of one call, per call in a graph
    of 20, and eagerly (host launch included), beside its bound
  4 kernel 3 (f32 top-2 matcher, both directions in one launch) against its
    plain version at the slice's shape and at K=8192 with 32 pairs: its
    reverse argbest must equal the plain version's and its own swapped
    launch's exactly, and two runs must be bitwise equal; timed beside its
    bound and its library route (f32 torch.bmm with TF32 off, then topk
    and max)
  5 the sparse slice: bench.py's configuration (16 synthetic 480x360
    images, cluster_size 12, so two clusters, loop closure at its default
    "auto") through prepare_images -> run_extraction -> run_matching ->
    run_mapping -> run_merge, once at bf16 (resident plan, kernel 1) and
    once at f32 (banked plan, kernel 3 once per bank), each with one cold
    and one warm (timed) pass; the warm pass is the main path and carries
    the launch counts, printed per stage with the correspondence graph the
    mapper took; the probe (on its host thread, over all 16 images) must
    decide without an error and keep closure off on this straight set, and
    the warm model must equal the cold one bitwise; then one more matching
    pass under torch.profiler gives the device kernels per verified pair,
    and its candidates are verified again in the stage's chunk (with the
    peak memory of verification), in chunks of 8, and 8 of them each as the
    only live pair of a padded call: every table row must be bitwise equal;
    and 8 pairs of 32768 correspondences (COLMAP's max_num_matches) are
    verified in one chunk, with the peak memory of verification
  6 extra matching passes: bf16 banked == resident on the card, and
    guided matching + multiple models (f32) through mapping and merge
  7 loop closure: a 48-image out-and-back set at bench's configuration,
    five stages with closure on (auto, bf16 resident: kernel 1 on the loop
    candidates), then mapping and merge on its window pairs alone (the
    table closure off writes: every pair's draws are keyed by its rows);
    verified pairs past the window on the mirror band, registered count and
    ATE against the run without closure; f32 matching of the loop
    candidates alone on the same extraction (window 0, the separation
    pinned: kernel 3 on the loop mini-banks only, the same candidates); and
    the merge again with its solves on the CG path
  8 the host mapper: bench's set with mapper.mode="host" (kernel 2 in its
    local and global BA), then device mode with every cluster retried on
    the host mapper
  9 the CG solver at scale on ops/ba.synthetic_bundle: dense against CG at
    M=256, P=49152, T=4; CG at M=1024, P=49152, T=4 and at M=2048,
    P=131072, T=12, with ms per LM iteration, ms per CG matvec and its
    split (torch.profiler over one trial; the phase fails if the profiler
    sees no device time), the working set's bound and the peak memory;
    every solve twice, bitwise equal
  10 the command line at full width: bench.py's scale section (200 synthetic
    480x360 images, 500 blobs, seed 7, the headline configuration) through
    ``python3 -m scanner_colmap_tpu_torch.pipeline.cli all --sparse_only``
    in a subprocess (on a directory of JPEGs where PIL imports, else on a
    store whose frames table was written in memory, with --resume); the
    model read back with load_model must register >= 198 of 200 at an ATE
    of at most 0.5% of the camera span; the stage times, launches and
    peaks come from the run's metrics.json, and one more matching pass
    under torch.profiler gives the device kernels per verified pair and
    the peak memory of verification
  11 real texture (bench.py's set: 10 images at 480x400 of a photograph on
    a relief, seed 1, two bumps, exposure jitter 0.2, noise 2.0) through the
    command line, where PIL imports on the card: >= 9/10 registered, ATE
    below 0.12, mean reprojection below 1.5 px, focal error below 0.05;
    phases 11 and 12 need Pillow (they fail without it)
  12 the dense path: kernel 4 (PatchMatch's plane cost and Jacobi sweep)
    against its plain version at the coarse (96x96) and fine (160x192)
    shapes of the 192-px / 4-source configuration and at 480x384 with 8
    sources: the initial pass's cost, the tap-weight table and one sweep
    (ten candidates: the state after it and each candidate's cost) bitwise
    equal to the plain version's, two sweeps bitwise equal; one sweep call
    timed by graph replay (per sweep and per candidate) beside its bound,
    the plain sweep's time, the device launches per sweep call and the
    resident blocks per SM. Then bench.py's dense section (bench.py:455-516:
    192 px, overlap 4, 7 sweeps) on the bf16 slice's store: prepare,
    patch_match cold and warm (the main path; the warm maps bitwise the
    cold ones, kernel 4 called once per initial pass and once per sweep),
    one profiled pass (device kernels and kernel 4's device time per depth
    map), fusion (exactly the fused count the per-candidate kernel gave),
    the same maps through f16 (the fused count within 1%), meshing; a
    geometric-consistency pass; bench.py's reference-resolution section
    (bench.py:518-555: 480 px, 8 sources) with one map solved in row bands
    against its untiled map; these in-memory frames (lossless, the exact
    focal) carry the pins, not the band. Then
    ``cli undistort`` and ``cli all --resume`` (the dense stages at
    PipelineConfig()'s 400 px and 5 sources) on phase 11's store: surface
    median <= 0.05, fused points and faces > 0. Last, the band's own
    input: the same 16 images as JPEGs from ``generate_dataset`` (quality
    95, EXIF focal) through prepare_images from the files, the sparse
    stages and the three dense sections, held to the JAX package's band
    (tools/exp_dense_band_jax.py, measured on that JPEG set): median <=
    1.25x the band's + 0.005, fused >= 0.8x the band's, the mesh's median
    likewise
  13 the scale-out layer (``parallel/*``). (a) World 1 on NCCL in this
    process: the sharded BA bitwise ``bundle_adjust`` at M=256, P=8192,
    T=16 (dense) and M=1024, P=49152, T=4 (CG), 8 LM iterations each; the
    fused step (ring halo, the block's windows as one kernel-1 launch, the
    sharded BA) on the bf16 slice's extraction with overlap 6, its matches
    equal to kernel 1's resident plan pair by pair; the multi-host stages
    on bench's 16-image set (extraction, matching, host mapping, merge,
    PatchMatch at 192 px) and the 48-image loop set's f32 matching with
    closure on. (b) Two gloo ranks as subprocesses of this script
    (``--scaleout-rank``), both on cuda:0: the same BA (ranks bitwise
    equal, final cost within 1e-5 of world 1), the dense one padded with
    invalid points to twice its size (rank 1's shard all padding; world
    1's solve bitwise), the same step (matches world 1's), the same stages
    (extraction, matching, mapping and depth-map tables bitwise world 1's,
    the merge >= 15/16 at ATE <= 0.012) and the loop set (no pair twice,
    the table world 1's). On each of these paths, in this process and in
    each rank, ``KernelTap`` keeps the kernel calls the path made (every
    call of kernels 1-3, the first of each shape of kernel 4's) and holds
    them against the plain versions after the launches are read. A rank
    that exits non-zero fails the run
  14 the options: the batched mapper (kernel 2 over a lane axis) against
    per-cluster mode on phase 10's and phase 7's stores, the connectivity
    schedule, an APNG of the slice through the command line, uncalibrated
    two-view
  15 batched extraction on phase 10's 200-image store: run_extraction at
    batch_size 1, 4 and 8, one profiled pass of each over 17 of the images
    (device kernels and device ms per image), three warm passes of each in
    turns, every table bitwise the batch-1 table (as is phase 10's, made in
    batches of 4 by the command line); one batch of 4 canvases at 2048 px
    with 8192 features: its peak allocated memory, and each image bitwise
    its features alone
Each phase prints its wall time. The second-to-last line is the card's
name and power limit, the line before it a JSON summary of the kernels
(with each kernel's launches on every path that carries it), the last line
the result.
Bounds: the larger of the bytes each input read once and each output
written once over 3.35 TB/s, and the operations over the H100 SXM peak for
their type (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s f32 without); for
kernel 4 the operations its in-image taps need (``k4_bound``).
"""

import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

K1_AGREE = 0.999      # share of rows with identical decisions
K1_NEAR_TIE = 1e-5    # every disagreement must be a near-tie this close
K1_MAX_ABS = 1e-5     # best and second on the scale-out paths' calls (phase 2: <= 6e-7)
K2_REL_FROB = 1e-5    # relative Frobenius error of S
K2_REL_TERMS = 1e-6   # error of S against its f64 sum over |sum of |products||
K2_CALLS_PER_GRAPH = 20
K2_LIBRARY_NOTE = ("no single PyTorch call computes S: index_add_ of the 8x8 "
                   "blocks needs them built first, T^2 per point")
K3_AGREE = 0.999      # kernel 3: the same decision and near-tie rules
K3_MAX_ABS = 1e-5     # best and second

HBM_BYTES_PER_S = 3.35e12   # H100 SXM peaks (NVIDIA's data sheet, 700 W)
BF16_TC_FLOPS = 989e12
F32_FLOPS = 67e12
LIBRARY_CHUNK = 8           # pairs per library-route call, as the plain versions

SLICE_MIN_REGISTERED = 15
SLICE_MAX_ATE = 0.012
SLICE_SUBMODELS = 2
GUIDED_MIN_ROWS = 75

LOOP_IMAGES = 48
LOOP_FAR = 12               # |a - b| past which a verified pair closes a loop
LOOP_MIN_FAR_PAIRS = 5
LOOP_MIRROR_BAND = 10       # |a + b - 48| below this: on the out-and-back mirror
# tests/test_loop_closure.py holds 24 images to 0.9 on |a + b - 24| < 10; at
# 48 images the JAX package itself gives 0.888 (87 of 98 far pairs, CPU,
# tools/exp_loop_band_jax.py), so the port is held to that band less 0.04
LOOP_MIRROR_FRAC = 0.85
LOOP_MIN_REGISTERED = 47
LOOP_ATE_FACTOR = 1.3       # closure's ATE <= 1.3x no closure's + 1e-4
CG_MERGE_MAX_IMAGES = 32    # below the loop set's 48: the merge's solves take CG
CG_MERGE_ATE_FACTOR = 1.2

CG_SCALE_DENSE_GAP = 1.02   # CG final cost <= 1.02x dense (__graft_entry__.py:159)

VERIFY_SAMPLE = 8           # pairs verified alone in the chunk check
CAPACITY_MATCHES = 32768    # COLMAP's max_num_matches (colmap.proto:17)
CAPACITY_PAIRS = 8

SCALE_IMAGES = 200          # bench.py:671-725, BENCH_SCALE's default
SCALE_MIN_REGISTERED = 198
SCALE_MAX_ATE_SPAN = 0.005  # BENCH_r05: 0.071% at 200; ATE_BAND_r05 at 1k: median 0.449%
CLI_TIMEOUT_S = 420

# kernel 4: both routes round every operation alike, so they are held to the
# bit; a sweep evaluates K4_CANDIDATES candidate fields
K4_CANDIDATES = 10             # 8 shifted neighbours, then K4_EXTRA given fields
K4_EXTRA = 2                   # the perturbation and the fresh sample
K4_OPS_PER_TAP = 9             # the tap's weight: difference, square, divide, exp, scale
K4_OPS_PER_TAP_SOURCE = 50     # the tap's warp through p's plane, correction, moments
K4_OPS_PER_PIXEL_SOURCE = 50   # the center warp and the NCC finish
K4_LIBRARY_NOTE = "no single PyTorch call computes a bilateral-NCC plane cost"
K4_DEVICE_LAUNCHES = 2         # a wrapper call: the cost pass, then the finish
K4_PROFILE_PAD_S = 0.25        # idle seconds around one profiled sweep call
K4_LEVELS = 2                  # per depth map: a coarse and a fine PatchMatch, one
                               #   tap-weight table each

# phase 12's bands: the JAX package's dense stages on the CPU on bench's
# 16-image set as JPEGs at 192 px / 4 sources / 7 sweeps
# (tools/exp_dense_band_jax.py); dense_band_phase holds the port to them on
# that same input
DENSE_BAND = {"median": 0.07918911462047129, "p90": 0.10423966956826528,
              "fused": 92282, "mesh_median": 0.08304569775727527}
DENSE_BANDS = {"192": DENSE_BAND,       # with the geometric pass (--geom), at 480 px (--hires):
               "geom": {"median": 0.08001119142778679, "fused": 95537},
               "hires": {"median": 0.07939681274519012, "fused": 553638}}
DENSE_MEDIAN_FACTOR = 1.25     # median <= 1.25x the band's + 0.005
DENSE_MEDIAN_SLACK = 0.005
DENSE_FUSED_FRAC = 0.8         # fused points >= 0.8x the band's
F16_FUSED_TOL = 0.01           # f32 maps and the same maps through f16
# the fused counts on this set (bitwise the same in every run); a sweep's
# update is the per-candidate loop's to the bit
# (tests/test_torch_plane_cost_sweep.py), so they move only with the sparse
# model the dense stages start from: the per-candidate kernel gave 90176,
# 95677 and 562755 on the model before the mapper's lane code
DENSE_FUSED_PINNED = {"192": 90627, "geom": 96172, "hires": 563885}
DENSE_TILE_ROWS = 128          # one 480-px map in bands of 128 rows (+ 2 x 48 halo)
DENSE_TILE_MAX_DIFF = 0.02     # median relative depth difference to its untiled map
# the reference's recorded band on real data (PERFORMANCE.md:111: 1.0-4.8%)
REAL_DENSE_MAX_MEDIAN = 0.05

# tests/test_real_texture.py's bars (BENCH_r05: 10/10, ATE 0.0048, focal 0.0157)
REAL_IMAGES = 10
REAL_MIN_REGISTERED = 9
REAL_MAX_ATE = 0.12
REAL_MAX_REPROJ_PX = 1.5
REAL_MAX_FOCAL_ERR = 0.05

# phase 14: a cluster's registered count, batched against per-cluster mode
# (before any host retry); their arithmetic differs in the order of a few
# sums (kernel 2's split, batched factorizations), so RANSAC and the
# reprojection gates may decide one image apart
OPTIONS_CLUSTER_SLACK = 1
OPTIONS_TIMED_RUNS = 3         # warm mapping passes of each mode on the loop set, in turns
UNCAL_MIN_INLIERS = 15         # matching.min_num_inliers' default


def log(msg):
    print(msg, flush=True)


def gpu_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes, flops, peak):
    """(bound_ms, bound_by): the least time the card could take."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def yardsticks(ms, nbytes, flops, peak, library_ms):
    b, by = bound(nbytes, flops, peak)
    return {"bound_ms": b, "bound_by": by, "share_of_bound": b / ms,
            "library_ms": library_ms}


def library_top2(pool, ai, bi):
    """The library route of kernels 1 and 3, timed as a yardstick and used
    nowhere in the port: torch.bmm of each chunk's operands in their own
    dtype, then topk(2) over columns and max over rows."""
    for s in range(0, ai.shape[0], LIBRARY_CHUNK):
        a = pool[ai[s:s + LIBRARY_CHUNK].long()]
        b = pool[bi[s:s + LIBRARY_CHUNK].long()]
        sim = torch.bmm(a, b.transpose(1, 2))
        sim.topk(2, dim=-1)
        sim.max(dim=-2)


def cuda_ms(fn, reps=10, graph=False, calls=1):
    """Median milliseconds of one fn() on the card (CUDA events, warmed up).

    graph=False times an eager call, host launch gaps included. graph=True
    captures ``calls`` calls of fn() in a CUDA graph and times its replays,
    divided by ``calls`` (kernels and library routes; the plain versions run
    eagerly). With calls=1 the time still holds the graph's own launch, which
    matters only for calls of a few microseconds; a graph of many calls gives
    the device's time per call back to back."""
    fn()
    torch.cuda.synchronize()
    run = fn
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
        run = g.replay
        run()
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / (calls if graph else 1))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# the kernel calls a path makes, kept for replay against the plain versions
# ---------------------------------------------------------------------------

def _clone(x):
    """Tensors cloned through plain tuples, lists and dicts."""
    if type(x) in (tuple, list):
        return type(x)(_clone(v) for v in x)
    if type(x) is dict:
        return {k: _clone(v) for k, v in x.items()}
    return x.clone() if isinstance(x, torch.Tensor) else x


class _Module:
    """A module seen through a few replaced attributes."""

    def __init__(self, module, **attrs):
        self._module = module
        self.__dict__.update(attrs)

    def __getattr__(self, name):
        return getattr(self._module, name)


def tapped_path(fn, label):
    """fn() run as one path: (its result, the kernels' launches in it, and
    the replay of its kernel calls against the plain versions, made after
    the launches were read)."""
    from scanner_colmap_tpu_torch import kernels

    kernels.reset_launch_counts()
    with KernelTap() as tap:
        res = fn()
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    return res, counts, tap.replay(label, counts)


class KernelTap:
    """While open (``with``), keeps the kernel calls a path makes, taken at
    the wrappers' call sites (``ops.matching``, ``ops.ba``, and
    ``ops.patch_match``'s ``pc``): every call of kernels 1-3 and the first
    of each input shape of kernel 4's initial pass and sweep (its plain
    sweep takes over a second), with the inputs cloned before the call and
    the outputs (a sweep: its state) after. The wrappers launch and count
    as before. ``replay`` holds each kept call's outputs against the plain
    version on its inputs, and launches no kernel."""

    def __init__(self, check_schur_now=False):
        """check_schur_now: check each kernel-2 call when it is made
        (``schur_call_check``, and bitwise against a rerun whose launch is
        not counted) and keep only the result, not the tensors: for paths
        with thousands of batched calls."""
        self.calls = {"pair_match": [], "top2": [], "schur": [], "plane_cost": []}
        self.checked = []
        self.check_schur_now = check_schur_now
        self._undo = []

    def _wrap(self, name, fn, first_per_shape=False, state=()):
        seen = set()

        def tapped(*args, **kw):
            shape = (fn.__name__,) + tuple(tuple(a.shape) for a in args
                                           if isinstance(a, torch.Tensor))
            if name == "schur" and self.check_schur_now:
                out = fn(*args, **kw)
                n = fn.launches
                again = fn(*args, **kw)
                fn.launches = n
                self.checked.append((str(list(shape[1:3])), torch.equal(out, again),
                                     *schur_call_check(args, out)))
                return out
            keep = not first_per_shape or shape not in seen
            seen.add(shape)
            if keep:
                inputs = (_clone(args), _clone(kw))
            out = fn(*args, **kw)
            if keep:
                self.calls[name].append((fn.__name__, *inputs,
                                         _clone([args[i] for i in state] if state else out)))
            return out

        return tapped

    def __enter__(self):
        from scanner_colmap_tpu_torch.kernels import plane_cost as pc
        from scanner_colmap_tpu_torch.ops import ba, matching, patch_match

        k4 = _Module(pc, plane_cost=self._wrap("plane_cost", pc.plane_cost, True),
                     plane_cost_sweep=self._wrap("plane_cost", pc.plane_cost_sweep, True,
                                                 state=(8, 9, 10)))
        for mod, attr, new in ((matching, "pair_match", self._wrap("pair_match",
                                                                   matching.pair_match)),
                               (matching, "top2_bank", self._wrap("top2", matching.top2_bank)),
                               (ba, "schur_accumulate", self._wrap("schur",
                                                                   ba.schur_accumulate)),
                               (patch_match, "pc", k4)):
            self._undo.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, new)
        return self

    def __exit__(self, *exc):
        for mod, attr, old in reversed(self._undo):
            setattr(mod, attr, old)
        self._undo.clear()

    def replay(self, path, launches):
        """{kernel: what its kept calls show} for one path whose wrapper
        counts were ``launches``. Kernels 1 and 3: the decisions of every
        row agree with the plain version's but near-ties (the rules and
        bars of phases 2 and 4), best and second within K1_MAX_ABS /
        K3_MAX_ABS, kernel 3's reverse argbest equal. Kernel 2: S within
        K2_REL_TERMS of the f64 sum (phase 3's bar), and exactly the plain
        version's zeros on a shard of padding. Kernel 4: bitwise. Raises if
        one disagrees, or a kernel launched on the path left no call."""
        from scanner_colmap_tpu_torch.kernels import pair_match as k1
        from scanner_colmap_tpu_torch.kernels import plane_cost as pc
        from scanner_colmap_tpu_torch.kernels import top2 as k3
        from scanner_colmap_tpu_torch.ops import matching

        out, bad = {}, []
        if self.checked:
            shapes = sorted({c[0] for c in self.checked})
            out["schur"] = {"calls": len(self.checked), "checked_when_made": True,
                            "lanes": sum(c[5] for c in self.checked),
                            "batched_calls": sum(c[6] for c in self.checked),
                            "max_abs_err": max(c[2] for c in self.checked),
                            "max_abs_S": max(c[8] for c in self.checked),
                            "worst_err_terms": max(c[3] for c in self.checked),
                            "padding_lanes": sum(c[4] for c in self.checked),
                            "rerun_bitwise": all(c[1] for c in self.checked),
                            "shapes": shapes[:8]}
            bad += [f"schur call {i} (checked when made)" for i, c in enumerate(self.checked)
                    if not (c[1] and c[7])]
        for name, calls in self.calls.items():
            if launches[name] and not calls and not (name == "schur" and self.checked):
                bad.append(f"{name}: launched {launches[name]} times, no call kept")
            if not calls:
                continue
            r = {"calls": len(calls), "max_abs_err": 0.0, "shapes": sorted(
                {str([list(a.shape) for a in args if isinstance(a, torch.Tensor)][:2])
                 for _, args, _, _ in calls})[:8]}
            for i, (fname, args, kw, got) in enumerate(calls):
                if name in ("pair_match", "top2"):
                    pool, vb, ai, bi = args
                    plain = (k1.pair_match_plain if name == "pair_match"
                             else k3.top2_bank_plain)(pool, vb, ai, bi)
                    d_k, d_p = matching.decide(*got), matching.decide(*plain)
                    err = max((got[j] - plain[j]).abs().max().item() for j in (0, 1))
                    diff = (d_k != d_p).nonzero()
                    far = _far_from_ties(plain[:3], lambda p, c: pool[ai[p].long()].float()
                                         @ pool[bi[p].long(), c].float(), diff, K1_NEAR_TIE)
                    agree = 1.0 - len(diff) / d_k.numel()
                    rev = torch.equal(got[3], plain[3])
                    r["min_agree"] = min(r.get("min_agree", 1.0), agree)
                    r["decisions_differ"] = r.get("decisions_differ", 0) + len(diff)
                    ok = agree >= K1_AGREE and not far and err <= (
                        K1_MAX_ABS if name == "pair_match" else K3_MAX_ABS)
                    if name == "top2":
                        r["rev_equal"] = r.get("rev_equal", True) and rev
                        ok = ok and rev
                elif name == "schur":
                    err, rel, pad, _, _, ok, _ = schur_call_check(args, got)
                    r["padding_calls"] = r.get("padding_calls", 0) + pad
                    r["worst_err_terms"] = max(r.get("worst_err_terms", 0.0), rel)
                else:
                    if fname == "plane_cost":
                        plain = pc.plane_cost_plain(*args, **kw)
                        pairs = [(got, plain)]
                    else:
                        args = list(args)
                        args[8:11] = [a.clone() for a in args[8:11]]
                        pc.plane_cost_sweep_plain(*args, **kw)
                        pairs = list(zip(got, args[8:11]))
                    err = max((a - b).abs().max().item() for a, b in pairs)
                    ok = all(torch.equal(a, b) for a, b in pairs)
                r["max_abs_err"] = max(r["max_abs_err"], err)
                if not ok:
                    bad.append(f"{name} call {i} ({fname})")
            out[name] = r
        log(f"kernel replay {path}: " + json.dumps(out))
        if bad:
            raise AssertionError(f"on {path} a kernel disagrees with its plain "
                                 f"version: {bad[:10]}")
        return out


def schur_call_check(args, got):
    """Kernel 2's output ``got`` for ``args`` = (cam_idx, Wc, Vinv, M), one
    problem or a lane axis, against the plain version lane by lane: S within
    K2_REL_TERMS of the f64 sum relative to the norm of the summed
    magnitudes (phase 3's bar), and exactly the plain version's zeros on a
    lane or shard of padding. Returns (max abs error, worst relative error,
    padding lanes, lanes, batched (0/1), ok, max |S|: the scale of the
    error; a lane's solve may hold far-off points whose S is large)."""
    from scanner_colmap_tpu_torch.kernels import schur as sk

    cam_idx, Wc, Vinv, M = args
    batched = cam_idx.dim() == 3
    lanes = list(zip(cam_idx, Wc, Vinv, got)) if batched else [(cam_idx, Wc, Vinv, got)]
    err, worst, pad, ok, mag = 0.0, 0.0, 0, True, 0.0
    for c, w, v, g in lanes:
        plain = sk.schur_accumulate_plain(c, w, v, M)
        err = max(err, (g - plain).abs().max().item())
        mag = max(mag, plain.abs().max().item())
        terms = sk.schur_accumulate_plain(c, w.double().abs(), v.double().abs(), M).norm().item()
        if terms == 0.0:
            pad += 1
            ok = ok and torch.equal(g, plain) and not g.any()
        else:
            R64 = sk.schur_accumulate_plain(c, w.double(), v.double(), M)
            rel = (g.double() - R64).norm().item() / terms
            worst = max(worst, rel)
            ok = ok and rel <= K2_REL_TERMS
    return err, worst, pad, len(lanes), int(batched), ok, mag


# ---------------------------------------------------------------------------
# phase 2: kernel 1
# ---------------------------------------------------------------------------

def _pool(n_img, K, seed, dev, precision="bf16"):
    """Descriptors of overlapping views of one 'world': image i sees a
    window of world descriptors shifted by i, with noise, so consecutive
    images share true matches; ragged validity with zero padding.
    Normalized for ``precision``'s kernel (bf16: kernel 1, f32: kernel 3)."""
    g = np.random.default_rng(seed)
    world = g.integers(0, 160, (K + 48 * n_img, 128)).astype(np.float32)
    D = np.zeros((n_img, K, 128), np.float32)
    V = np.zeros((n_img, K), bool)
    for i in range(n_img):
        rows = world[48 * i: 48 * i + K][g.permutation(K)]
        D[i] = np.clip(rows + g.normal(0, 6.0, rows.shape), 0, 255)
        n = int(g.integers(int(0.8 * K), K + 1))
        V[i, :n] = True
        D[i, n:] = 0
    from scanner_colmap_tpu_torch.ops import matching
    pool = matching.normalize_bank(torch.as_tensor(D.astype(np.uint8), device=dev),
                                   precision)
    return pool, torch.as_tensor(V, device=dev)


def _far_from_ties(ref, ref_rev_col, bad, near_tie):
    """How many disagreeing rows are NOT near-ties: of best vs second, of a
    test's margin, or of two candidate rows for the cross check.
    ``ref`` = (best, second, argbest) of the plain version; ref_rev_col(p, c)
    gives column c's similarities over the rows of pair p's first image."""
    far = 0
    for p, r in bad.tolist()[:2000]:
        b, s = ref[0][p, r].item(), ref[1][p, r].item()
        dist, dist2 = np.arccos(np.clip([b, s], -1, 1))
        margins = [abs(b - s), abs(dist - 0.7), abs(dist - 0.8 * dist2)]
        top2 = torch.topk(ref_rev_col(p, int(ref[2][p, r])), 2).values
        margins.append((top2[0] - top2[1]).item())
        if min(margins) >= near_tie:
            far += 1
    return far


def check_kernel1(dev, n_img, K, pairs, seed):
    from scanner_colmap_tpu_torch.kernels import pair_match as pm
    from scanner_colmap_tpu_torch.ops import matching

    pool, valid = _pool(n_img, K, seed, dev)
    vb = valid.float()
    ab = torch.as_tensor(np.asarray(pairs, np.int32), device=dev)
    ai, bi = ab[:, 0].contiguous(), ab[:, 1].contiguous()
    out = pm.pair_match(pool, vb, ai, bi)
    ref = pm.pair_match_plain(pool, vb, ai, bi)
    torch.cuda.synchronize()
    d_k = matching.decide(*out)
    d_p = matching.decide(*ref)
    agree = (d_k == d_p).float().mean().item()
    err = max((out[0] - ref[0]).abs().max().item(),
              (out[1] - ref[1]).abs().max().item())
    bad = (d_k != d_p).nonzero()
    far = _far_from_ties(ref, lambda p, c: pool[ai[p].long()].float()
                         @ pool[bi[p].long(), c].float(), bad, K1_NEAR_TIE)
    ms = cuda_ms(lambda: pm.pair_match(pool, vb, ai, bi), graph=True)
    plain_ms = cuda_ms(lambda: pm.pair_match_plain(pool, vb, ai, bi), reps=3)
    library_ms = cuda_ms(lambda: library_top2(pool, ai, bi), reps=3, graph=True)
    NP = len(pairs)
    flops = 2 * NP * K * K * 128
    nbytes = (pool.numel() * 2 + vb.numel() * 4 + 2 * NP * 4
              + NP * K * (4 + 4 + 4 + 8))         # best, second, idx, column key
    y = yardsticks(ms, nbytes, flops, BF16_TC_FLOPS, library_ms)
    log(f"kernel1 K={K} pairs={NP}: decisions agree {agree:.6f}, "
        f"{len(bad)} differ ({far} not near-ties), max |best/second err| "
        f"{err:.3g}, kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
        f"{plain_ms:.3f} ms, library {library_ms:.4f} ms, bound "
        f"{y['bound_ms']:.4f} ms ({y['bound_by']}), share of bound "
        f"{y['share_of_bound']:.4f}")
    if agree < K1_AGREE or far:
        raise AssertionError(f"kernel 1 disagrees with its plain version at K={K}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **y}


# ---------------------------------------------------------------------------
# phase 3: kernel 2
# ---------------------------------------------------------------------------

def _kernel2_measure(cam_idx, Wc, Vinv, M, one_call_replay=True):
    """Kernel 2 against its plain version on one set of inputs: relative
    Frobenius error, two runs bitwise equal, times, bound."""
    from scanner_colmap_tpu_torch.kernels import schur as sk

    call = lambda: sk.schur_accumulate(cam_idx, Wc, Vinv, M)  # noqa: E731
    S, S_again = call(), call()
    R = sk.schur_accumulate_plain(cam_idx, Wc, Vinv, M)
    # the f64 sum, and the norm of the sum of the products' magnitudes
    # (the scale of any f32 summation's rounding error)
    R64 = sk.schur_accumulate_plain(cam_idx, Wc.double(), Vinv.double(), M)
    terms = sk.schur_accumulate_plain(cam_idx, Wc.double().abs(), Vinv.double().abs(),
                                      M).norm().item()
    torch.cuda.synchronize()
    # per point with L live slots: Wc[t] Vinv (8x3x3) for each, then
    # (Wc Vinv)[t1] Wc[t2]^T (8x3x8) for each pair, in f32
    live = (Wc != 0).flatten(2).any(-1).sum(1).double()
    flops = 2 * (72 * live + 192 * live * live).sum().item()
    nbytes = (cam_idx.numel() * 4 + Wc.numel() * 4 + Vinv.numel() * 4
              + S.numel() * 4)
    b, by = bound(nbytes, flops, F32_FLOPS)
    return {"rel": ((S - R).norm() / R.norm()).item(), "max_abs_err": (S - R).abs().max().item(),
            "err_terms": (S.double() - R64).norm().item() / terms,
            "plain_err_terms": (R.double() - R64).norm().item() / terms,
            "max_abs": R.abs().max().item(), "bitwise": torch.equal(S, S_again),
            "ms": cuda_ms(call, graph=True) if one_call_replay else None,
            "ms_in_graph": cuda_ms(call, graph=True, calls=K2_CALLS_PER_GRAPH),
            "eager_ms": cuda_ms(call),
            "plain_ms": cuda_ms(lambda: sk.schur_accumulate_plain(cam_idx, Wc, Vinv, M)),
            "bound_ms": b, "bound_by": by, "live": live}


def check_kernel2(label, cam_idx, Wc, Vinv, M):
    """Kernel 2 on one set of inputs: the checks and times of
    ``_kernel2_measure``, timed by graph replay of one call, per call in a
    graph of 20 and eagerly (host launch included)."""
    from scanner_colmap_tpu_torch.kernels import schur as sk

    P, T = cam_idx.shape
    m = _kernel2_measure(cam_idx, Wc, Vinv, M)
    y = {"bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
         "share_of_bound": m["bound_ms"] / m["ms"], "library_ms": None,
         "library_note": K2_LIBRARY_NOTE}
    _, tiles, splits = sk.launch_plan(M, P)
    log(f"kernel2 {label}: M={M} P={P} T={T}, mean live slots per point "
        f"{m['live'].mean().item():.3f}, plan {tiles} tiles x {splits} splits; rel "
        f"Frobenius err {m['rel']:.3g} (max abs err {m['max_abs_err']:.3g} of max |S| "
        f"{m['max_abs']:.3g}), two runs bitwise equal {m['bitwise']}, kernel "
        f"{m['ms']:.4f} ms (graph replay of one call), {m['ms_in_graph']:.4f} ms (per "
        f"call in a graph of {K2_CALLS_PER_GRAPH}), {m['eager_ms']:.4f} ms (eager, host "
        f"launch included), plain {m['plain_ms']:.3f} ms, bound {y['bound_ms']:.5f} ms "
        f"({y['bound_by']}), share of bound {y['share_of_bound']:.4f}")
    if not m["rel"] <= K2_REL_FROB or not m["bitwise"]:
        raise AssertionError(f"kernel 2 disagrees with its plain version or "
                             f"with itself ({label})")
    return {"max_abs_err": m["max_abs_err"], "ms": m["ms"], "ms_in_graph": m["ms_in_graph"],
            "eager_ms": m["eager_ms"], "plain_ms": m["plain_ms"], "M": M, "P": P, "T": T,
            "mean_live_slots": m["live"].mean().item(), **y}


def check_kernel2_calls(stage, calls):
    """Kernel 2 on every call a stage of the slice made (recorded in the
    cold pass): two runs bitwise equal, and S within K2_REL_TERMS of the
    f64 sum, relative to the norm of the sum of the products' magnitudes:
    in mapping's calls the products cancel (|S| falls to 1e-5 of that
    norm), so even the plain version in f32 strays from the f64 sum by
    more than 1e-5 of |S|. The times and bounds
    are sums over the calls (ms: per call in a graph of 20)."""
    from scanner_colmap_tpu_torch.kernels import schur as sk

    if not calls:
        raise AssertionError(f"no kernel 2 calls recorded in {stage}")
    ms = [_kernel2_measure(*c, one_call_replay=False) for c in calls]
    bad = [i for i, m in enumerate(ms) if not (m["err_terms"] <= K2_REL_TERMS and m["bitwise"])]
    tot = {k: sum(m[k] for m in ms) for k in ("ms_in_graph", "eager_ms", "plain_ms", "bound_ms")}
    by = statistics.mode(m["bound_by"] for m in ms)
    shapes = sorted({(M, *cam.shape, sk.launch_plan(M, cam.shape[0])[2])
                     for cam, _, _, M in calls})
    live = torch.cat([m["live"] for m in ms])
    pts_live = statistics.mean((m["live"] > 0).double().mean().item() for m in ms)
    log(f"kernel2 {stage} calls: {len(calls)} calls, (M, P, T, splits) {shapes}, share "
        f"of points with a live slot {pts_live:.3f}, live slots per such point "
        f"{live[live > 0].mean().item():.3f}; worst error against the f64 sum, over "
        f"the norm of the summed magnitudes: kernel {max(m['err_terms'] for m in ms):.3g}, "
        f"plain version {max(m['plain_err_terms'] for m in ms):.3g}; worst rel "
        f"Frobenius err against the plain version {max(m['rel'] for m in ms):.3g}; "
        f"every call's two runs bitwise equal "
        f"{all(m['bitwise'] for m in ms)}; sums over the calls: kernel "
        f"{tot['ms_in_graph']:.4f} ms (per call in a graph of {K2_CALLS_PER_GRAPH}), "
        f"{tot['eager_ms']:.4f} ms (eager), plain {tot['plain_ms']:.3f} ms, bound "
        f"{tot['bound_ms']:.5f} ms ({by})")
    if bad:
        raise AssertionError(f"kernel 2 disagrees with its plain version or with "
                             f"itself on {stage} calls {bad[:10]}")
    return {"calls": len(calls), "shapes": shapes, "points_with_live_slot": pts_live,
            "max_abs_err": max(m["max_abs_err"] for m in ms), "ms": tot["ms_in_graph"],
            "eager_ms": tot["eager_ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": by,
            "share_of_bound": tot["bound_ms"] / tot["ms_in_graph"], "library_ms": None}


def check_kernel2_synthetic(dev, M, P, T, seed):
    """Kernel 2 on ``ba.synthetic_bundle``: every slot live."""
    from scanner_colmap_tpu_torch.ops import ba

    params, obs, cfg = ba.synthetic_bundle(M=M, P=P, T=T, seed=seed, device=dev)
    return check_kernel2("synthetic", *ba.schur_inputs(params, obs, cfg), M)


def check_kernel2_lanes(dev, C, M, P, T):
    """Kernel 2 with a lane axis on C seeded ``ba.synthetic_bundle``
    problems (every slot live): one launch for all lanes against C per-lane
    calls, per call in a graph of 20 each; each lane within K2_REL_TERMS
    of its f64 sum, two runs bitwise equal; the bound C times a lane's."""
    from scanner_colmap_tpu_torch.kernels import schur as sk
    from scanner_colmap_tpu_torch.ops import ba

    lanes = [ba.schur_inputs(*ba.synthetic_bundle(M=M, P=P, T=T, seed=s, device=dev))
             for s in range(C)]
    cam, Wc, Vinv = (torch.stack(x).contiguous() for x in zip(*lanes))
    call = lambda: sk.schur_accumulate(cam, Wc, Vinv, M)  # noqa: E731

    def per_lane():
        for c in range(C):
            sk.schur_accumulate(*lanes[c], M)

    S, again = call(), call()
    err, worst, _, _, _, ok, _ = schur_call_check((cam, Wc, Vinv, M), S)
    one = _kernel2_measure(*lanes[0], M, one_call_replay=False)
    ms = cuda_ms(call, graph=True, calls=K2_CALLS_PER_GRAPH)
    lane_ms = cuda_ms(per_lane, graph=True, calls=K2_CALLS_PER_GRAPH)
    plain_ms = cuda_ms(lambda: sk.schur_accumulate_plain(cam, Wc, Vinv, M))
    b = C * one["bound_ms"]
    _, tiles, splits = sk.launch_plan(M, P, C)
    out = {"C": C, "M": M, "P": P, "T": T, "plan": [tiles, splits], "max_abs_err": err,
           "worst_err_terms": worst, "bitwise": torch.equal(S, again), "ms": ms,
           "per_lane_calls_ms": lane_ms, "plain_ms": plain_ms, "bound_ms": b,
           "bound_by": one["bound_by"], "share_of_bound": b / ms, "library_ms": None}
    log("kernel2 lanes: " + json.dumps(out))
    if not ok or not out["bitwise"]:
        raise AssertionError(f"kernel 2 with lanes disagrees with its plain version or "
                             f"with itself: {out}")
    return out


def check_kernel2_merge(dev, model):
    """Kernel 2 on the main path's own inputs: the merged model packed as
    the merge's global BA packs it (gauge and loss as ``global_refine``)."""
    from scanner_colmap_tpu_torch.engine.bundle_io import pack_bundle_flat
    from scanner_colmap_tpu_torch.ops import ba

    cam_in, pt_in, obs_in, _ = pack_bundle_flat(model, model.registered_image_ids)
    cam_in[0, 12:18] = 0.0
    cam_in[1, 15] = 0.0
    params, obs, cfg, lam = ba.flat_problem(cam_in, pt_in, obs_in, [1.0, 1.0, 4.0], dev)
    return check_kernel2("merge inputs", *ba.schur_inputs(params, obs, cfg, lam),
                         cam_in.shape[0])


# ---------------------------------------------------------------------------
# phase 4: kernel 3
# ---------------------------------------------------------------------------

def check_kernel3(dev, n_img, K, pairs, seed):
    """Kernel 3: one launch gives one bank's matching, forward and the cross
    check's reverse argbest, against its plain version."""
    from scanner_colmap_tpu_torch.kernels import top2
    from scanner_colmap_tpu_torch.ops import matching

    bank, valid = _pool(n_img, K, seed, dev, precision="f32")
    vb = valid.float()
    ab = torch.as_tensor(np.asarray(pairs, np.int32), device=dev)
    ai, bi = ab[:, 0].contiguous(), ab[:, 1].contiguous()

    out = top2.top2_bank(bank, vb, ai, bi)
    again = top2.top2_bank(bank, vb, ai, bi)
    swapped = top2.top2_bank(bank, vb, bi, ai)
    ref = top2.top2_bank_plain(bank, vb, ai, bi)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(x, y) for x, y in zip(out, again))
    rev_plain = torch.equal(out[3], ref[3])
    rev_swapped = torch.equal(out[3], swapped[2])
    d_k = matching.decide(*out)
    d_p = matching.decide(*ref)
    agree = (d_k == d_p).float().mean().item()
    err = max((out[0] - ref[0]).abs().max().item(),
              (out[1] - ref[1]).abs().max().item())
    bad = (d_k != d_p).nonzero()
    far = _far_from_ties(ref[:3], lambda p, c: bank[ai[p].long()] @ bank[bi[p].long(), c],
                         bad, K1_NEAR_TIE)
    ms = cuda_ms(lambda: top2.top2_bank(bank, vb, ai, bi), graph=True)
    plain_ms = cuda_ms(lambda: top2.top2_bank_plain(bank, vb, ai, bi), reps=3)
    library_ms = cuda_ms(lambda: library_top2(bank, ai, bi), reps=3, graph=True)
    NP = len(pairs)
    flops = 2 * NP * K * K * 128
    nbytes = (bank.numel() * 4 + vb.numel() * 4 + 2 * NP * 4
              + NP * K * (4 + 4 + 4 + 8))         # best, second, idx, column key
    y = yardsticks(ms, nbytes, flops, F32_FLOPS, library_ms)
    log(f"kernel3 K={K} pairs={NP} (both directions, one launch, "
        f"{flops / 1e9:.1f} GFLOP): decisions agree {agree:.6f}, {len(bad)} differ "
        f"({far} not near-ties), max |best/second err| {err:.3g}, rev == plain "
        f"{rev_plain}, rev == swapped launch's argbest {rev_swapped}, two runs "
        f"bitwise equal {bitwise}, kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
        f"TFLOP/s), plain {plain_ms:.3f} ms, library {library_ms:.4f} ms, bound "
        f"{y['bound_ms']:.4f} ms ({y['bound_by']}), share of bound "
        f"{y['share_of_bound']:.4f}")
    if (agree < K3_AGREE or far or not err <= K3_MAX_ABS or not bitwise
            or not rev_plain or not rev_swapped):
        raise AssertionError(f"kernel 3 disagrees with its plain version at K={K}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **y}


# ---------------------------------------------------------------------------
# phase 5: the slice; phase 6: extra matching passes
# ---------------------------------------------------------------------------

def slice_config(root, precision):
    """bench.py's headline configuration (bench.py:176-192): 16 images,
    1024 features, overlap 6, cluster_size 12 (two clusters), loop closure
    at its default ("auto")."""
    from scanner_colmap_tpu_torch.pipeline import PipelineConfig

    cfg = PipelineConfig()
    cfg.store_path = root
    cfg.sift.max_image_size = 480
    cfg.sift.max_num_features = 1024
    cfg.sift.num_octaves = 3
    cfg.matching.overlap = 6
    cfg.matching.min_num_inliers = 12
    cfg.matching.precision = precision
    cfg.mapper.cluster_size = 12
    cfg.mapper.cluster_overlap = 4
    cfg.mapper.init_min_num_inliers = 20
    cfg.mapper.abs_pose_min_num_inliers = 12
    cfg.mapper.single_camera = True
    return cfg


def check_model(name, model, gt, n_submodels, min_registered=SLICE_MIN_REGISTERED,
                submodels=SLICE_SUBMODELS, max_ate=SLICE_MAX_ATE):
    """Registered count, submodels, ATE and finite points of a slice run
    (None skips a limit)."""
    from scanner_colmap_tpu_torch.pipeline import synth

    xyz = np.array([p.xyz for p in model.points3D.values()])
    ate = synth.evaluate_ate(model, gt)
    if not np.isfinite(xyz).all() or xyz.shape != (len(model.points3D), 3):
        raise AssertionError(f"{name}: non-finite or malformed points")
    if model.num_registered < min_registered:
        raise AssertionError(f"{name}: registered {model.num_registered}")
    if submodels is not None and n_submodels != submodels:
        raise AssertionError(f"{name}: {n_submodels} submodels, expected {submodels}")
    if max_ate is not None and not ate <= max_ate:
        raise AssertionError(f"{name}: ATE {ate} > {max_ate}")
    return ate


STEPS = ("extraction", "matching", "mapping", "merge")


def drive(cfg, store, dev, steps=STEPS, times=None, suffix=""):
    """Run the given stages in order: their outputs and the kernels'
    launches in each (the counts are not reset here)."""
    from scanner_colmap_tpu_torch import kernels
    from scanner_colmap_tpu_torch.pipeline import stages

    from scanner_colmap_tpu_torch.utils import metrics

    outs, per_stage = {}, {}
    for name in steps:
        before = kernels.launch_counts()
        # the merge's split: its spans, recorded with tracing on
        was = metrics.set_tracing(name == "merge" or metrics.tracing())
        metrics.GLOBAL_METRICS.reset()
        t = time.time()
        try:
            outs[name] = getattr(stages, f"run_{name}")(cfg, store, device=dev)
        finally:
            metrics.set_tracing(was)
        torch.cuda.synchronize()
        if times is not None:
            times[f"{name}{suffix}_s"] = time.time() - t
        per_stage[name] = {k: v - before[k] for k, v in kernels.launch_counts().items()}
        if name == "merge":
            spans = metrics.GLOBAL_METRICS.stage(metrics.RUN)
            outs["merge_split_s"] = {k[len("span.merge."):-len(".s")]: round(v, 2)
                                     for k, v in spans.items()
                                     if k.startswith("span.merge.") and k.endswith(".s")}
    return outs, per_stage


def run_slice(dev, frames, gt, root, precision, record=None):
    """One cold and one warm pass of the five stages. The warm pass is the
    main path: every launch count is set to 0 just before it and read just
    after, with the per-stage launches recorded on the way. With a list
    ``record``, the cold pass appends to it (stage, (cam_idx, Wc, Vinv, M))
    of every kernel 2 call, copied as the BA passed them."""
    from scanner_colmap_tpu_torch import kernels
    from scanner_colmap_tpu_torch.pipeline import ArtifactStore, stages

    cfg = slice_config(root, precision)
    store = ArtifactStore(root)
    stages.prepare_images(cfg, store, frames=[(f, gt["focal"]) for f in frames])
    times, cold = {}, {}
    for name in STEPS:                           # cold pass
        with KernelTap() if record is not None else contextlib.nullcontext() as tap:
            cold.update(drive(cfg, store, dev, (name,), times, "_cold")[0])
        if record is not None:
            record.extend((name, args) for _, args, _, _ in tap.calls["schur"])
    kernels.reset_launch_counts()
    outs, per_stage = drive(cfg, store, dev, times=times)   # warm pass: the main path
    launches = kernels.launch_counts()
    model = outs["merge"]
    m_meta = store.read_manifest("matching")["meta"]
    ate = check_model(f"slice {precision}", model, gt, outs["mapping"])
    summary = {"precision": precision, "execution": m_meta["execution"],
               "registered": model.num_registered, "images": 16,
               "submodels": outs["mapping"], "verified_pairs": outs["matching"],
               "points": len(model.points3D),
               "mean_reproj_px": model.mean_reprojection_error(), "ate": ate,
               "loop_closure": m_meta["loop_closure"],
               "launches": launches, "launches_per_stage": per_stage,
               "mapping_stats": store.read_manifest("mapping")["meta"]["device_stats"],
               "merge_time_split_s": outs["merge_split_s"],
               "stage_seconds": {k: round(v, 4) for k, v in times.items()}}
    graph = store.read_manifest("mapping")["meta"]["graph"]
    summary["correspondence_graph"] = graph
    summary["warm_model_equals_cold"] = same_model(model, cold["merge"])
    log(f"slice {precision}: " + json.dumps(summary))
    log(f"slice {precision}: the mapper used the {graph} correspondence graph; "
        f"main-path launches per stage: {json.dumps(per_stage)}")
    matcher = "pair_match" if precision == "bf16" else "top2"
    if per_stage["matching"][matcher] <= 0:
        raise AssertionError(f"{matcher} was not launched in the {precision} matching pass")
    if per_stage["merge"]["schur"] <= 0:
        raise AssertionError("schur was not launched inside run_merge")
    lc = m_meta["loop_closure"]
    if lc["mode"] != "auto" or lc["enabled"] or not probe_decided(lc):
        raise AssertionError(f"slice {precision}: the loop-closure probe did not keep "
                             f"closure off on the straight set: {lc}")
    if not summary["warm_model_equals_cold"]:
        raise AssertionError(f"slice {precision}: the warm pass's model differs from "
                             "the cold pass's")
    return cfg, store, launches, model, times["matching_s"]


def probe_decided(lc):
    """Whether the auto probe covered the whole collection and its own
    signal decided: the signal stands as revisit_frac, with no probe_error
    (a failed probe falls back to the full prepass), no probe_frac (left
    by a subset probe) and nothing skipped."""
    return ("revisit_frac" in lc and "partner_coherence" in lc
            and not {"probe_error", "probe_frac", "skipped"} & lc.keys())


def same_model(a, b):
    """Whether two passes gave bitwise the same model: registered images,
    poses and points."""
    ids = sorted(a.registered_image_ids)
    if ids != sorted(b.registered_image_ids) or a.points3D.keys() != b.points3D.keys():
        return False
    return all(np.array_equal(a.images[i].qvec, b.images[i].qvec)
               and np.array_equal(a.images[i].tvec, b.images[i].tvec) for i in ids) and all(
        np.array_equal(p.xyz, b.points3D[k].xyz) for k, p in a.points3D.items())


def extra_matching(dev, gt, bf16_run, f32_run):
    """bf16 banked == resident on the card; guided + multiple models (f32)
    through mapping and merge."""
    from scanner_colmap_tpu_torch.pipeline import stages

    cfg, store = bf16_run[:2]
    cfg.matching.execution, cfg.matching.bank_images = "banked", 5
    stages.run_matching(cfg, store, device=dev, out_table="matching_banked")
    rows = {}
    for table in ("matching", "matching_banked"):
        t = store.read_table(table)
        rows[table] = {tuple(p): (np.asarray(t["two_view_geometry"][n]),
                                  np.asarray(t["matches"][n]))
                       for n, p in enumerate(np.asarray(t["pair_image_ids"]))}
    same = rows["matching"].keys() == rows["matching_banked"].keys() and all(
        np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        for a, b in ((rows["matching"][p], rows["matching_banked"][p])
                     for p in rows["matching"]))
    n_banks = store.read_manifest("matching_banked")["meta"]["num_banks"]
    log(f"extra: bf16 banked ({n_banks} banks) == resident: {same} "
        f"({len(rows['matching'])} pairs)")
    if not same or n_banks < 2:
        raise AssertionError("bf16 banked and resident tables differ on the card")

    cfg, store = f32_run[:2]
    cfg.matching.guided_matching = cfg.matching.multiple_models = True
    t = time.time()
    n_rows = stages.run_matching(cfg, store, device=dev)
    n_sub = stages.run_mapping(cfg, store, device=dev)
    model = stages.run_merge(cfg, store, device=dev)
    torch.cuda.synchronize()
    n_multi = sum(int(r[0]) == 8 for r in store.read_table("matching")["two_view_geometry"])
    ate = check_model("guided+multiple", model, gt, n_sub)
    log(f"extra: guided + multiple models (f32): {n_rows} table rows ({n_multi} "
        f"MULTIPLE), {model.num_registered}/16 registered, {n_sub} submodels, "
        f"ATE {ate:.5f}, {time.time() - t:.2f} s")
    if n_rows < GUIDED_MIN_ROWS:
        raise AssertionError(f"guided + multiple: {n_rows} rows < {GUIDED_MIN_ROWS}")


# ---------------------------------------------------------------------------
# phase 5, continued: batched verification
# ---------------------------------------------------------------------------

def profiled_matching(cfg, store, dev):
    """One matching pass under torch.profiler, with the stage's call of
    ``verify_candidates`` recorded: (its arguments, verified pairs, device
    kernels of the pass (copies and sets included), seconds)."""
    from scanner_colmap_tpu_torch.pipeline import stages
    from scanner_colmap_tpu_torch.utils.metrics import device_work

    real, calls = stages.verify_candidates, []

    def record(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    stages.verify_candidates = record
    t = time.time()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            pairs = stages.run_matching(cfg, store, device=dev, out_table="matching_profiled")
            torch.cuda.synchronize()
    finally:
        stages.verify_candidates = real
    secs = time.time() - t
    work = device_work(prof)
    if not work["device_kernels"] > 0:
        raise AssertionError("the profiler saw no device kernels in matching")
    return calls[0], pairs, work, secs


def verify_rows(args, dev, cand=None, chunk=None):
    """The rows ``verify_candidates`` gives, by candidate pair: {(a, b):
    [(tvg row, matches), ...]}."""
    from scanner_colmap_tpu_torch.pipeline import stages

    m, image_ids, kp, cameras, all_cand, P, _ = args
    pair_ids, rows, matches = stages.verify_candidates(
        m, image_ids, kp, cameras, all_cand if cand is None else cand, P, dev, chunk=chunk)
    out = {}
    for p, r, mm in zip(pair_ids, rows, matches):
        out.setdefault(p, []).append((r, mm))
    return out


def verify_peak(args, dev):
    """Verification of the stage's candidates in its own chunk: (rows,
    seconds, peak device memory above what was allocated before, MiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.time()
    rows = verify_rows(args, dev)
    torch.cuda.synchronize()
    return rows, time.time() - t, (torch.cuda.max_memory_allocated() - base) / 2**20


def same_rows(a, b):
    return a.keys() == b.keys() and all(
        len(a[p]) == len(b[p]) and all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
                                       for x, y in zip(a[p], b[p])) for p in a)


def check_verification(dev, label, cfg, store, warm_matching_s):
    """Phase 5's verification checks on one slice: device kernels per
    verified pair in a profiled matching pass, and bitwise equal rows in the
    stage's chunk, in chunks of 8, and for a sample of pairs each alone."""
    from scanner_colmap_tpu_torch.pipeline import stages

    args, pairs, work, secs = profiled_matching(cfg, store, dev)
    m, image_ids, _, _, cand, P, _ = args
    ref, v_s, peak = verify_peak(args, dev)
    eight = verify_rows(args, dev, chunk=8)
    pick = sorted(set(np.linspace(0, len(cand) - 1, VERIFY_SAMPLE).round().astype(int)))
    alone_same = []
    for i in pick:
        a, b = cand[i][0], cand[i][1]
        key = (image_ids[a], image_ids[b])
        alone = verify_rows(args, dev, cand=[cand[i]])
        alone_same.append(same_rows(alone, {key: ref[key]} if key in ref else {}))
    out = {"candidates": len(cand), "verified_pairs": pairs, "P": P,
           "chunk": stages.verify_chunk(len(cand), m.verify_batch_pairs),
           "pairs_per_call": stages.verify_sub_batch(P, dev),
           "device_kernels": work["device_kernels"],
           "kernels_per_verified_pair": work["device_kernels"] / max(pairs, 1),
           "device_busy_ms": work["device_busy_ms"], "profiled_matching_s": secs,
           "warm_matching_s": warm_matching_s, "verify_s": v_s, "verify_peak_mib": peak,
           "chunk8_equal": same_rows(ref, eight), "alone_equal": alone_same}
    log(f"verification {label}: " + json.dumps(out))
    if not out["chunk8_equal"] or not all(alone_same):
        raise AssertionError(f"verification {label}: rows differ between chunks")
    return out


def verify_capacity(dev):
    """Verification at the reference capacity: CAPACITY_PAIRS pairs of
    CAPACITY_MATCHES correspondences each (consecutive views of a random
    scene, 0.3 px noise, 20% of the matches replaced by random ones) in one
    chunk. Every pair must verify with most of its inliers; reports the
    pairs per call, seconds and the peak memory of verification."""
    from scanner_colmap_tpu_torch.models import cameras as camlib
    from scanner_colmap_tpu_torch.models import geometry as geom
    from scanner_colmap_tpu_torch.pipeline import PipelineConfig, stages

    g = np.random.default_rng(0)
    n = CAPACITY_MATCHES
    X = np.stack([g.uniform(-4, 4, n), g.uniform(-3, 3, n), g.uniform(6, 10, n)], 1)
    kp, cameras = {}, {}
    for i in range(CAPACITY_PAIRS + 1):
        q = geom.np_angle_axis_to_quat(np.array([0.0, -0.02 * i, 0.0]))
        xc = geom.np_pose_transform(q, -geom.np_quat_rotate(q, np.array([0.3 * i, 0, 0])), X)
        kp[i] = np.zeros((n, 4))
        kp[i][:, :2] = xc[:, :2] / xc[:, 2:] * 300.0 + [320.0, 240.0] + g.normal(0, 0.3, (n, 2))
        cameras[i] = (camlib.SIMPLE_RADIAL, [300.0, 320.0, 240.0, 0.0], 640, 480, True)
    cand = []
    for i in range(CAPACITY_PAIRS):
        idx = np.arange(n)
        out = g.uniform(size=n) < 0.2
        idx[out] = g.integers(0, n, out.sum())
        cand.append((i, i + 1, np.arange(n), idx))
    P = -(-n // 256) * 256
    args = (PipelineConfig().matching, list(range(CAPACITY_PAIRS + 1)), kp, cameras, cand, P, dev)
    rows, secs, peak = verify_peak(args, dev)
    n_inl = [int(v[0][0][1]) for v in rows.values()]
    out = {"pairs": CAPACITY_PAIRS, "matches_per_pair": n, "P": P,
           "pairs_per_call": stages.verify_sub_batch(P, dev), "verified": len(rows),
           "min_inliers": min(n_inl, default=0), "verify_s": secs, "verify_peak_mib": peak}
    log("verification at capacity: " + json.dumps(out))
    if len(rows) != CAPACITY_PAIRS or min(n_inl) < 0.7 * n:
        raise AssertionError(f"verification at capacity: {out}")
    return out


# ---------------------------------------------------------------------------
# phases 10 and 11: the command line
# ---------------------------------------------------------------------------

def have_pil():
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return False
    return True


def cli(args, store_root, cfg=None):
    """``python3 -m scanner_colmap_tpu_torch.pipeline.cli ARGS`` in a
    subprocess on the card, with cfg written as its --config (None: the
    config written beside the store before). Returns its seconds."""
    import subprocess as sp
    import sys

    cfg_path = os.path.join(os.path.dirname(store_root), "config.json")
    if cfg is not None:
        with open(cfg_path, "w") as f:
            f.write(cfg.to_json())
    cmd = [sys.executable, "-m", "scanner_colmap_tpu_torch.pipeline.cli", *args,
           "--config", cfg_path, "--store_path", store_root]
    t = time.time()
    proc = sp.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                  text=True, timeout=CLI_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"cli {' '.join(args)} failed ({proc.returncode}):\n"
                             f"{proc.stderr[-4000:]}")
    return time.time() - t


def run_cli(cfg, store_root, resume, args=("all", "--sparse_only")):
    """``cli`` of ``all --sparse_only`` (or ``args``), with --resume if
    asked. Returns (the model read back with load_model, the run's
    metrics.json, seconds)."""
    from scanner_colmap_tpu_torch.pipeline import ArtifactStore, stages

    secs = cli(tuple(args) + (("--resume",) if resume else ()), store_root, cfg)
    with open(os.path.join(store_root, "metrics.json")) as f:
        metrics = json.load(f)
    return stages.load_model(ArtifactStore(store_root)), metrics, secs


def path_launches(metrics):
    """The kernels' launches of a run_all, summed over its stages."""
    from scanner_colmap_tpu_torch import kernels

    return {k: int(sum(v.get(f"launches.{k}", 0) for v in metrics.values()))
            for k in kernels.KERNELS}


def cli_scale_phase(dev, root, pil):
    """Phase 10: bench.py's 200-image scale set through the command line.
    Returns ({path: launches}, the run's config, store, ground truth, camera
    span and metrics, for phase 14)."""
    from scanner_colmap_tpu_torch.models import geometry as geom
    from scanner_colmap_tpu_torch.pipeline import ArtifactStore, stages, synth

    t = time.time()
    store_root = os.path.join(root, "scale", "store")
    cfg = slice_config(store_root, "bf16")
    kw = dict(num_images=SCALE_IMAGES, width=480, height=360, num_blobs=500, seed=7)
    if pil:
        cfg.image_path = os.path.join(root, "scale", "images")
        gt = synth.generate_dataset(cfg.image_path, **kw)
        gt = {**gt, "qvecs": np.asarray(gt["qvecs"]), "tvecs": np.asarray(gt["tvecs"])}
    else:
        frames, gt = synth.render_dataset(**kw)
        stages.prepare_images(cfg, ArtifactStore(store_root),
                              frames=[(f, gt["focal"]) for f in frames])
    gen_s = time.time() - t
    model, metrics, cli_s = run_cli(cfg, store_root, resume=not pil)
    store = ArtifactStore(store_root)
    centers = np.stack([geom.np_projection_center(q, tv)
                        for q, tv in zip(gt["qvecs"], gt["tvecs"])])
    span = float(np.linalg.norm(centers.max(0) - centers.min(0)))
    ate = synth.evaluate_ate(model, gt)
    launches = path_launches(metrics)
    args, pairs, work, secs = profiled_matching(cfg, store, dev)
    _, v_s, peak = verify_peak(args, dev)
    out = {"images": SCALE_IMAGES, "input": "jpeg directory" if pil else
           "in-memory frames table, --resume", "registered": model.num_registered,
           "ate": ate, "span": span, "ate_rel_span": ate / span,
           "mean_reproj_px": model.mean_reprojection_error(),
           "verified_pairs": store.num_rows("matching"),
           "stage_seconds": {k: round(v["wall_s"], 3) for k, v in metrics.items()},
           "stage_peak_mib": {k: round(v.get("peak_allocated_mib", 0.0), 1)
                              for k, v in metrics.items()},
           "launches": launches, "cli_seconds": cli_s, "data_seconds": gen_s,
           "profiled_matching": {"verified_pairs": pairs,
                                 "device_kernels": work["device_kernels"],
                                 "kernels_per_verified_pair": work["device_kernels"] / max(pairs, 1),
                                 "device_busy_ms": work["device_busy_ms"], "seconds": secs,
                                 "candidates": len(args[4]), "P": args[5],
                                 "verify_s": v_s, "verify_peak_mib": peak}}
    log("cli scale: " + json.dumps(out))
    if model.num_registered < SCALE_MIN_REGISTERED or not ate <= SCALE_MAX_ATE_SPAN * span:
        raise AssertionError(f"cli scale: {model.num_registered}/{SCALE_IMAGES} registered, "
                             f"ATE {ate} of span {span}")
    if launches["pair_match"] <= 0 or launches["schur"] <= 0:
        raise AssertionError(f"cli scale: the kernels were not launched: {launches}")
    return {"cli_scale": launches}, {"cfg": cfg, "store": store, "gt": gt, "span": span,
                                     "metrics": metrics}


def cli_real_phase(dev, root):
    """Phase 11: bench.py's real-texture set through the command line.
    Returns ({path: launches}, the ground truth)."""
    from scanner_colmap_tpu_torch.pipeline import ArtifactStore, PipelineConfig, stages, synth

    t = time.time()
    image_dir = os.path.join(root, "real", "images")
    gt = synth.generate_real_texture_dataset(image_dir, num_images=REAL_IMAGES, width=480,
                                             height=400, seed=1, num_bumps=2,
                                             exposure_jitter=0.2, noise_std=2.0)
    gt = {**gt, "qvecs": np.asarray(gt["qvecs"]), "tvecs": np.asarray(gt["tvecs"])}
    gen_s = time.time() - t
    cfg = PipelineConfig()                 # bench.py:647-655
    cfg.image_path = image_dir
    cfg.store_path = os.path.join(root, "real", "store")
    cfg.sift.max_image_size = 480
    cfg.sift.max_num_features = 1024
    cfg.sift.num_octaves = 3
    cfg.matching.overlap = 5
    cfg.mapper.single_camera = True
    model, metrics, cli_s = run_cli(cfg, cfg.store_path, resume=False)
    cam = model.cameras[model.images[model.registered_image_ids[0]].camera_id]
    scale = stages.cam_scales(ArtifactStore(cfg.store_path))[model.registered_image_ids[0]]
    out = {"registered": model.num_registered, "images": REAL_IMAGES,
           "ate": synth.evaluate_ate(model, gt),
           "mean_reproj_px": model.mean_reprojection_error(),
           "focal_rel_err": abs(cam.params[0] / scale - gt["focal"]) / gt["focal"],
           "stage_seconds": {k: round(v["wall_s"], 3) for k, v in metrics.items()},
           "launches": path_launches(metrics), "cli_seconds": cli_s, "data_seconds": gen_s}
    log("cli real texture: " + json.dumps(out))
    if (out["registered"] < REAL_MIN_REGISTERED or not out["ate"] < REAL_MAX_ATE
            or not out["mean_reproj_px"] < REAL_MAX_REPROJ_PX
            or not out["focal_rel_err"] < REAL_MAX_FOCAL_ERR):
        raise AssertionError(f"cli real texture: {out}")
    return {"cli_real": out["launches"]}, gt


# ---------------------------------------------------------------------------
# phase 7: loop closure; phase 8: the host mapper
# ---------------------------------------------------------------------------

def _count_cg_trials():
    """Wrap ``ba._lm_trial_cg`` so that CG trials are counted: (restore,
    counter)."""
    from scanner_colmap_tpu_torch.ops import ba

    trial, n = ba._lm_trial_cg, [0]

    def counted(*a, **kw):
        n[0] += 1
        return trial(*a, **kw)

    ba._lm_trial_cg = counted
    return (lambda: setattr(ba, "_lm_trial_cg", trial)), n


def window_table(src, dst, overlap, sep):
    """Write into ``dst`` the matching table that closure off gives: the
    rows of ``src``'s table whose pair lies in the window. Each pair's
    draws are keyed by its rows, so these rows are what the window pass
    verifies with closure off. Returns the number of rows."""
    t = src.read_table("matching")
    prs = np.asarray(t["pair_image_ids"]).reshape(-1, 2)
    gap = np.abs(prs[:, 0] - prs[:, 1])
    if not np.all((gap <= overlap) | (gap > sep)):
        raise AssertionError("loop: a verified pair lies between the window and the "
                             "loop separation")
    win = np.nonzero(gap <= overlap)[0]
    meta = dict(src.read_manifest("matching")["meta"],
                loop_closure={"mode": "off", "enabled": False, "n_candidates": 0})
    dst.write_table("matching", {
        "pair_image_ids": prs[win],
        "two_view_geometry": np.asarray(t["two_view_geometry"])[win],
        "matches": [np.asarray(t["matches"][n]) for n in win]}, meta=meta)
    return len(win)


def loop_phase(dev, root):
    """Phase 7 on a 48-image out-and-back set: closure (auto) through the
    five stages at bf16 (resident), mapping and merge on its window pairs
    alone (closure off), f32 matching of the loop candidates alone on the
    same extraction, and the closure run's merge again on the CG path.
    Returns ({path: launches}, the closure run's config, store and ground
    truth and the ATE without closure, for phase 14)."""
    from scanner_colmap_tpu_torch import kernels
    from scanner_colmap_tpu_torch.pipeline import ArtifactStore, PipelineConfig, stages, synth

    t0 = time.time()
    frames, gt = synth.render_dataset(num_images=LOOP_IMAGES, width=480, height=360,
                                      num_blobs=500, seed=3, track="out_and_back")
    log(f"loop: rendered {LOOP_IMAGES} frames in {time.time() - t0:.1f} s")
    paths = {}
    cfg = slice_config(os.path.join(root, "loop_auto"), "bf16")
    m = cfg.matching
    sep = m.loop_min_separation or 2 * m.overlap
    store = ArtifactStore(cfg.store_path)
    stages.prepare_images(cfg, store, frames=[(f, gt["focal"]) for f in frames])
    times = {}
    kernels.reset_launch_counts()
    outs, per_stage = drive(cfg, store, dev, STEPS, times)
    paths["loop_bf16"] = kernels.launch_counts()
    meta = store.read_manifest("matching")["meta"]
    lc = meta["loop_closure"]

    # closure off: the same frames, extraction and window pairs
    cfg_off = slice_config(os.path.join(root, "loop_off"), "bf16")
    cfg_off.matching.loop_closure = False
    store_off = ArtifactStore(cfg_off.store_path)
    for table in ("frames", "extraction"):
        shutil.copytree(os.path.join(store.root, table), os.path.join(store_off.root, table))
    n_window = window_table(store, store_off, m.overlap, sep)
    outs_off, _ = drive(cfg_off, store_off, dev, STEPS[2:], times, "_off")

    res = {}
    for tag, st, o in (("auto", store, outs), ("off", store_off, outs_off)):
        model = o["merge"]
        ate = check_model(f"loop closure {tag}", model, gt, o["mapping"],
                          min_registered=LOOP_MIN_REGISTERED, submodels=None, max_ate=None)
        prs = np.asarray(st.read_table("matching")["pair_image_ids"]).reshape(-1, 2)
        far = prs[np.abs(prs[:, 0] - prs[:, 1]) > LOOP_FAR]
        mirror = float(np.mean(np.abs(far.sum(1) - LOOP_IMAGES) < LOOP_MIRROR_BAND)) \
            if len(far) else None
        res[tag] = (model, ate, far)
        log(f"loop closure {tag}: " + json.dumps({
            "registered": model.num_registered, "images": LOOP_IMAGES,
            "submodels": o["mapping"], "verified_pairs": len(prs),
            "far_pairs": len(far), "mirror_frac": mirror, "ate": ate,
            "loop_closure": st.read_manifest("matching")["meta"]["loop_closure"],
            "merge_time_split_s": o["merge_split_s"]}))
    log(f"loop: launches per stage with closure {json.dumps(per_stage)}, stage seconds "
        f"{json.dumps({k: round(v, 4) for k, v in times.items()})}")
    model, ate, far = res["auto"]
    if not (lc["enabled"] and probe_decided(lc) and lc["revisit_frac"] >= m.loop_auto_min_frac
            and lc["partner_coherence"] >= m.loop_auto_min_coherence):
        raise AssertionError(f"loop: the auto probe did not turn closure on: {lc}")
    if n_window + lc["n_candidates"] < outs["matching"] or n_window >= outs["matching"]:
        raise AssertionError(f"loop: {n_window} window pairs of {outs['matching']} verified")
    on_mirror = np.abs(far.sum(1) - LOOP_IMAGES) < LOOP_MIRROR_BAND
    if len(far) < LOOP_MIN_FAR_PAIRS or on_mirror.mean() < LOOP_MIRROR_FRAC:
        raise AssertionError(f"loop: {len(far)} far pairs, {on_mirror.mean():.3f} on the "
                             f"mirror band; off the band: {far[~on_mirror].tolist()}")
    # one pair_match launch per chunk of the window schedule and of the
    # loop candidates: the candidates went through kernel 1
    chunks = (-(-meta["scheduled_pairs"] // m.resident_pair_chunk)
              - (-lc["n_candidates"] // m.resident_pair_chunk))
    if lc["n_candidates"] <= 0 or per_stage["matching"]["pair_match"] != chunks:
        raise AssertionError(f"loop: pair_match launched {per_stage['matching']['pair_match']} "
                             f"times in matching, expected {chunks} with the loop candidates")
    ate_off = res["off"][1]
    if not ate <= LOOP_ATE_FACTOR * ate_off + 1e-4:
        raise AssertionError(f"loop: ATE with closure {ate} > {LOOP_ATE_FACTOR} x {ate_off}")

    # f32 on the same extraction, the loop candidates alone: with no window
    # (overlap 0, the separation pinned) the banked plan has no window bank,
    # so every kernel 3 launch is a loop mini-bank's
    cfg32 = slice_config(store.root, "f32")
    cfg32.matching.overlap, cfg32.matching.loop_min_separation = 0, sep
    kernels.reset_launch_counts()
    t = time.time()
    n32 = stages.run_matching(cfg32, store, device=dev, out_table="matching_f32")
    torch.cuda.synchronize()
    paths["loop_f32_matching"] = per32 = kernels.launch_counts()
    m32 = store.read_manifest("matching_f32")["meta"]
    lc32 = m32["loop_closure"]
    log(f"loop f32 matching of the candidates: {json.dumps(lc32)}, {n32} verified, "
        f"{m32['num_banks']} window banks, launches {json.dumps(per32)}, "
        f"{time.time() - t:.2f} s")
    if lc32.get("candidates_digest") != lc.get("candidates_digest") or \
            lc32["n_candidates"] != lc["n_candidates"] or not probe_decided(lc32):
        raise AssertionError("loop: the f32 loop candidates differ from the bf16 ones")
    if m32["num_banks"] != 0 or per32["top2"] < 1 or n32 <= 0:
        raise AssertionError("loop: top2 was not launched on the loop mini-banks alone")

    # the closure run's merge again, its solves on the CG path
    cfg.merge.final_ba_max_images = CG_MERGE_MAX_IMAGES
    cfg.mapper.ba_dense_max_images = CG_MERGE_MAX_IMAGES   # iterative refinement's bound
    restore, n_cg = _count_cg_trials()
    kernels.reset_launch_counts()
    t = time.time()
    try:
        model_cg = stages.run_merge(cfg, store, device=dev)
        torch.cuda.synchronize()
    finally:
        restore()
    paths["loop_cg_merge"] = kernels.launch_counts()
    ate_cg = check_model("loop CG merge", model_cg, gt, None,
                         min_registered=LOOP_MIN_REGISTERED, submodels=None, max_ate=None)
    log(f"loop CG merge: {model_cg.num_registered}/{LOOP_IMAGES} registered, ATE "
        f"{ate_cg:.6f} (dense merge {ate:.6f}), {n_cg[0]} CG trials, launches "
        f"{json.dumps(paths['loop_cg_merge'])}, {time.time() - t:.2f} s")
    if n_cg[0] <= 0 or sorted(model_cg.registered_image_ids) != sorted(model.registered_image_ids):
        raise AssertionError("loop: the CG merge did not run CG or registered another set")
    if not ate_cg <= CG_MERGE_ATE_FACTOR * ate + 1e-4:
        raise AssertionError(f"loop: CG merge ATE {ate_cg} > {CG_MERGE_ATE_FACTOR} x {ate}")
    cfg.merge.final_ba_max_images = PipelineConfig().merge.final_ba_max_images
    cfg.mapper.ba_dense_max_images = PipelineConfig().mapper.ba_dense_max_images
    return paths, {"cfg": cfg, "store": store, "gt": gt, "ate_off": ate_off}


def host_phase(dev, gt, bf16_run):
    """Phase 8 on the bf16 slice's store: the host mapper, then device mode
    with every cluster retried on it. Returns {path: launches}."""
    from scanner_colmap_tpu_torch import kernels

    cfg, store = bf16_run[:2]
    paths = {}
    cfg.mapper.mode = "host"
    kernels.reset_launch_counts()
    times = {}
    outs, per_stage = drive(cfg, store, dev, ("mapping", "merge"), times)
    paths["host_mapper"] = kernels.launch_counts()
    ate = check_model("host mapper", outs["merge"], gt, outs["mapping"])
    stats = store.read_manifest("mapping")["meta"]["device_stats"]
    log(f"host mapper: {outs['merge'].num_registered}/16 registered, {outs['mapping']} "
        f"submodels, ATE {ate:.6f}, stats {json.dumps(stats)}, launches per stage "
        f"{json.dumps(per_stage)}, seconds {json.dumps(times)}")
    if stats["mode"] != "host" or per_stage["mapping"]["schur"] <= 0:
        raise AssertionError("host mapper: schur was not launched in mapping")

    cfg.mapper.mode = "device"
    cfg.mapper.device_fallback_min_frac = 1.01          # every cluster is weak
    kernels.reset_launch_counts()
    outs, per_stage = drive(cfg, store, dev, ("mapping", "merge"), times, "_retry")
    paths["device_retry"] = kernels.launch_counts()
    cfg.mapper.device_fallback_min_frac = 0.6
    stats = store.read_manifest("mapping")["meta"]["device_stats"]
    log(f"device mode, every cluster retried: {outs['merge'].num_registered}/16 "
        f"registered, stats {json.dumps(stats)}, launches per stage {json.dumps(per_stage)}")
    if stats["host_retried"] != [0, 1] or outs["merge"].num_registered < SLICE_MIN_REGISTERED:
        raise AssertionError(f"device retry: {stats}, {outs['merge'].num_registered} registered")
    return paths


# ---------------------------------------------------------------------------
# phase 9: the CG solver at scale
# ---------------------------------------------------------------------------

def _solve_twice(params, obs, cfg, **kw):
    """Two runs of one solve: (params, info, bitwise equal, ms of the
    first, peak bytes allocated)."""
    from scanner_colmap_tpu_torch.ops import ba

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    p1, i1 = ba.bundle_adjust(params, obs, cfg, **kw)
    torch.cuda.synchronize()
    ms = (time.time() - t) * 1e3
    peak = torch.cuda.max_memory_allocated()
    p2, i2 = ba.bundle_adjust(params, obs, cfg, **kw)
    same = all(torch.equal(a, b) for a, b in zip((p1.qvec, p1.tvec, p1.xyz, i1["final_cost"]),
                                                 (p2.qvec, p2.tvec, p2.xyz, i2["final_cost"])))
    return p1, i1, same, ms, peak


def _device_us(evt):
    for key in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, key, None)
        if v is not None:
            return float(v)
    return 0.0


def _matvec_split(params, obs, cfg, cg_iters):
    """Device time per CG matvec and its shares in the gather, the einsums
    and the camera sum, from a torch.profiler window over one trial (the
    ranges ``ops/ba.py`` marks). Raises if the profiler sees no device
    time."""
    from scanner_colmap_tpu_torch.ops import ba

    plan = ba.cg_plan(obs, cfg, params.qvec.shape[0])
    lam = torch.tensor(1e-4, device=params.xyz.device)
    ba._lm_trial_cg(params, obs, cfg, lam, cg_iters, plan=plan)          # warm up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        ba._lm_trial_cg(params, obs, cfg, lam, cg_iters, plan=plan)
        torch.cuda.synchronize()
    tot, count = {}, {}
    for e in prof.events():
        if e.name.startswith("ba.cg.") and "CPU" in str(e.device_type):
            tot[e.name] = tot.get(e.name, 0.0) + _device_us(e)
            count[e.name] = count.get(e.name, 0) + 1
    n = count.get("ba.cg.matvec", 0)
    if n != cg_iters or not tot["ba.cg.matvec"] > 0:
        raise AssertionError(f"cg scale: the profiler saw {n} matvecs with device time "
                             f"{tot.get('ba.cg.matvec')} us")
    per = {k[6:]: tot[k] / n / 1e3 for k in tot}
    return {"source": "torch.profiler", "matvecs": n, "ms": per.pop("matvec"), "split_ms": per}


def cg_scale_phase(dev):
    """Phase 9. Returns {path: launches} of the dense solve at M=256."""
    from scanner_colmap_tpu_torch import kernels
    from scanner_colmap_tpu_torch.ops import ba

    paths = {}
    # (a) dense against CG (the dry run's closure check, cg_iters 64)
    p, o, c = ba.synthetic_bundle(M=256, P=49152, T=4, seed=0, device=dev)
    kernels.reset_launch_counts()
    _, i_d, same_d, ms_d, peak_d = _solve_twice(p, o, c, max_iterations=2)
    paths["ba_scale_dense"] = kernels.launch_counts()
    _, i_c, same_c, ms_c, peak_c = _solve_twice(p, o, c, max_iterations=2, solver="cg",
                                                cg_iters=64)
    c_d, c_c = float(i_d["final_cost"]), float(i_c["final_cost"])
    log(f"cg scale (a) M=256 P=49152 T=4, 2 LM iterations: dense cost "
        f"{float(i_d['initial_cost']):.3f} -> {c_d:.3f} ({ms_d:.1f} ms, peak "
        f"{peak_d / 2**20:.0f} MiB), CG(64) -> {c_c:.3f} ({ms_c:.1f} ms, peak "
        f"{peak_c / 2**20:.0f} MiB), gap {c_c / c_d - 1:.4%}; two runs bitwise equal: "
        f"dense {same_d}, CG {same_c}")
    if not c_c <= CG_SCALE_DENSE_GAP * c_d or not (same_d and same_c):
        raise AssertionError("cg scale (a): CG strays from dense or a solve is not "
                             "reproducible")
    out = {"a": {"dense_cost": c_d, "cg_cost": c_c, "dense_ms": ms_d, "cg_ms": ms_c}}
    for tag, M, P, T in (("b", 1024, 49152, 4), ("c", 2048, 131072, 12)):
        del p, o, c
        secs, t = {}, time.time()
        p, o, c = ba.synthetic_bundle(M=M, P=P, T=T, seed=1, device=dev)
        secs["data"], t = time.time() - t, time.time()
        _, info, same, ms, peak = _solve_twice(p, o, c, max_iterations=10, solver="cg",
                                               cg_iters=32, function_tolerance=0.0)
        secs["two_solves"], t = time.time() - t, time.time()
        its = int(info["iterations"])
        c0, c1 = float(info["initial_cost"]), float(info["final_cost"])
        split = _matvec_split(p, o, c, 32)
        secs["profiled_trials"] = time.time() - t
        bytes_ws = P * (T * 96.0 + 36.0 + 12.0)      # bench.py:398-402, scaled by T
        bound = (32 + 1) * bytes_ws / HBM_BYTES_PER_S * 1e3
        row = {"M": M, "P": P, "T": T, "cg_iters": 32, "lm_iterations": its,
               "initial_cost": c0, "final_cost": c1, "ms_per_lm_iteration": ms / its,
               "matvec": split, "bound_ms_per_lm_iteration": bound,
               "max_memory_allocated_mib": peak / 2**20, "bitwise_equal": same,
               "phase_seconds": secs}
        log(f"cg scale ({tag}): " + json.dumps(row))
        if not c1 < c0 or not same:
            raise AssertionError(f"cg scale ({tag}): the cost did not fall or two runs differ")
        out[tag] = row
    return paths, out


# ---------------------------------------------------------------------------
# phase 12: the dense path
# ---------------------------------------------------------------------------

def k4_problem(dev, H, W, S, seed):
    """A kernel-4 problem at (H, W) with S sources: smooth random images, a
    small-baseline rig, a random candidate field and a second one."""
    from scanner_colmap_tpu_torch.ops import patch_match as pm_ops

    g = np.random.default_rng(seed)

    def smooth(h, w):
        a = g.uniform(size=(h + 4, w + 4))
        return sum(a[i:i + h, j:j + w] for i in range(5) for j in range(5)).astype(np.float32) / 25

    def field():
        n = g.normal(size=(H, W, 3)) * 0.3
        n[..., 2] = -1
        return (up(g.uniform(3.0, 6.0, (H, W)).astype(np.float32)),
                up((n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)))

    up = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    f = 0.9 * max(W, H)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    R = np.stack([np.eye(3) + 0.01 * s * np.array([[0, -1, 0.5], [1, 0, -0.3], [-0.5, 0.3, 0]])
                  for s in range(S)]).astype(np.float32)
    t = np.stack([[0.1 * (s + 1) * (-1) ** s, 0.03 * s, 0.01] for s in range(S)]).astype(np.float32)
    prob = pm_ops.PatchMatchProblem(up(smooth(H, W)), up(np.stack([smooth(H, W) for _ in range(S)])),
                                    up(K), up(np.stack([K] * S)), up(R), up(t), 3.0, 6.0,
                                    up(np.ones(S, bool)))
    return prob, field(), field()


def k4_bound(H, W, S, taps, Hs, Ws):
    """(bytes, operations) of one sweep call: the inputs read once (ref,
    pack, the extra candidates, the state) and the state written once; per
    in-image tap K4_OPS_PER_TAP for its weight (once: it depends on the ref
    image alone), per (tap, candidate, source) K4_OPS_PER_TAP_SOURCE, plus
    the center warp and the finish per (pixel, candidate, source)."""
    C = K4_CANDIDATES
    in_image = sum((W - abs(du)) * (H - abs(dv)) for du, dv in taps.offsets)
    ops = (in_image * (K4_OPS_PER_TAP + C * S * K4_OPS_PER_TAP_SOURCE)
           + C * H * W * S * K4_OPS_PER_PIXEL_SOURCE)
    nbytes = H * W * 4 + S * Hs * Ws * 12 + K4_EXTRA * H * W * 16 + 2 * H * W * 20 + S * 64
    return nbytes, ops


def kernel4_device(prof):
    """(device kernels, device ms) of kernel 4's launches in a finished
    profile, by kernel name: the cost pass, the finish, the tap-weight
    table."""
    n, us = 0, 0.0
    for e in prof.key_averages():
        if "plane_cost" in e.key or "plane_weight" in e.key:
            n += e.count
            us += float(e.self_device_time_total if hasattr(e, "self_device_time_total")
                        else getattr(e, "self_cuda_time_total", 0.0))
    return n, us / 1e3


def check_kernel4(dev, label, H, W, S, radius=5, seed=0):
    """Kernel 4 at one shape against its plain version on the card: the
    initial pass's cost, the tap-weight table, one sweep of ten candidates
    (the state after it and each candidate's cost) bitwise, two sweeps
    bitwise; one sweep call's time by graph replay beside its bound, the
    plain sweep's time (and its device kernels per candidate,
    torch.profiler), the cost pass's resident blocks per SM, and the device
    kernels torch.profiler records for one sweep call given its table, in a
    bare window and in one padded by K4_PROFILE_PAD_S on each side
    (reported, not asserted: late in this process a bare window records
    none; the dense phase asserts the profiled count of a whole pass)."""
    from scanner_colmap_tpu_torch.kernels import plane_cost as pc
    from scanner_colmap_tpu_torch.ops import patch_match as pm_ops
    from scanner_colmap_tpu_torch.utils.metrics import device_work

    prob, (d0, n0), (d1, n1) = k4_problem(dev, H, W, S, seed)
    _, (d2, n2), _ = k4_problem(dev, H, W, S, seed + 10)
    prep = pm_ops._prepare(prob, "field")
    taps = pc.window_taps(radius, 1, 5.0, dev)
    base = (prep.ref, prep.pack, prep.k_ref, prep.k_src, prep.R, prep.t, prep.src_valid, taps)
    weights = pc.tap_weights(prep.ref, taps)
    kern = pc.plane_cost(*base, d0, n0, weights=weights)
    plain = pc.plane_cost_plain(*base, d0, n0)
    err = (kern - plain).abs().max().item()
    same_init = torch.equal(kern, plain) and torch.equal(kern, pc.plane_cost(*base, d0, n0))
    same_weights = torch.equal(weights, pc.tap_weights_plain(prep.ref, taps))
    extras = (torch.stack([d1, d2]), torch.stack([n1, n2]))

    def start():
        return [d0.clone(), n0.clone(), plain.clone()]

    runs = []
    for _ in range(2):
        state, means = start(), torch.empty((K4_CANDIDATES, H, W), device=dev)
        pc.plane_cost_sweep(*base, *state, *extras, weights=weights, means=means)
        runs.append(state + [means])
    state, means = start(), torch.empty((K4_CANDIDATES, H, W), device=dev)
    pc.plane_cost_sweep_plain(*base, *state, *extras, means=means)
    same_sweep = all(torch.equal(a, b) for a, b in zip(runs[0], state + [means]))
    same_runs = all(torch.equal(a, b) for a, b in zip(*runs))
    moved = (runs[0][2] != plain).float().mean().item()
    state = start()
    ms = cuda_ms(lambda: pc.plane_cost_sweep(*base, *state, *extras, weights=weights),
                 graph=True)
    init_ms = cuda_ms(lambda: pc.plane_cost(*base, d0, n0, weights=weights), graph=True)
    plain_ms = cuda_ms(lambda: pc.plane_cost_sweep_plain(*base, *start(), *extras), reps=3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def profiled_sweep(pad_s):
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(pad_s)
            pc.plane_cost_sweep(*base, *state, *extras, weights=weights)
            torch.cuda.synchronize()
            time.sleep(pad_s)
        return kernel4_device(prof)[0]

    per_sweep = {"bare": profiled_sweep(0.0), "padded": profiled_sweep(K4_PROFILE_PAD_S)}
    with torch.profiler.profile(activities=acts) as prof:
        pc.plane_cost_plain(*base, d1, n1)
        torch.cuda.synchronize()
    plain_per_candidate = device_work(prof)["device_kernels"]
    nbytes, ops = k4_bound(H, W, S, taps, H, W)
    y = yardsticks(ms, nbytes, ops, F32_FLOPS, None)
    blocks, tile = pc.occupancy(taps)
    log(f"kernel4 {label} {H}x{W} S={S} R={radius}: initial pass bitwise {same_init} (max "
        f"|err| {err:.3g}), tap weights bitwise {same_weights}, sweep bitwise {same_sweep} "
        f"(cost moved at {moved:.3f} of the pixels), two sweeps bitwise {same_runs}; sweep "
        f"{ms:.4f} ms ({ms / K4_CANDIDATES:.5f} a candidate; initial pass {init_ms:.4f}), "
        f"device kernels a sweep (profiled) {per_sweep}, tile {tile} with {blocks} blocks per "
        f"SM; plain sweep {plain_ms:.1f} ms ({plain_per_candidate} device kernels a candidate); "
        f"bound {y['bound_ms']:.4f} ms ({y['bound_by']}, {ops / 1e9:.2f} GFLOP), share of "
        f"bound {y['share_of_bound']:.4f}")
    if not (same_init and same_weights and same_sweep and same_runs) or not moved > 0:
        raise AssertionError(f"kernel 4 disagrees with its plain version at {label}")
    return {"shape": [H, W, S, radius], "candidates": K4_CANDIDATES, "max_abs_err": err,
            "sweep_bitwise_plain": same_sweep, "ms": ms, "ms_per_candidate": ms / K4_CANDIDATES,
            "initial_pass_ms": init_ms, "plain_ms": plain_ms,
            "plain_ms_per_candidate": plain_ms / K4_CANDIDATES,
            "profiled_device_kernels_per_sweep": per_sweep,
            "plain_device_kernels_per_candidate": plain_per_candidate,
            "tile": list(tile), "blocks_per_sm": blocks,
            "bound_ms_per_candidate": y["bound_ms"] / K4_CANDIDATES,
            "library_note": K4_LIBRARY_NOTE, **y}


def dense_config(cfg, size):
    """bench.py's dense configuration at 192 px (bench.py:457-461) or its
    reference-resolution one at 480 px (bench.py:522-525)."""
    cfg.patch_match.max_image_size = size
    cfg.patch_match.overlap = 4 if size == 192 else 8
    cfg.patch_match.num_iterations = 7
    return cfg


def dense_stage(name, fn, stats):
    """Run one dense stage: wall time after the queue drains, its peak
    allocated memory and kernel 4's launches, into ``stats``."""
    from scanner_colmap_tpu_torch import kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = kernels.launch_counts()["plane_cost"]
    t = time.time()
    out = fn()
    torch.cuda.synchronize()
    stats[name] = {"s": time.time() - t, "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                   "plane_cost": kernels.launch_counts()["plane_cost"] - before}
    return out


def maps_of(store, table="patch_match"):
    tab = store.read_table(table)
    return {int(i): (d, n, c) for i, d, n, c in zip(tab["image_id"], tab["depth_map"],
                                                     tab["normal_map"], tab["cost_map"])}


def cost_calls(n_maps, pm, geom=False, bands=1):
    """Kernel 4's wrapper calls for n_maps depth maps: one initial pass and
    one call a sweep, per level (and band)."""
    per = (1 + pm.num_iterations) + (1 + pm.fine_iterations) * bands
    if geom:
        per += (1 + pm.num_iterations) * bands
    return n_maps * per


def dense_score(model, gt, store):
    from scanner_colmap_tpu_torch.pipeline import synth

    xyz = np.asarray(store.read_table("fused", columns=["xyz"])["xyz"])
    acc = synth.evaluate_dense(model, gt, xyz)
    return len(xyz), acc["median_rel"], acc["p90_rel"]


def within_band(median, fused, band="192"):
    """The surface median within DENSE_MEDIAN_FACTOR x the band's +
    DENSE_MEDIAN_SLACK, and the fused count at least DENSE_FUSED_FRAC of the
    band's where the band has one."""
    ref = DENSE_BANDS[band]
    return (median <= DENSE_MEDIAN_FACTOR * ref["median"] + DENSE_MEDIAN_SLACK
            and fused >= DENSE_FUSED_FRAC * ref.get("fused", 0))


def dense_phase(dev, bf16_run, gt):
    """Phase 12 on the bf16 slice's store: bench.py's dense section at 192
    px (cold, then the warm main path, bitwise equal), fusion, the maps
    through f16, meshing, a geometric pass, then the reference-resolution
    section at 480 px with one map through row bands. Returns ({path:
    launches}, summary)."""
    import copy

    from scanner_colmap_tpu_torch import kernels
    from scanner_colmap_tpu_torch.pipeline import stages, synth
    from scanner_colmap_tpu_torch.utils.metrics import device_work

    cfg0, store, _, model, _ = bf16_run
    cfg = dense_config(copy.deepcopy(cfg0), 192)
    pm = cfg.patch_match
    st, out, paths = {}, {}, {}
    dense_stage("prepare_192", lambda: stages.run_prepare_patch_match(cfg, store), st)
    n_maps = dense_stage("patch_match_192_cold",
                         lambda: stages.run_patch_match(cfg, store, device=dev), st)
    cold = maps_of(store)
    kernels.reset_launch_counts()
    dense_stage("patch_match_192", lambda: stages.run_patch_match(cfg, store, device=dev), st)
    main = kernels.launch_counts()                       # the main path
    warm = maps_of(store)
    bitwise = cold.keys() == warm.keys() and all(
        all(np.array_equal(a, b) for a, b in zip(cold[i], warm[i])) for i in cold)
    want = cost_calls(n_maps, pm)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        stages.run_patch_match(cfg, store, device=dev, out_table="patch_match_profiled")
        torch.cuda.synchronize()
    work = device_work(prof)
    per_map = work["device_kernels"] / max(n_maps, 1)
    k4_n, k4_ms = kernel4_device(prof)
    k4_ms_per_map = k4_ms / max(n_maps, 1)
    n_fused = dense_stage("fusion_192", lambda: stages.run_fusion(cfg, store, device=dev), st)
    fused, med, p90 = dense_score(model, gt, store)
    n_faces = dense_stage("meshing_192", lambda: stages.run_meshing(cfg, store, device=dev), st)
    verts = np.asarray(store.read_table("mesh")["verts"][0])
    mesh = synth.evaluate_dense(model, gt, verts) if len(verts) else {"median_rel": float("inf")}
    out["input"] = ("in-memory frames (render_dataset, lossless, exact focal): the pins, "
                    "not the band")
    out["192px_4src"] = {
        "depth_maps": n_maps, "depth_maps_per_s": n_maps / st["patch_match_192"]["s"],
        "warm_maps_equal_cold": bitwise, "plane_cost_launches": main["plane_cost"],
        "cost_calls": want, "plane_cost_launches_per_map": main["plane_cost"] / n_maps,
        "device_kernels_per_map": per_map,
        "device_busy_ms_per_map": work["device_busy_ms"] / max(n_maps, 1),
        "plane_cost_device_kernels_per_map": k4_n / max(n_maps, 1),
        "plane_cost_device_ms_per_map": k4_ms_per_map, "fused_points": fused,
        "fused_points_per_s": n_fused / st["fusion_192"]["s"], "surface_median_rel": med,
        "surface_p90_rel": p90, "mesh_faces": n_faces, "mesh_median_rel": mesh["median_rel"]}
    paths["dense_192"] = main
    # the JAX stage writes its maps through f16: fuse those beside the f32 maps
    tab = store.read_table("patch_match")
    nrm16 = []
    for nm in tab["normal_map"]:
        nx, ny = (nm[..., k].astype(np.float16).astype(np.float32) for k in (0, 1))
        nrm16.append(np.stack([nx, ny, -np.sqrt(np.maximum(1.0 - nx ** 2 - ny ** 2, 0.0))], -1))
    store.write_table("patch_match", {
        "image_id": tab["image_id"],
        "depth_map": [d.astype(np.float16).astype(np.float32) for d in tab["depth_map"]],
        "normal_map": nrm16,
        "cost_map": [c.astype(np.float16).astype(np.float32) for c in tab["cost_map"]]},
        meta={"stage": "patch_match"})
    n16 = stages.run_fusion(cfg, store, device=dev)
    out["192px_4src"]["fused_points_f16_maps"] = n16
    # the geometric pass
    cfg_g = copy.deepcopy(cfg)
    cfg_g.patch_match.geom_consistency = True
    kernels.reset_launch_counts()
    dense_stage("patch_match_192_geom",
                lambda: stages.run_patch_match(cfg_g, store, device=dev), st)
    paths["dense_192_geom"] = kernels.launch_counts()
    stages.run_fusion(cfg_g, store, device=dev)
    g_fused, g_med, g_p90 = dense_score(model, gt, store)
    out["192px_4src_geom"] = {"fused_points": g_fused, "surface_median_rel": g_med,
                              "surface_p90_rel": g_p90,
                              "plane_cost_launches": paths["dense_192_geom"]["plane_cost"],
                              "cost_calls": cost_calls(n_maps, pm, geom=True)}
    # the reference resolution, one map through row bands
    cfg_h = dense_config(copy.deepcopy(cfg0), 480)
    dense_stage("prepare_480", lambda: stages.run_prepare_patch_match(cfg_h, store), st)
    kernels.reset_launch_counts()
    n_h = dense_stage("patch_match_480", lambda: stages.run_patch_match(cfg_h, store, device=dev),
                      st)
    paths["dense_480"] = kernels.launch_counts()
    untiled = maps_of(store)
    n_fused_h = dense_stage("fusion_480", lambda: stages.run_fusion(cfg_h, store, device=dev), st)
    h_fused, h_med, h_p90 = dense_score(model, gt, store)
    cfg_t = copy.deepcopy(cfg_h)
    cfg_t.patch_match.tile_rows = DENSE_TILE_ROWS
    ref = n_h // 2
    stages.run_patch_match(cfg_t, store, ref_slice=(ref, n_h), out_table="patch_match_tiled",
                           device=dev)
    (iid, (d_t, _, c_t)), = maps_of(store, "patch_match_tiled").items()
    d_u, _, c_u = untiled[iid]
    both = (c_t < 1.9) & (c_u < 1.9) & (d_u > 0)
    tile_diff = float(np.median(np.abs(d_t[both] - d_u[both]) / d_u[both]))
    out["480px_8src"] = {"depth_maps": n_h, "depth_maps_per_s": n_h / st["patch_match_480"]["s"],
                         "fused_points": h_fused,
                         "fused_points_per_s": n_fused_h / st["fusion_480"]["s"],
                         "surface_median_rel": h_med, "surface_p90_rel": h_p90,
                         "plane_cost_launches": paths["dense_480"]["plane_cost"],
                         "tiled_map": {"image_id": iid, "tile_rows": DENSE_TILE_ROWS,
                                       "median_rel_diff_to_untiled": tile_diff,
                                       "pixels_compared": int(both.sum())}}
    out["stages"] = {k: {kk: round(vv, 4) for kk, vv in v.items()} for k, v in st.items()}
    log("dense: " + json.dumps(out))
    d = out["192px_4src"]
    if (not bitwise or main["plane_cost"] != want or fused != DENSE_FUSED_PINNED["192"]
            or k4_n != K4_DEVICE_LAUNCHES * want + K4_LEVELS * n_maps or not n_faces > 0
            or abs(n16 - fused) > F16_FUSED_TOL * fused):
        raise AssertionError(f"dense 192 px: {d}")
    g = out["192px_4src_geom"]
    if g["plane_cost_launches"] != g["cost_calls"] or g_fused != DENSE_FUSED_PINNED["geom"]:
        raise AssertionError(f"dense 192 px, geometric pass: {g}")
    if (h_fused != DENSE_FUSED_PINNED["hires"] or not tile_diff <= DENSE_TILE_MAX_DIFF
            or paths["dense_480"]["plane_cost"] != cost_calls(n_h, cfg_h.patch_match)):
        raise AssertionError(f"dense 480 px: {out['480px_8src']}")
    return paths, out


def band_config(root):
    """tools/exp_dense_band_jax.py's configuration (lines 47-62, the
    configuration that gave DENSE_BANDS): the slice's sparse configuration
    at the default matching precision (bf16), reading ``root``/images."""
    cfg = slice_config(os.path.join(root, "store"), "bf16")
    cfg.image_path = os.path.join(root, "images")
    return cfg


def dense_band_phase(dev, root):
    """Phase 12's bars against the JAX band, on the band's own input:
    bench's 16-image set written as JPEGs by ``generate_dataset`` (quality
    95, the focal through EXIF) and read from the files by prepare_images,
    through the sparse stages and the dense sections at
    tools/exp_dense_band_jax.py's configuration: 192 px with fusion and
    meshing, the geometric pass, 480 px. Every bar is DENSE_BANDS' as it
    was. Returns ({path: launches}, summary)."""
    import copy

    from scanner_colmap_tpu_torch import kernels
    from scanner_colmap_tpu_torch.pipeline import ArtifactStore, stages, synth

    t0 = time.time()
    cfg = band_config(os.path.join(root, "band"))
    gt = synth.generate_dataset(cfg.image_path, num_images=16, width=480, height=360,
                                num_blobs=500, seed=3)
    gt = {**gt, "qvecs": np.asarray(gt["qvecs"]), "tvecs": np.asarray(gt["tvecs"])}
    store = ArtifactStore(cfg.store_path)
    stages.prepare_images(cfg, store)
    kernels.reset_launch_counts()
    model = drive(cfg, store, dev)[0]["merge"]
    ate = synth.evaluate_ate(model, gt)
    out = {"input": "JPEG set (generate_dataset, quality 95, EXIF focal): the band's input",
           "registered": model.num_registered, "ate": ate}
    for tag, size, geom in (("192", 192, False), ("geom", 192, True), ("hires", 480, False)):
        c = dense_config(copy.deepcopy(cfg), size)
        c.patch_match.geom_consistency = geom
        if not geom:
            stages.run_prepare_patch_match(c, store)
        stages.run_patch_match(c, store, device=dev)
        stages.run_fusion(c, store, device=dev)
        fused, med, p90 = dense_score(model, gt, store)
        band = DENSE_BANDS[tag]
        out[tag] = {"fused_points": fused, "surface_median_rel": med, "surface_p90_rel": p90,
                    "bar_median_max": DENSE_MEDIAN_FACTOR * band["median"] + DENSE_MEDIAN_SLACK,
                    "bar_fused_min": DENSE_FUSED_FRAC * band["fused"],
                    "within_band": within_band(med, fused, tag)}
        if tag == "192":
            out[tag]["mesh_faces"] = stages.run_meshing(c, store, device=dev)
            verts = np.asarray(store.read_table("mesh")["verts"][0])
            mesh = (synth.evaluate_dense(model, gt, verts) if len(verts)
                    else {"median_rel": float("inf")})
            out[tag]["mesh_median_rel"] = mesh["median_rel"]
            out[tag]["bar_mesh_median_max"] = (DENSE_MEDIAN_FACTOR * DENSE_BAND["mesh_median"]
                                               + DENSE_MEDIAN_SLACK)
    launches = kernels.launch_counts()
    out["phase_s"] = time.time() - t0
    log("dense band (JPEG set): " + json.dumps(out))
    if (model.num_registered < SLICE_MIN_REGISTERED or not ate <= SLICE_MAX_ATE
            or not all(out[t]["within_band"] for t in DENSE_BANDS)
            or not out["192"]["mesh_median_rel"] <= out["192"]["bar_mesh_median_max"]
            or not out["192"]["mesh_faces"] > 0):
        raise AssertionError(f"dense band on the JPEG set: {out}")
    return {"dense_band_jpeg": launches}, out


def cli_dense_phase(root, gt):
    """Phase 12 on phase 11's real-texture store: ``cli undistort``, then
    ``cli all --resume`` runs the dense stages at PipelineConfig()'s 400 px
    and 5 sources. Returns ({path: launches}, summary)."""
    from scanner_colmap_tpu_torch.pipeline import ArtifactStore, synth

    store_root = os.path.join(root, "real", "store")
    undistort_s = cli(("undistort",), store_root)
    model, metrics, cli_s = run_cli(None, store_root, resume=True, args=("all",))
    store = ArtifactStore(store_root)
    fused = np.asarray(store.read_table("fused", columns=["xyz"])["xyz"])
    verts = np.asarray(store.read_table("mesh")["verts"][0])
    acc = synth.evaluate_dense(model, gt, fused)
    mesh = synth.evaluate_dense(model, gt, verts) if len(verts) else {"median_rel": float("inf")}
    dense = ("prepare_patch_match", "patch_match", "fusion", "meshing")
    out = {"undistorted": store.num_rows("undistorted"), "undistort_cli_s": undistort_s,
           "depth_maps": store.num_rows("patch_match"), "fused_points": len(fused),
           "surface_median_rel": acc["median_rel"], "surface_p90_rel": acc["p90_rel"],
           "mesh_faces": len(store.read_table("mesh")["faces"][0]),
           "mesh_median_rel": mesh["median_rel"], "cli_seconds": cli_s,
           "stage_seconds": {k: round(metrics[k]["wall_s"], 3) for k in dense},
           "stage_peak_mib": {k: round(metrics[k].get("peak_allocated_mib", 0.0), 1)
                              for k in dense},
           "launches": path_launches(metrics)}
    log("cli dense real texture: " + json.dumps(out))
    if (not acc["median_rel"] <= REAL_DENSE_MAX_MEDIAN or not out["fused_points"] > 0
            or not out["mesh_faces"] > 0 or out["launches"]["plane_cost"] <= 0
            or out["undistorted"] != REAL_IMAGES):
        raise AssertionError(f"cli dense real texture: {out}")
    return {"cli_dense_real": out["launches"]}, out


# ---------------------------------------------------------------------------
# phase 13: the scale-out layer
# ---------------------------------------------------------------------------

SCALE_OUT_RANKS = 2
# (tag, M, P, T, solver, LM iterations): phase 3's and phase 9's shapes
DIST_BA_SHAPES = (("dense", 256, 8192, 16, "dense", 8), ("cg", 1024, 49152, 4, "cg", 8))
DIST_CG_ITERS = 32
DIST_BA_RTOL = 1e-5         # world 2 against world 1: f32 sums in another order
DIST_STEP_OVERLAP = 6       # the slice's window
DIST_STEP_BA_ITERATIONS = 3
RANK_TIMEOUT_S = 600


def timed_twice(fn):
    """fn() run twice: (the second run's result, ms of each run, whether
    the two results are bitwise equal); fn returns (params, info)."""
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        runs.append((out, (time.time() - t) * 1e3))
    (a, ia), (b, ib) = runs[0][0], runs[1][0]
    same = _same_params(a, b) and torch.equal(ia["final_cost"], ib["final_cost"])
    return runs[1][0], [ms for _, ms in runs], same


def dist_ba_runs(mesh, dev, solve=None, profile=False):
    """The sharded BA at DIST_BA_SHAPES on ``mesh`` (with ``solve``, that
    solver in its place), twice, with the problem made from its seed on
    every rank alike: {tag: (params, info, ms per LM iteration of the cold
    and the warm run, the two runs bitwise equal, and with ``profile`` the
    device work of a third run under torch.profiler)}."""
    from scanner_colmap_tpu_torch.ops import ba
    from scanner_colmap_tpu_torch.parallel.dist_ba import distributed_bundle_adjust
    from scanner_colmap_tpu_torch.utils.metrics import device_work

    solve = solve or (lambda *a, **kw: distributed_bundle_adjust(mesh, *a, **kw))
    out = {}
    for tag, M, P, T, solver, iters in DIST_BA_SHAPES:
        p, o, c = ba.synthetic_bundle(M=M, P=P, T=T, seed=2, device=dev)

        def run():
            return solve(p, o, c, max_iterations=iters, solver=solver,
                         cg_iters=DIST_CG_ITERS, function_tolerance=0.0)

        (q, info), ms, same = timed_twice(run)
        work = None
        if profile:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                run()
                torch.cuda.synchronize()
            work = device_work(prof)
            its = int(info["iterations"])
            work["device_busy_ms_per_lm_iteration"] = work["device_busy_ms"] / its
            dev_us = {e.key[:48]: float(getattr(e, "self_device_time_total",
                                                getattr(e, "self_cuda_time_total", 0.0)))
                      for e in prof.key_averages()
                      if "CUDA" in str(getattr(e, "device_type", ""))}
            work["top_device_ms_per_lm_iteration"] = {
                k: v / 1e3 / its for k, v in sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]}
        out[tag] = (q, info, [t / int(info["iterations"]) for t in ms], same, work)
    return out


def dist_ba_padded(mesh, dev):
    """The dense shape of DIST_BA_SHAPES with its points padded by invalid
    ones (zero xyz, no observation, pt_valid False) to SCALE_OUT_RANKS
    times their number, solved once: in the ranks the first shard is the
    whole problem and every other one only padding (kernel 2, its launch
    plan and the sums on a shard of padding). (params, info)."""
    from scanner_colmap_tpu_torch.ops import ba
    from scanner_colmap_tpu_torch.parallel.dist_ba import distributed_bundle_adjust

    _, M, P, T, solver, iters = DIST_BA_SHAPES[0]
    p, o, c = ba.synthetic_bundle(M=M, P=P, T=T, seed=2, device=dev)

    def pad(t):
        return torch.cat([t, t.new_zeros(((SCALE_OUT_RANKS - 1) * P,) + t.shape[1:])])

    p = dataclasses.replace(p, xyz=pad(p.xyz))
    o = dataclasses.replace(o, cam_idx=pad(o.cam_idx), uv=pad(o.uv), valid=pad(o.valid))
    c = dataclasses.replace(c, pt_valid=pad(c.pt_valid))
    return distributed_bundle_adjust(mesh, p, o, c, max_iterations=iters, solver=solver,
                                     cg_iters=DIST_CG_ITERS, function_tolerance=0.0)


def step_problem(store, model, world):
    """The fused step's inputs on the host: the bf16 slice's descriptors
    (N, K_max, 128) as the stage pools them, their validity, and the slice's
    merged model packed as the merge's global BA packs it, its points
    padded to a multiple of ``world`` with invalid ones."""
    from scanner_colmap_tpu_torch.engine.bundle_io import pack_bundle_flat
    from scanner_colmap_tpu_torch.ops import ba
    from scanner_colmap_tpu_torch.parallel.mesh import pad_to_shards
    from scanner_colmap_tpu_torch.pipeline import stages

    image_ids, _, desc, _ = stages._load_extraction(store)
    K = -(-max(len(desc[i]) for i in image_ids) // 128) * 128
    raw, valid = stages._bank_rows(image_ids, desc, range(len(image_ids)), K, np.uint8)
    cam_in, pt_in, obs_in, _ = pack_bundle_flat(model, model.registered_image_ids)
    cam_in[0, 12:18] = 0.0
    cam_in[1, 15] = 0.0
    pt_in, _ = pad_to_shards(np.asarray(pt_in), world)
    obs_in, _ = pad_to_shards(np.asarray(obs_in), world)
    params, obs, cfg, _ = ba.flat_problem(cam_in, pt_in, obs_in, [1.0, 1.0, 4.0],
                                          torch.device("cpu"))
    return {"desc": torch.from_numpy(raw), "valid": torch.from_numpy(valid),
            "bundle": (params, obs, cfg)}


def dist_step_run(mesh, prob):
    """(match_idx, match_ok, params, info, ms) of the fused step."""
    from scanner_colmap_tpu_torch.parallel.step import make_distributed_step

    step = make_distributed_step(mesh, DIST_STEP_OVERLAP, DIST_STEP_BA_ITERATIONS)
    torch.cuda.synchronize()
    t = time.time()
    idx, ok, q, info = step(prob["desc"], prob["valid"], *prob["bundle"])
    torch.cuda.synchronize()
    return idx, ok, q, info, (time.time() - t) * 1e3


def dist_stages_run(cfg, store, dev):
    """bench's 16-image set through the multi-host stages, then PatchMatch
    at 192 px over contiguous reference blocks. Returns the model."""
    from scanner_colmap_tpu_torch.parallel import dist as tdist
    from scanner_colmap_tpu_torch.pipeline import stages

    for name in ("extraction", "matching", "mapping"):
        getattr(tdist, f"run_{name}_distributed")(cfg, store, device=dev)
    model = tdist.run_merge_distributed(cfg, store, device=dev)
    if tdist.process_info()[0] == 0:
        stages.run_prepare_patch_match(dense_config(cfg, 192), store)
    tdist.barrier_via_store(store, "prepare_patch_match_done")
    tdist.run_patch_match_distributed(dense_config(cfg, 192), store, device=dev)
    torch.cuda.synchronize()
    return model


def _cpu(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _cpu(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_cpu(v) for v in x)
    return x.cpu() if isinstance(x, torch.Tensor) else x


def scaleout_rank(rank, work):
    """One of the SCALE_OUT_RANKS gloo ranks of phase 13 (a subprocess of the
    smoke run, on cuda:0 beside the other rank): the sharded BA, the fused
    step, the multi-host stages and the loop set's sharded matching, with
    the launches of each path; results into ``work``/rank<r>.pt."""
    from scanner_colmap_tpu_torch import device as devlib
    from scanner_colmap_tpu_torch.parallel import dist as tdist
    from scanner_colmap_tpu_torch.parallel.mesh import make_mesh
    from scanner_colmap_tpu_torch.pipeline import ArtifactStore, PipelineConfig

    with open(os.path.join(work, "jobs.json")) as f:
        jobs = json.load(f)
    dev = torch.device(jobs["device"])          # every rank on the parent's card
    torch.cuda.set_device(dev)
    devlib.setup_numerics()
    tdist.maybe_init_distributed(f"file://{os.path.join(work, 'gloo_init')}",
                                 SCALE_OUT_RANKS, rank, backend="gloo")
    mesh = make_mesh(device=dev)
    out, launches, replays = {}, {}, {}

    def path(name, fn):
        res, launches[name], replays[name] = tapped_path(fn, f"{name} rank {rank}")
        return res

    out["ba"], out["ba_padded"] = path("dist_ba", lambda: (
        _cpu(dist_ba_runs(mesh, dev)), _cpu(dist_ba_padded(mesh, dev))))
    step = torch.load(os.path.join(work, "step.pt"), weights_only=False)
    out["step"] = path("dist_step", lambda: _cpu(dist_step_run(mesh, step)))
    path("dist_stages", lambda: dist_stages_run(
        PipelineConfig.from_json(jobs["stages"]["cfg"]), ArtifactStore(jobs["stages"]["root"]),
        dev))
    path("dist_loop_f32", lambda: tdist.run_matching_distributed(
        PipelineConfig.from_json(jobs["loop"]["cfg"]), ArtifactStore(jobs["loop"]["root"]),
        device=dev))
    out["launches"], out["replays"] = launches, replays
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _same_tables(sa, sb, table):
    """Whether two stores' tables hold the same rows in the same order,
    bitwise."""
    ta, tb = sa.read_table(table), sb.read_table(table)
    if sorted(ta) != sorted(tb):
        return False
    return all(len(ta[c]) == len(tb[c]) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(ta[c], tb[c]))
        for c in ta)


def _same_params(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("qvec", "tvec", "log_f", "k1", "xyz"))


def scaleout_phase(dev, bf16_run, frames, gt, root):
    """Phase 13: the scale-out layer. (a) World 1 on NCCL in this process:
    the sharded BA bitwise ``bundle_adjust`` (dense at M=256, P=8192, T=16;
    CG at M=1024, P=49152, T=4), the fused step on the bf16 slice's
    extraction with its matches against kernel 1's resident plan, pair by
    pair, and the multi-host stages. (b) SCALE_OUT_RANKS gloo ranks as
    subprocesses sharing cuda:0: the same BA (final cost within
    DIST_BA_RTOL of world 1; the ranks bitwise equal), the same step, the
    multi-host stages on bench's 16-image set (extraction, matching,
    mapping shards and depth maps bitwise world 1's; the merge >= 15/16 at
    ATE <= 0.012) and the 48-image loop set's f32 matching with closure on
    (no pair twice, the table world 1's). Returns ({path: launches},
    summary)."""
    from scanner_colmap_tpu_torch import kernels
    from scanner_colmap_tpu_torch.ops import ba, matching
    from scanner_colmap_tpu_torch.parallel import dist as tdist
    from scanner_colmap_tpu_torch.parallel.mesh import make_mesh
    from scanner_colmap_tpu_torch.pipeline import ArtifactStore, stages

    t_phase = time.time()
    work = os.path.join(root, "scaleout")
    os.makedirs(work)
    paths, summary, replays = {}, {}, {}

    def new_store(name, precision, tables=(), src=None):
        """A slice-configured store with bench's frames, or with the given
        tables of the store at ``src``."""
        c = slice_config(os.path.join(work, name), precision)
        s = ArtifactStore(c.store_path)
        if src is None:
            stages.prepare_images(c, s, frames=[(f, gt["focal"]) for f in frames])
        for t in tables:
            shutil.copytree(os.path.join(src, t), os.path.join(s.root, t))
        return c, s

    loop_src = os.path.join(root, "loop_auto")
    tdist.maybe_init_distributed(f"file://{os.path.join(work, 'nccl_init')}", 1, 0,
                                 device=dev)          # NCCL on the card
    try:
        mesh = make_mesh(device=dev)
        # (a) world 1: the sharded BA against the single-process solve
        plain = dist_ba_runs(mesh, dev, solve=ba.bundle_adjust)
        w1_ba, paths["dist_ba"], replays["dist_ba"] = tapped_path(
            lambda: dist_ba_runs(mesh, dev), "dist_ba")
        profiled_ba = dist_ba_runs(mesh, dev, profile=True)
        for tag, M, P, T, solver, iters in DIST_BA_SHAPES:
            q, info, ms, _, _ = plain[tag]
            q1, info1, ms1, rerun_same, _ = w1_ba[tag]
            same = _same_params(q, q1) and torch.equal(info["final_cost"], info1["final_cost"])
            summary[f"ba_{tag}_world1"] = {
                "M": M, "P": P, "T": T, "lm_iterations": int(info1["iterations"]),
                "initial_cost": float(info1["initial_cost"]),
                "final_cost": float(info1["final_cost"]),
                "ms_per_lm_iteration_cold_warm": ms1,
                "bundle_adjust_ms_per_lm_iteration_cold_warm": ms,
                "profiled_run": profiled_ba[tag][4],
                "bitwise_equal_to_bundle_adjust": same, "reruns_bitwise_equal": rerun_same}
            if (not same or not rerun_same
                    or not float(info1["final_cost"]) < float(info1["initial_cost"])):
                raise AssertionError(f"scale-out: world-1 {tag} BA is not bundle_adjust's "
                                     f"bitwise, a rerun differs, or its cost did not fall: "
                                     f"{summary}")

        # the fused step on the slice's extraction, against the resident plan
        cfg, store = bf16_run[:2]
        prob = step_problem(store, bf16_run[3], SCALE_OUT_RANKS)
        (idx1, ok1, qs1, infos1, ms_step1), paths["dist_step"], replays["dist_step"] = \
            tapped_path(lambda: dist_step_run(mesh, prob), "dist_step")
        n_img, K = prob["valid"].shape
        pairs = [(a, a + j) for a in range(n_img) for j in range(1, DIST_STEP_OVERLAP + 1)
                 if a + j < n_img]
        pool = matching.normalize_pool(prob["desc"].to(dev))
        ab = torch.tensor(pairs, dtype=torch.int32, device=dev)
        ref = matching.match_pairs_pool(pool, prob["valid"].to(dev), ab[:, 0].contiguous(),
                                        ab[:, 1].contiguous())
        mine = torch.stack([idx1[a, b - a - 1] for a, b in pairs]).long()
        same_pairs = int((mine == ref).all(dim=1).sum())
        summary["step_world1"] = {
            "images": n_img, "K": K, "overlap": DIST_STEP_OVERLAP, "pairs": len(pairs),
            "pairs_equal_to_resident_plan": same_pairs, "matches": int(ok1.sum()),
            "points": int(prob["bundle"][0].xyz.shape[0]),
            "ba_initial_cost": float(infos1["initial_cost"]),
            "ba_final_cost": float(infos1["final_cost"]), "ms": ms_step1,
            "launches": paths["dist_step"]}
        log("scale-out (a): " + json.dumps({k: v for k, v in summary.items()}))
        if (same_pairs != len(pairs) or paths["dist_step"]["pair_match"] != 1
                or not float(infos1["final_cost"]) <= float(infos1["initial_cost"])):
            raise AssertionError(f"scale-out: the world-1 step: {summary['step_world1']}")

        # the multi-host stages at world 1
        cfg1, store1 = new_store("stages_w1", "bf16")
        t = time.time()
        model1, paths["dist_stages"], replays["dist_stages"] = tapped_path(
            lambda: dist_stages_run(cfg1, store1, dev), "dist_stages")
        summary["stages_world1_s"] = time.time() - t
        cfgl1, storel1 = new_store("loop_w1", "f32", ("frames", "extraction"), loop_src)
        cfgl1.matching.loop_closure = "on"
        _, paths["dist_loop_f32"], replays["dist_loop_f32"] = tapped_path(
            lambda: tdist.run_matching_distributed(cfgl1, storel1, device=dev),
            "dist_loop_f32")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()

    # (b) the ranks
    cfg2, store2 = new_store("stages_w2", "bf16")
    cfgl2, storel2 = new_store("loop_w2", "f32", ("frames", "extraction"), loop_src)
    cfgl2.matching.loop_closure = "on"
    with open(os.path.join(work, "jobs.json"), "w") as f:
        json.dump({"device": str(dev),
                   "stages": {"root": store2.root, "cfg": cfg2.to_json()},
                   "loop": {"root": storel2.root, "cfg": cfgl2.to_json()}}, f)
    torch.save(prob, os.path.join(work, "step.pt"))
    t = time.time()
    logs = [open(os.path.join(work, f"rank{r}.log"), "w") for r in range(SCALE_OUT_RANKS)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--scaleout-rank",
                               str(r), work], stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(SCALE_OUT_RANKS)]
    try:
        for p in procs:
            p.wait(timeout=max(RANK_TIMEOUT_S - (time.time() - t), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    ranks_s = time.time() - t
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(work, f"rank{r}.log")) as f:
                tail = f.read()[-6000:]
            raise AssertionError(f"scale-out: rank {r} exited {p.returncode}:\n{tail}")
    res = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
           for r in range(SCALE_OUT_RANKS)]

    # the sharded BA: ranks bitwise equal, costs within DIST_BA_RTOL of world 1
    for tag, M, P, T, solver, iters in DIST_BA_SHAPES:
        qs = [r["ba"][tag][0] for r in res]
        costs = [float(r["ba"][tag][1]["final_cost"]) for r in res]
        c1 = float(w1_ba[tag][1]["final_cost"])
        same = all(all(torch.equal(qs[0][f], q[f]) for f in qs[0]) for q in qs[1:]) \
            and len(set(costs)) == 1 and all(r["ba"][tag][3] for r in res)
        summary[f"ba_{tag}_world{SCALE_OUT_RANKS}"] = {
            "final_cost": costs[0], "world1_final_cost": c1,
            "rel_diff": abs(costs[0] - c1) / c1,
            "ms_per_lm_iteration_cold_warm": [r["ba"][tag][2] for r in res],
            "ranks_and_reruns_bitwise_equal": same}
        if not same or not abs(costs[0] - c1) <= DIST_BA_RTOL * c1:
            raise AssertionError(f"scale-out: {tag} BA in {SCALE_OUT_RANKS} ranks: {summary}")

    # the padded BA: the first shard is world 1's whole problem and every sum
    # adds the other shards' zeros, so it is world 1's solve bitwise
    q1, info1 = w1_ba["dense"][:2]
    P = q1.xyz.shape[0]
    qp = [r["ba_padded"][0] for r in res]
    same_ranks = all(all(torch.equal(qp[0][f], q[f]) for f in qp[0]) for q in qp[1:])
    same_w1 = (all(torch.equal(qp[0][f], getattr(q1, f).cpu())
                   for f in ("qvec", "tvec", "log_f", "k1"))
               and torch.equal(qp[0]["xyz"][:P], q1.xyz.cpu())
               and torch.equal(res[0]["ba_padded"][1]["final_cost"], info1["final_cost"].cpu()))
    pad_calls = [r["replays"]["dist_ba"]["schur"].get("padding_calls", 0) for r in res]
    summary[f"ba_padded_world{SCALE_OUT_RANKS}"] = {
        "points": P, "padded_to": int(qp[0]["xyz"].shape[0]),
        "ranks_bitwise_equal": same_ranks, "bitwise_equal_world1_dense": same_w1,
        "padding_stays_zero": not qp[0]["xyz"][P:].any().item(),
        "kernel2_padding_calls_by_rank": pad_calls}
    if not (same_ranks and same_w1 and not qp[0]["xyz"][P:].any() and all(pad_calls[1:])):
        raise AssertionError(f"scale-out: the padded BA in {SCALE_OUT_RANKS} ranks: "
                             f"{summary[f'ba_padded_world{SCALE_OUT_RANKS}']}")

    # the step: the ranks' matches are world 1's, their BA agrees
    idx2 = torch.cat([r["step"][0] for r in res])
    costs = [float(r["step"][3]["final_cost"]) for r in res]
    c1 = float(infos1["final_cost"])
    same_xyz = all(torch.equal(res[0]["step"][2]["xyz"], r["step"][2]["xyz"]) for r in res)
    summary[f"step_world{SCALE_OUT_RANKS}"] = {
        "matches_equal_world1": bool(torch.equal(idx2, idx1.cpu())),
        "ba_final_cost": costs[0], "ranks_bitwise_equal": same_xyz and len(set(costs)) == 1,
        "ms": [r["step"][4] for r in res]}
    if (not torch.equal(idx2, idx1.cpu()) or not same_xyz or len(set(costs)) != 1
            or not abs(costs[0] - c1) <= DIST_BA_RTOL * c1):
        raise AssertionError(f"scale-out: the step in {SCALE_OUT_RANKS} ranks: {summary}")

    # the stages: tables bitwise world 1's, the model within the slice's limits
    same_tables = {t: _same_tables(store2, store1, t)
                   for t in ("extraction", "matching", "mapping", "patch_match")}
    model2 = stages.load_model(store2)
    n_sub = store2.num_rows("mapping")
    ate2 = check_model("scale-out merge", model2, gt, n_sub)
    lc = store2.read_manifest("matching_shard_0")["meta"]["loop_closure"]
    prs = [tuple(p) for p in np.asarray(storel2.read_table("matching")["pair_image_ids"])]
    lcs = [storel2.read_manifest(f"matching_shard_{r}")["meta"]["loop_closure"]
           for r in range(SCALE_OUT_RANKS)]
    far = int(sum(abs(a - b) > LOOP_FAR for a, b in prs))
    loop_same = _same_tables(storel2, storel1, "matching")
    rank_paths = {p: {k: sum(r["launches"][p][k] for r in res) for k in res[0]["launches"][p]}
                  for p in res[0]["launches"]}
    summary[f"stages_world{SCALE_OUT_RANKS}"] = {
        "tables_equal_world1": same_tables, "registered": model2.num_registered,
        "submodels": n_sub, "ate": ate2, "same_model_as_world1": same_model(model2, model1),
        "depth_maps": store2.num_rows("patch_match"), "loop_closure_16": lc,
        "loop_set": {"pairs": len(prs), "unique_pairs": len(set(prs)), "far_pairs": far,
                     "candidates": [m["n_candidates"] for m in lcs],
                     "candidates_total": lcs[0]["candidates_total"],
                     "table_equals_world1": loop_same},
        "ranks_s": ranks_s, "launches_by_path_summed_over_ranks": rank_paths}
    for p, c in rank_paths.items():
        paths[f"{p}_{SCALE_OUT_RANKS}ranks"] = c
    for r, x in enumerate(res):
        replays.update({f"{p}_rank{r}": v for p, v in x["replays"].items()})
    summary["replays"] = replays
    summary["phase_s"] = time.time() - t_phase
    log("scale-out (b): " + json.dumps(summary[f"ba_dense_world{SCALE_OUT_RANKS}"]) + " "
        + json.dumps(summary[f"ba_cg_world{SCALE_OUT_RANKS}"]))
    log("scale-out (b): " + json.dumps(summary[f"ba_padded_world{SCALE_OUT_RANKS}"]))
    log("scale-out (b): " + json.dumps(summary[f"step_world{SCALE_OUT_RANKS}"]))
    log("scale-out (b): " + json.dumps(summary[f"stages_world{SCALE_OUT_RANKS}"]))
    if not all(same_tables.values()) or not loop_same or len(prs) != len(set(prs)):
        raise AssertionError(f"scale-out: the {SCALE_OUT_RANKS}-rank tables differ from "
                             "world 1's, or a loop pair was matched twice")
    if not (lcs[0]["enabled"] and sum(m["n_candidates"] for m in lcs)
            == lcs[0]["candidates_total"] > 0 and far > 0):
        raise AssertionError(f"scale-out: the loop set's closure: {lcs}, {far} far pairs")
    need = {"dist_ba": ("schur",), "dist_step": ("pair_match", "schur"),
            "dist_stages": ("pair_match", "schur", "plane_cost"), "dist_loop_f32": ("top2",)}
    for p, names in need.items():
        for src in (p, f"{p}_{SCALE_OUT_RANKS}ranks"):
            if any(paths[src][n] <= 0 for n in names):
                raise AssertionError(f"scale-out: {names} not all launched on {src}: "
                                     f"{paths[src]}")
    log(f"scale-out: phase 13 took {summary['phase_s']:.2f} s ({ranks_s:.2f} s in the "
        f"{SCALE_OUT_RANKS} ranks); launches by path {json.dumps(paths)}")
    return paths, summary


# ---------------------------------------------------------------------------
# phase 14: the options
# ---------------------------------------------------------------------------

def mapping_pass(dev, cfg, store, batched, tap=None):
    """One run_mapping in per-cluster or batched mode: (seconds on the host
    clock after torch.cuda.synchronize(), the kernels' launches, the
    manifest's device_stats). With a KernelTap ``tap``, under it."""
    from scanner_colmap_tpu_torch import kernels
    from scanner_colmap_tpu_torch.pipeline import stages

    cfg.mapper.device_batch_clusters = batched
    kernels.reset_launch_counts()
    with tap or contextlib.nullcontext():
        t = time.time()
        stages.run_mapping(cfg, store, device=dev)
        torch.cuda.synchronize()
        secs = time.time() - t
    return secs, kernels.launch_counts(), store.read_manifest("mapping")["meta"]["device_stats"]


def check_batched(tag, stats, per_registered, launches, per_launches):
    """Batched mapping against per-cluster mode: each cluster's registered
    count (before any host retry) within OPTIONS_CLUSTER_SLACK, and fewer
    kernel-2 launches."""
    if not stats["batched"] or len(stats["registered"]) != len(per_registered):
        raise AssertionError(f"options {tag}: the batched mapper did not run: {stats}")
    off = [(c, a, b) for c, (a, b) in enumerate(zip(stats["registered"], per_registered))
           if abs(a - b) > OPTIONS_CLUSTER_SLACK]
    if off:
        raise AssertionError(f"options {tag}: (cluster, batched, per-cluster) registered "
                             f"apart: {off}")
    if not 0 < launches["schur"] < per_launches:
        raise AssertionError(f"options {tag}: kernel 2 launched {launches['schur']} times "
                             f"batched against {per_launches} per cluster")


def uncalibrated_pairs(dev, cfg, store):
    """The slice's CALIBRATED verified pairs through the uncalibrated
    estimator on the card (their table matches, K and size as verification
    takes them, each pair's own generator): (configs, inlier counts)."""
    from scanner_colmap_tpu_torch.ops import two_view as tv
    from scanner_colmap_tpu_torch.pipeline import stages

    m = cfg.matching
    image_ids, kp, _, cameras = stages._load_extraction(store)
    row = {iid: n for n, iid in enumerate(image_ids)}
    mt = store.read_table("matching")
    prs = np.asarray(mt["pair_image_ids"]).reshape(-1, 2)
    sel = [n for n in range(len(prs)) if int(mt["two_view_geometry"][n][0]) == tv.CALIBRATED]
    N = max(len(np.asarray(mt["matches"][n]).reshape(-1, 2)) for n in sel)
    C = len(sel)
    x1, x2 = np.zeros((C, N, 2), np.float32), np.zeros((C, N, 2), np.float32)
    valid = np.zeros((C, N), bool)
    K1, K2 = np.zeros((C, 3, 3), np.float32), np.zeros((C, 3, 3), np.float32)
    sz1, sz2 = np.zeros((C, 2), np.float32), np.zeros((C, 2), np.float32)
    gens = []
    for k, n in enumerate(sel):
        a, b = (int(v) for v in prs[n])
        mm = np.asarray(mt["matches"][n]).reshape(-1, 2)
        x1[k, :len(mm)], x2[k, :len(mm)] = kp[a][mm[:, 0], :2], kp[b][mm[:, 1], :2]
        valid[k, :len(mm)] = True
        K1[k], K2[k] = stages._cam_K(cameras[a]), stages._cam_K(cameras[b])
        sz1[k], sz2[k] = cameras[a][2:4], cameras[b][2:4]
        gens.append(stages.pair_generator(dev, row[a], row[b]))
    t = lambda x: torch.as_tensor(x, device=dev)     # noqa: E731
    g = tv.estimate_two_view_geometry(
        gens, t(x1), t(x2), t(valid), t(K1), t(K2), calibrated=False,
        max_error=m.max_error, min_num_inliers=m.min_num_inliers,
        min_inlier_ratio=m.min_inlier_ratio, num_trials=min(m.max_num_trials, 4096),
        min_num_trials=m.min_num_trials, confidence=m.confidence,
        watermark_detection=m.detect_watermark, size1=t(sz1), size2=t(sz2))
    return g.config.cpu().numpy(), g.num_inliers.cpu().numpy()


def options_phase(dev, root, bf16_run, frames, gt, loop_info, scale_info):
    """Phase 14: the batched mapper on phase 10's 200-image store and phase
    7's loop set, the connectivity schedule and video input on the slice,
    and uncalibrated two-view on the slice's verified pairs. Returns
    ({path: launches}, a summary with the batched paths' replays)."""
    from scanner_colmap_tpu_torch.ops import two_view as tv
    from scanner_colmap_tpu_torch.pipeline import ArtifactStore, stages, synth
    from scanner_colmap_tpu_torch.utils import flops

    t_phase = time.time()
    peak = flops.device_peak_tflops(torch.cuda.get_device_name(0), "f32")
    paths, out, replays = {}, {}, {}

    # kernel 2 over a chunk's lanes at the 200-image set's cluster shape
    out["kernel2_lanes"] = check_kernel2_lanes(dev, 8, 16, 2048, 12)

    # (a) the batched mapper: 200 images against phase 10's per-cluster run
    sc = scale_info
    per_stats = sc["store"].read_manifest("mapping")["meta"]["device_stats"]
    per_launches = {k: int(v) for k, v in path_launches({"mapping": sc["metrics"]["mapping"]}).items()}
    tap = KernelTap(check_schur_now=True)
    secs, launches, stats = mapping_pass(dev, sc["cfg"], sc["store"], True, tap)
    replays["options_batched_200"] = tap.replay("options_batched_200", launches)
    paths["options_batched_200"] = launches
    t = time.time()
    model = stages.run_merge(sc["cfg"], sc["store"], device=dev)
    torch.cuda.synchronize()
    merge_s = time.time() - t
    ate = synth.evaluate_ate(model, sc["gt"])
    out["200"] = {"registered": model.num_registered, "ate": ate, "ate_rel_span": ate / sc["span"],
                  "chunks": stats["chunks"], "batched_mapping_s_tapped": secs,
                  "merge_s": merge_s, "per_cluster_mapping_s_cli": sc["metrics"]["mapping"]["wall_s"],
                  "schur_launches": {"batched": launches["schur"],
                                     "per_cluster": per_launches["schur"]},
                  "registered_per_cluster": {"batched": stats["registered"],
                                             "per_cluster": per_stats["registered"]},
                  "scheduled_tflop": stats["scheduled_tflop"]}
    log("options batched 200: " + json.dumps(out["200"]))
    if model.num_registered < SCALE_MIN_REGISTERED or not ate <= SCALE_MAX_ATE_SPAN * sc["span"]:
        raise AssertionError(f"options: batched 200 registered {model.num_registered}, "
                             f"ATE {ate} of span {sc['span']}")
    check_batched("200", stats, per_stats["registered"], launches, per_launches["schur"])

    # the loop set: batched (every kernel-2 call checked), the merge, then
    # both modes timed in turns
    lp = loop_info
    tap = KernelTap(check_schur_now=True)
    secs, launches, stats = mapping_pass(dev, lp["cfg"], lp["store"], True, tap)
    replays["options_batched_loop"] = tap.replay("options_batched_loop", launches)
    paths["options_batched_loop"] = launches
    model = stages.run_merge(lp["cfg"], lp["store"], device=dev)
    ate = synth.evaluate_ate(model, lp["gt"])
    timed = {"per_cluster": [], "batched": []}
    counts = {}
    for _ in range(OPTIONS_TIMED_RUNS):
        for mode in ("per_cluster", "batched"):
            s_, l_, st_ = mapping_pass(dev, lp["cfg"], lp["store"], mode == "batched")
            timed[mode].append(s_)
            counts[mode] = (l_, st_)
    paths["options_per_cluster_loop"] = counts["per_cluster"][0]
    sched = stats["scheduled_tflop"]
    out["loop"] = {
        "registered": model.num_registered, "ate": ate, "ate_off": lp["ate_off"],
        "chunks": stats["chunks"], "warm_mapping_s": timed,
        "schur_launches": {m_: counts[m_][0]["schur"] for m_ in counts},
        "registered_per_cluster": {m_: counts[m_][1]["registered"] for m_ in counts},
        "scheduled_tflop": sched,
        "scheduled_share_of_f32_peak": {m_: sched / (statistics.median(v) * peak)
                                        for m_, v in timed.items()}}
    log("options batched loop: " + json.dumps(out["loop"]))
    if model.num_registered < LOOP_MIN_REGISTERED or \
            not ate <= LOOP_ATE_FACTOR * lp["ate_off"] + 1e-4:
        raise AssertionError(f"options: batched loop set registered {model.num_registered}, "
                             f"ATE {ate} (without closure {lp['ate_off']})")
    check_batched("loop", counts["batched"][1], counts["per_cluster"][1]["registered"],
                  counts["batched"][0], counts["per_cluster"][0]["schur"])

    # (b) the connectivity schedule on the slice's bf16 tables
    src = bf16_run[1]
    cfg = slice_config(os.path.join(root, "connectivity"), "bf16")
    cfg.mapper.device_schedule = "connectivity"
    store = ArtifactStore(cfg.store_path)
    for table in ("frames", "extraction", "matching"):
        shutil.copytree(os.path.join(src.root, table), os.path.join(store.root, table))
    outs, per_stage = drive(cfg, store, dev, ("mapping", "merge"))
    paths["options_connectivity"] = {k: sum(v[k] for v in per_stage.values())
                                     for k in per_stage["mapping"]}
    ate = check_model("options connectivity", outs["merge"], gt, outs["mapping"],
                      min_registered=len(frames))
    out["connectivity"] = {"registered": outs["merge"].num_registered,
                           "submodels": outs["mapping"], "ate": ate}

    # (c) video: the slice's frames in one animated PNG (lossless) through
    # the command line, against a directory of the same frames as PNGs
    from PIL import Image

    vroot = os.path.join(root, "video")
    os.makedirs(os.path.join(vroot, "frames"))
    pil = [Image.fromarray(f).convert("RGB") for f in frames]
    for i, im in enumerate(pil):
        im.save(os.path.join(vroot, "frames", f"frame_{i:06d}.png"))
    pil[0].save(os.path.join(vroot, "slice.apng"), format="PNG", save_all=True,
                append_images=pil[1:])
    cfg = slice_config(os.path.join(vroot, "store"), "bf16")
    cfg.image_path = os.path.join(vroot, "slice.apng")
    model, metrics, cli_s = run_cli(cfg, cfg.store_path, resume=False)
    paths["options_video"] = path_launches(metrics)
    cfg_dir = slice_config(os.path.join(vroot, "dir_store"), "bf16")
    cfg_dir.image_path = os.path.join(vroot, "frames")
    store_dir = ArtifactStore(cfg_dir.store_path)
    stages.prepare_images(cfg_dir, store_dir)
    stages.run_extraction(cfg_dir, store_dir, device=dev)
    same = _same_tables(ArtifactStore(cfg.store_path), store_dir, "extraction")
    ate = synth.evaluate_ate(model, gt)
    out["video"] = {"registered": model.num_registered, "ate": ate, "cli_s": cli_s,
                    "extraction_equals_directory_run": same,
                    "frames": len(os.listdir(os.path.join(vroot, "store", "video_frames")))}
    log("options video: " + json.dumps(out["video"]))
    if not same or model.num_registered != len(frames):
        raise AssertionError(f"options: video {out['video']}")

    # (d) uncalibrated two-view on the slice's verified pairs
    configs, inliers = uncalibrated_pairs(dev, *bf16_run[:2])
    kinds = {int(k): int(v) for k, v in zip(*np.unique(configs, return_counts=True))}
    out["uncalibrated"] = {"pairs": len(configs), "configs": kinds,
                           "min_inliers": int(inliers.min())}
    log("options uncalibrated: " + json.dumps(out["uncalibrated"]))
    if not set(kinds) <= {tv.UNCALIBRATED, tv.PLANAR_OR_PANORAMIC, tv.WATERMARK} \
            or inliers.min() < UNCAL_MIN_INLIERS:
        raise AssertionError(f"options: uncalibrated two-view {out['uncalibrated']}")

    out["phase_s"] = time.time() - t_phase
    out["replays"] = replays
    log(f"options: phase 14 took {out['phase_s']:.2f} s; launches by path {json.dumps(paths)}")
    return paths, out


# ---------------------------------------------------------------------------
# phase 15: batched, windowed extraction
# ---------------------------------------------------------------------------

EXTRACT_BATCHES = (1, 4, 8)
EXTRACT_TIMED_RUNS = 3          # warm passes of each batch size over the 200 images, in turns
EXTRACT_PROFILE_SLICE = (0, 12)  # every 12th frame (17 of 200) under torch.profiler
# one batch at the reference capacity (CAPACITY_r05's 2048 px and 8192
# features): canvas side, features, images
CAPACITY_SIFT = (2048, 8192, 4)


def extraction_table(store, table):
    t = store.read_table(table)
    return (np.asarray(t["image_id"]), t["keypoints"], t["descriptors"],
            np.asarray(t["camera"]))


def same_extraction(a, b):
    """Two extraction tables row for row, bitwise."""
    return (np.array_equal(a[0], b[0]) and np.array_equal(a[3], b[3])
            and all(len(x) == len(y) and all(np.array_equal(u, v) for u, v in zip(x, y))
                    for x, y in ((a[1], b[1]), (a[2], b[2]))))


def top_device_kernels(prof, n, k=6):
    """The k device kernels with the most device time in a profiled run:
    {name (cut to 90 characters): [ms per image, launches per image]}."""
    rows = []
    for e in prof.key_averages():
        if "CUDA" in str(getattr(e, "device_type", "")):
            us = float(getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0)))
            rows.append((us, e.key[:90], e.count))
    return {name: [us / 1e3 / n, count / n] for us, name, count in sorted(rows, reverse=True)[:k]}


def capacity_extraction(dev):
    """One batch of CAPACITY_SIFT's images through ``extract_batch``: its
    peak allocated memory above what was allocated before, the warm
    seconds, and whether each image's features equal ``extract``'s on it
    alone."""
    from scanner_colmap_tpu_torch.ops import sift
    from scanner_colmap_tpu_torch.pipeline import synth

    side, feats, n = CAPACITY_SIFT
    frames, _ = synth.render_dataset(num_images=n, width=side, height=side * 3 // 4,
                                     num_blobs=2000, seed=11)
    canvas = np.zeros((n, side, side), np.float32)
    for k, f in enumerate(frames):
        canvas[k, :f.shape[0], :f.shape[1]] = f / 255.0
    imgs = torch.from_numpy(canvas).to(dev)
    hw = torch.tensor([f.shape for f in frames], device=dev)
    kw = dict(max_features=feats, num_octaves=4)
    sift.extract_batch(imgs, hw, **kw)                   # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    batch = sift.extract_batch(imgs, hw, **kw)
    torch.cuda.synchronize()
    secs = time.time() - t
    peak = torch.cuda.max_memory_allocated()
    alone = [sift.extract(imgs[k], hw[k], **kw) for k in range(n)]
    same = all(torch.equal(getattr(batch, f)[k], getattr(a, f))
               for k, a in enumerate(alone) for f in ("xy", "scale", "ori", "response",
                                                        "desc", "valid"))
    return {"canvas": side, "max_features": feats, "images": n,
            "valid_features": batch.valid.sum(1).tolist(), "warm_s": secs,
            "peak_allocated_mib": peak / 2**20, "peak_above_inputs_mib": (peak - base) / 2**20,
            "bitwise_alone": same}


def extraction_phase(dev, scale_info):
    """Phase 15 on phase 10's 200-image store: run_extraction at batch_size
    1, 4 and 8. One profiled pass of each over EXTRACT_PROFILE_SLICE's
    frames (device kernels and device ms per image), then
    EXTRACT_TIMED_RUNS warm passes of each in turns (1, 4, 8, 8, 4, 1, ...),
    every table bitwise the first batch-1 pass's, as is the table of
    phase 10's command line (batches of 4, in another process); and one
    batch at the reference capacity (``capacity_extraction``). Returns the
    summary."""
    import copy

    from scanner_colmap_tpu_torch.pipeline import stages
    from scanner_colmap_tpu_torch.utils.metrics import device_work

    t0 = time.time()
    cfg, store = copy.deepcopy(scale_info["cfg"]), scale_info["store"]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    profiled = {}
    for b in EXTRACT_BATCHES:
        with torch.profiler.profile(activities=acts) as prof:
            n = len(stages.run_extraction(cfg, store, batch_size=b,
                                          frame_slice=EXTRACT_PROFILE_SLICE,
                                          out_table=f"extraction_profiled_b{b}", device=dev))
            torch.cuda.synchronize()
        work = device_work(prof)
        if not work["device_kernels"] > 0:
            raise AssertionError("extraction: the profiler saw no device kernels")
        profiled[b] = {"images": n, "device_kernels_per_image": work["device_kernels"] / n,
                       "device_ms_per_image": work["device_busy_ms"] / n,
                       "top_kernels_ms_per_image": top_device_kernels(prof, n)}
    order = [b for r in range(EXTRACT_TIMED_RUNS)
             for b in (EXTRACT_BATCHES if r % 2 == 0 else EXTRACT_BATCHES[::-1])]
    secs = {b: [] for b in EXTRACT_BATCHES}
    bitwise = {b: True for b in EXTRACT_BATCHES}
    ref = None
    for b in order:
        t = time.time()
        stages.run_extraction(cfg, store, batch_size=b, out_table=f"extraction_b{b}",
                              device=dev)
        torch.cuda.synchronize()
        secs[b].append(time.time() - t)
        rows = extraction_table(store, f"extraction_b{b}")
        if ref is None:
            ref = rows
        else:
            bitwise[b] &= same_extraction(rows, ref)
    n_img = len(ref[0])
    out = {"images": n_img, "config": {"max_image_size": cfg.sift.max_image_size,
                                       "max_num_features": cfg.sift.max_num_features,
                                       "num_octaves": cfg.sift.num_octaves,
                                       "inflight_batches": cfg.parallel.inflight_batches},
           "profiled": profiled, "warm_extraction_s": secs,
           "ms_per_image_median": {b: statistics.median(v) / n_img * 1e3
                                   for b, v in secs.items()},
           "bitwise_batch_1": bitwise,
           "cli_table_bitwise": same_extraction(extraction_table(store, "extraction"), ref),
           "features_mean": float(np.mean([len(k) for k in ref[1]])),
           "capacity_batch": capacity_extraction(dev)}
    out["phase_s"] = time.time() - t0
    log("extraction batches: " + json.dumps(out))
    if (not all(bitwise.values()) or not out["cli_table_bitwise"]
            or not out["capacity_batch"]["bitwise_alone"]):
        raise AssertionError(f"extraction: a batch changed an image's row: {out}")
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke run needs a card")
    from scanner_colmap_tpu_torch import device as devlib
    from scanner_colmap_tpu_torch import kernels
    from scanner_colmap_tpu_torch.kernels import _build
    from scanner_colmap_tpu_torch.pipeline import synth

    dev = torch.device("cuda:0")
    devlib.setup_numerics()
    card = gpu_line()
    log(f"phase 0: {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    phase_s = {}
    t = time.time()
    with ThreadPoolExecutor(len(kernels.KERNELS)) as pool:   # one nvcc per source
        list(pool.map(_build.load_library, kernels.KERNELS))
    log(f"phase 1: built {list(kernels.KERNELS)} in {time.time() - t:.2f} s")
    for name, info in _build.BUILD_INFO.items():
        log(f"  {name}: {info['seconds']:.2f} s\n    "
            + info["ptxas"].replace("\n", "\n    "))
    phase_s["1_build"] = time.time() - t

    t = time.time()
    window = [(a, a + o) for o in range(1, 7) for a in range(16) if a + o < 16]
    chain = [(a, a + 1) for a in range(32)]
    res = {"pair_match": check_kernel1(dev, 16, 640, window, seed=0)}
    res["pair_match"]["K8192"] = check_kernel1(dev, 33, 8192, chain, seed=1)
    res["schur"] = check_kernel2_synthetic(dev, 16, 2048, 16, seed=0)
    res["schur"]["M256"] = check_kernel2_synthetic(dev, 256, 8192, 16, seed=1)
    res["top2"] = check_kernel3(dev, 16, 640, window, seed=0)
    res["top2"]["K8192"] = check_kernel3(dev, 33, 8192, chain, seed=1)
    phase_s["2_4_kernels"] = time.time() - t

    t = time.time()
    frames, gt = synth.render_dataset(num_images=16, width=480, height=360,
                                      num_blobs=500, seed=3)
    log(f"slice: rendered 16 frames in {time.time() - t:.1f} s")
    with tempfile.TemporaryDirectory(prefix="smoke_store_") as root:
        recorded = []
        bf16_run = run_slice(dev, frames, gt, os.path.join(root, "bf16"), "bf16",
                             record=recorded)
        f32_run = run_slice(dev, frames, gt, os.path.join(root, "f32"), "f32")
        res["verification"] = {p: check_verification(dev, p, *run[:2], run[4])
                               for p, run in (("bf16", bf16_run), ("f32", f32_run))}
        res["verification"]["capacity"] = verify_capacity(dev)
        phase_s["5_slice"] = time.time() - t
        t = time.time()
        extra_matching(dev, gt, bf16_run, f32_run)
        phase_s["6_extra"] = time.time() - t
        t = time.time()
        paths = {"slice_bf16": bf16_run[2], "slice_f32": f32_run[2]}
        loop_paths, loop_info = loop_phase(dev, root)
        paths.update(loop_paths)
        phase_s["7_loop"] = time.time() - t
        t = time.time()
        paths.update(host_phase(dev, gt, bf16_run))
        phase_s["8_host"] = time.time() - t
        t = time.time()
        pil = have_pil()
        scale_paths_cli, scale_info = cli_scale_phase(dev, root, pil)
        paths.update(scale_paths_cli)
        phase_s["10_cli_scale"] = time.time() - t
        t = time.time()
        if not pil:
            raise AssertionError("phases 11 and 12 need Pillow on the card")
        real_paths, real_gt = cli_real_phase(dev, root)
        paths.update(real_paths)
        phase_s["11_cli_real"] = time.time() - t
        t = time.time()
        res["plane_cost"] = check_kernel4(dev, "480px_8src", 384, 480, 8)
        res["plane_cost"]["coarse_192"] = check_kernel4(dev, "coarse_192", 96, 96, 4, seed=1)
        res["plane_cost"]["fine_192"] = check_kernel4(dev, "fine_192", 160, 192, 4, seed=2)
        dense_paths, res["dense"] = dense_phase(dev, bf16_run, gt)
        paths.update(dense_paths)
        cli_paths, res["dense"]["cli_real"] = cli_dense_phase(root, real_gt)
        paths.update(cli_paths)
        band_paths, res["dense"]["band_jpeg"] = dense_band_phase(dev, root)
        paths.update(band_paths)
        phase_s["12_dense"] = time.time() - t
        t = time.time()
        scale_out_paths, res["scale_out"] = scaleout_phase(dev, bf16_run, frames, gt, root)
        paths.update(scale_out_paths)
        phase_s["13_scaleout"] = time.time() - t
        t = time.time()
        options_paths, res["options"] = options_phase(dev, root, bf16_run, frames, gt,
                                                      loop_info, scale_info)
        paths.update(options_paths)
        phase_s["14_options"] = time.time() - t
        t = time.time()
        res["extraction"] = extraction_phase(dev, scale_info)
        phase_s["15_extraction"] = time.time() - t
    t = time.time()
    scale_paths, res["cg_scale"] = cg_scale_phase(dev)
    paths.update(scale_paths)
    phase_s["9_cg_scale"] = time.time() - t
    t = time.time()
    res["schur"]["merge"] = check_kernel2_merge(dev, bf16_run[3])
    for stage in ("mapping", "merge"):
        res["schur"][f"{stage}_calls"] = check_kernel2_calls(
            stage, [c for s, c in recorded if s == stage])
    phase_s["3_recorded_calls"] = time.time() - t
    log("phase seconds: " + json.dumps({k: round(v, 2) for k, v in phase_s.items()}))
    log("cg scale: " + json.dumps(res.pop("cg_scale")))
    log("verification: " + json.dumps(res.pop("verification")))
    log("dense summary: " + json.dumps(res.pop("dense")))
    replays = res["scale_out"].pop("replays")
    log("scale-out summary: " + json.dumps(res.pop("scale_out")))
    batched_replays = res["options"].pop("replays")
    res["schur"]["lanes_C8"] = res["options"].pop("kernel2_lanes")
    log("options summary: " + json.dumps(res.pop("options")))
    log("extraction summary: " + json.dumps(res.pop("extraction")))
    # each kernel's main-path count comes from the run whose path carries it
    launches = {"pair_match": bf16_run[2]["pair_match"], "schur": f32_run[2]["schur"],
                "top2": f32_run[2]["top2"], "plane_cost": paths["dense_192"]["plane_cost"]}
    rows = []
    for name, (_, source, replaces) in kernels.KERNELS.items():
        by_path = {p: c[name] for p, c in paths.items() if c[name]}
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "launches_by_path": by_path, **res[name],
                     "replayed_on_scale_out_paths": {p: r[name] for p, r in replays.items()
                                                     if name in r},
                     "replayed_on_option_paths": {p: r[name] for p, r in batched_replays.items()
                                                  if name in r}})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--scaleout-rank"]:
        scaleout_rank(int(sys.argv[2]), sys.argv[3])
    else:
        main()
