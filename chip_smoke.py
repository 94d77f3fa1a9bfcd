"""Smoke run of the torch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; there is no CPU path):
  0 device: require CUDA, print the card's name and power limit
  1 build: compile the three hand-written kernels from csrc/ with nvcc, one
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
    images, cluster_size 12, so two clusters) through prepare_images ->
    run_extraction -> run_matching -> run_mapping -> run_merge, once at bf16
    (resident plan, kernel 1) and once at f32 (banked plan, kernel 3 once
    per bank), each with one cold and one warm (timed) pass; the warm pass
    is the main path and carries the launch counts, printed per stage with
    the correspondence graph the mapper took
  6 extra matching passes: bf16 banked == resident on the card, and
    guided matching + multiple models (f32) through mapping and merge
The second-to-last line is the card's name and power limit, the line
before it a JSON summary of the kernels, the last line the result.
Bounds: the larger of the bytes each input read once and each output
written once over 3.35 TB/s, and the operations over the H100 SXM peak for
their type (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s f32 without).
"""

import json
import os
import statistics
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

K1_AGREE = 0.999      # share of rows with identical decisions
K1_NEAR_TIE = 1e-5    # every disagreement must be a near-tie this close
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
    1024 features, overlap 6, cluster_size 12 (two clusters), with loop
    closure off (its probe is not ported)."""
    from scanner_colmap_tpu_torch.pipeline import PipelineConfig

    cfg = PipelineConfig()
    cfg.store_path = root
    cfg.sift.max_image_size = 480
    cfg.sift.max_num_features = 1024
    cfg.sift.num_octaves = 3
    cfg.matching.overlap = 6
    cfg.matching.min_num_inliers = 12
    cfg.matching.loop_closure = False
    cfg.matching.precision = precision
    cfg.mapper.cluster_size = 12
    cfg.mapper.cluster_overlap = 4
    cfg.mapper.init_min_num_inliers = 20
    cfg.mapper.abs_pose_min_num_inliers = 12
    cfg.mapper.single_camera = True
    return cfg


def check_model(name, model, gt, n_submodels):
    """Registered count, submodels, ATE and finite points of a slice run."""
    from scanner_colmap_tpu_torch.pipeline import synth

    xyz = np.array([p.xyz for p in model.points3D.values()])
    ate = synth.evaluate_ate(model, gt)
    if not np.isfinite(xyz).all() or xyz.shape != (len(model.points3D), 3):
        raise AssertionError(f"{name}: non-finite or malformed points")
    if model.num_registered < SLICE_MIN_REGISTERED:
        raise AssertionError(f"{name}: registered {model.num_registered}/16")
    if n_submodels != SLICE_SUBMODELS:
        raise AssertionError(f"{name}: {n_submodels} submodels, expected {SLICE_SUBMODELS}")
    if not ate <= SLICE_MAX_ATE:
        raise AssertionError(f"{name}: ATE {ate} > {SLICE_MAX_ATE}")
    return ate


def run_slice(dev, frames, gt, root, precision, record=None):
    """One cold and one warm pass of the five stages. The warm pass is the
    main path: every launch count is set to 0 just before it and read just
    after, with the per-stage launches recorded on the way. With a list
    ``record``, the cold pass appends to it (stage, (cam_idx, Wc, Vinv, M))
    of every kernel 2 call, copied as the BA passed them."""
    from scanner_colmap_tpu_torch import kernels
    from scanner_colmap_tpu_torch.ops import ba
    from scanner_colmap_tpu_torch.pipeline import ArtifactStore, stages

    cfg = slice_config(root, precision)
    store = ArtifactStore(root)
    stages.prepare_images(cfg, store, frames=[(f, gt["focal"]) for f in frames])
    steps = [("extraction", stages.run_extraction), ("matching", stages.run_matching),
             ("mapping", stages.run_mapping), ("merge", stages.run_merge)]
    times, cold = {}, {}
    schur = ba.schur_accumulate
    for name, fn in steps:                       # cold pass
        if record is not None:
            def recorder(cam_idx, Wc, Vinv, M, stage=name):
                record.append((stage, (cam_idx.clone(), Wc.clone(), Vinv.clone(), M)))
                return schur(cam_idx, Wc, Vinv, M)
            ba.schur_accumulate = recorder
        try:
            t = time.time()
            cold[name] = fn(cfg, store, device=dev)
            torch.cuda.synchronize()
            times[f"{name}_cold_s"] = time.time() - t
        finally:
            ba.schur_accumulate = schur
    outs, per_stage = {}, {}
    kernels.reset_launch_counts()
    for name, fn in steps:                       # warm pass: the main path
        before = kernels.launch_counts()
        t = time.time()
        outs[name] = fn(cfg, store, device=dev)
        torch.cuda.synchronize()
        times[f"{name}_s"] = time.time() - t
        per_stage[name] = {k: v - before[k] for k, v in kernels.launch_counts().items()}
    launches = kernels.launch_counts()
    model = outs["merge"]
    m_meta = store.read_manifest("matching")["meta"]
    ate = check_model(f"slice {precision}", model, gt, outs["mapping"])
    summary = {"precision": precision, "execution": m_meta["execution"],
               "registered": model.num_registered, "images": 16,
               "submodels": outs["mapping"], "verified_pairs": outs["matching"],
               "points": len(model.points3D),
               "mean_reproj_px": model.mean_reprojection_error(), "ate": ate,
               "launches": launches, "launches_per_stage": per_stage,
               "host_retry_needed":
                   store.read_manifest("mapping")["meta"]["device_stats"]["host_retry_needed"],
               "merge_time_split_s": store.read_manifest("models")["meta"]["time_split_s"],
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
    return cfg, store, launches, model


def same_model(a, b):
    """Whether two passes gave bitwise the same model: registered images,
    poses and points (kernel 2 is deterministic; the BA's other camera sums
    use index_add_, which adds with atomics on the card)."""
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

    t = time.time()
    with ThreadPoolExecutor(len(kernels.KERNELS)) as pool:   # one nvcc per source
        list(pool.map(_build.load_library, kernels.KERNELS))
    log(f"phase 1: built {list(kernels.KERNELS)} in {time.time() - t:.2f} s")
    for name, info in _build.BUILD_INFO.items():
        log(f"  {name}: {info['seconds']:.2f} s\n    "
            + info["ptxas"].replace("\n", "\n    "))

    window = [(a, a + o) for o in range(1, 7) for a in range(16) if a + o < 16]
    chain = [(a, a + 1) for a in range(32)]
    res = {"pair_match": check_kernel1(dev, 16, 640, window, seed=0)}
    res["pair_match"]["K8192"] = check_kernel1(dev, 33, 8192, chain, seed=1)
    res["schur"] = check_kernel2_synthetic(dev, 16, 2048, 16, seed=0)
    res["schur"]["M256"] = check_kernel2_synthetic(dev, 256, 8192, 16, seed=1)
    res["top2"] = check_kernel3(dev, 16, 640, window, seed=0)
    res["top2"]["K8192"] = check_kernel3(dev, 33, 8192, chain, seed=1)

    t0 = time.time()
    frames, gt = synth.render_dataset(num_images=16, width=480, height=360,
                                      num_blobs=500, seed=3)
    log(f"slice: rendered 16 frames in {time.time() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="smoke_store_") as root:
        recorded = []
        bf16_run = run_slice(dev, frames, gt, os.path.join(root, "bf16"), "bf16",
                             record=recorded)
        f32_run = run_slice(dev, frames, gt, os.path.join(root, "f32"), "f32")
        extra_matching(dev, gt, bf16_run, f32_run)
    res["schur"]["merge"] = check_kernel2_merge(dev, bf16_run[3])
    for stage in ("mapping", "merge"):
        res["schur"][f"{stage}_calls"] = check_kernel2_calls(
            stage, [c for s, c in recorded if s == stage])
    # each kernel's main-path count comes from the run whose path carries it
    launches = {"pair_match": bf16_run[2]["pair_match"], "schur": f32_run[2]["schur"],
                "top2": f32_run[2]["top2"]}
    rows = []
    for name, (_, source, replaces) in kernels.KERNELS.items():
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name], **res[name]})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
