"""SIFT descriptor matching (port of ``ops/matching.py``).

Descriptors are L2-normalized rows; similarity is their dot product,
distance = arccos(similarity); ``max_distance`` and the Lowe ratio test
apply in that angular space, and the cross check keeps mutual-best pairs
(COLMAP FindBestMatches semantics).

Two kernels carry the matcher, by precision:
- ``"bf16"``: kernel 1 (``kernels/pair_match``), bf16 operands with f32
  accumulation, the decisions of the JAX package's Pallas pair kernel. The
  JAX default path rounds the similarity to bf16 before its packed
  single-pass reductions (a TPU trick that is not ported), so against that
  path decisions may flip on near-ties.
- ``"f32"``: kernel 3 (``kernels/top2``), the exact f32 similarity of the
  JAX ``precision="f32"`` path, forward and reverse for the cross check
  from one launch.

The resident pool (``match_pairs_pool``) and the banks of the banked plan
(``match_bank``) run the same kernels on the same normalized rows, so the
two plans give the same table. ``window_bank`` makes a bank of raw
descriptors, as the sharded step and ``match_window`` match them. Guided
matching is plain torch.
"""

from __future__ import annotations

import torch

from scanner_colmap_tpu_torch.kernels.pair_match import pair_match
from scanner_colmap_tpu_torch.kernels.top2 import top2_bank, top2_cross

NEG = -1e9


def normalize_descriptors(desc: torch.Tensor) -> torch.Tensor:
    """L2-normalize descriptor rows (uint8 512-scaled or float) to f32."""
    d = desc.to(torch.float32)
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-8)


def normalize_pool(desc_pool: torch.Tensor) -> torch.Tensor:
    """(N_img, K, 128) raw descriptor pool -> L2-normalized bf16; padded
    (zero) rows stay zero."""
    return normalize_descriptors(desc_pool).to(torch.bfloat16)


def normalize_bank(desc_bank: torch.Tensor, precision: str) -> torch.Tensor:
    """A raw descriptor bank normalized for ``precision``'s kernel: bf16
    for kernel 1, f32 for kernel 3."""
    _check_precision(precision)
    return normalize_pool(desc_bank) if precision == "bf16" \
        else normalize_descriptors(desc_bank)


def _check_precision(precision: str):
    if precision not in ("bf16", "f32"):
        raise ValueError(f"precision must be 'bf16' or 'f32', got {precision!r}")


def match_pairs_pool(pool: torch.Tensor, valid: torch.Tensor,
                     ai: torch.Tensor, bi: torch.Tensor,
                     max_ratio: float = 0.8, max_distance: float = 0.7,
                     cross_check: bool = True,
                     precision: str = "bf16") -> torch.Tensor:
    """Match scheduled pairs (ai[i], bi[i]) of a resident pool.

    pool (N_img, K, 128) bf16 normalized; valid (N_img, K) bool; ai, bi
    (NP,) int32. Returns (NP, K) int64 match indices into image bi (-1 =
    no match). The resident pool is bf16 by construction; f32 matching
    takes the banked plan (``match_bank``), as in the JAX stage."""
    if precision != "bf16":
        raise NotImplementedError(
            f"matching.precision={precision!r}: the resident pool is bf16; "
            "f32 matching runs on banks (match_bank)")
    best, second, bidx, rev = pair_match(pool, valid.to(torch.float32), ai, bi)
    return decide(best, second, bidx, rev, max_ratio, max_distance, cross_check)


def match_bank(bank: torch.Tensor, valid: torch.Tensor, ai: torch.Tensor,
               bi: torch.Tensor, max_ratio: float = 0.8,
               max_distance: float = 0.7, cross_check: bool = True,
               precision: str = "bf16") -> torch.Tensor:
    """Match pairs (ai[i], bi[i]) of one bank (bank-relative rows).

    bank (n_bank, K, 128) from ``normalize_bank(raw, precision)``; valid
    (n_bank, K) bool. Returns (NP, K) int64 indices into image bi (-1 = no
    match). bf16 runs kernel 1 (the resident pool's matcher); f32 runs
    kernel 3, whose one launch also gives the cross check's reverse argbest
    of every column, over the valid rows of ai."""
    _check_precision(precision)
    vb = valid.to(torch.float32)
    matcher = pair_match if precision == "bf16" else top2_bank
    best, second, bidx, rev = matcher(bank, vb, ai, bi)
    idx = decide(best, second, bidx, rev, max_ratio, max_distance, cross_check)
    return torch.where(valid[ai.long()], idx, torch.full_like(idx, -1))


def decide(best, second, bidx, rev, max_ratio: float = 0.8,
           max_distance: float = 0.7, cross_check: bool = True) -> torch.Tensor:
    """Match decisions from the pair matcher's reductions: angular distance
    and ratio tests, then the mutual-best check (rev[argbest] == row)."""
    dist = torch.arccos(torch.clamp(best, -1.0, 1.0))
    dist2 = torch.arccos(torch.clamp(second, -1.0, 1.0))
    ok = (best > -1.0) & (dist < max_distance) & (dist < max_ratio * dist2)
    if cross_check:
        rows = torch.arange(best.shape[1], device=best.device)
        ok &= torch.gather(rev, 1, bidx) == rows
    return torch.where(ok, bidx, torch.full_like(bidx, -1))


def window_bank(desc: torch.Tensor, valid: torch.Tensor, precision: str = "bf16"):
    """Raw descriptors (N, K, 128) with validity (N, K) as a bank for
    ``match_bank``: invalid rows zeroed (the stage's pool holds them so; a
    row left in would take part in the cross check's reverse argbest),
    normalized for ``precision``'s kernel, K padded to kernel 1's row tile
    with invalid slots. Returns (bank (N, Kp, 128), valid (N, Kp) bool)."""
    N, K = valid.shape
    Kp = -(-max(K, 1) // 64) * 64
    valid = valid.to(torch.bool)
    raw = torch.zeros((N, Kp, 128), dtype=torch.float32, device=desc.device)
    raw[:, :K] = torch.where(valid[..., None], desc.to(torch.float32), 0.0)
    vpad = torch.zeros((N, Kp), dtype=torch.bool, device=desc.device)
    vpad[:, :K] = valid
    return normalize_bank(raw, precision), vpad


def match_window(desc: torch.Tensor, valid: torch.Tensor, max_ratio: float = 0.8,
                 max_distance: float = 0.7, cross_check: bool = True,
                 precision: str = "bf16"):
    """Sequential-overlap matching of one window (JAX ``match_window``):
    desc (W, K, 128), valid (W, K); image 0 is the pivot, images 1..W-1
    its window. Returns (match_idx (W-1, K) int32 into each window image or
    -1, ok (W-1, K) bool).

    The window is one bank (``window_bank``) and its W-1 pairs (0, j) one
    ``match_bank`` launch: kernel 1 at bf16 (bf16 operands, f32 sums: the
    JAX einsum's numerics), kernel 3 at f32."""
    W, K = valid.shape
    bank, vb = window_bank(desc, valid, precision)
    ai = torch.zeros(W - 1, dtype=torch.int32, device=bank.device)
    bi = torch.arange(1, W, dtype=torch.int32, device=bank.device)
    idx = match_bank(bank, vb, ai, bi, max_ratio, max_distance, cross_check,
                     precision)[:, :K]
    return idx.to(torch.int32), idx >= 0


def match_descriptors(desc1: torch.Tensor, desc2: torch.Tensor,
                      valid1: torch.Tensor, valid2: torch.Tensor,
                      max_ratio: float = 0.8, max_distance: float = 0.7,
                      cross_check: bool = True, precision: str = "bf16"):
    """Match desc1 (N, 128) against desc2 (M, 128) with masks (JAX
    ``match_descriptors``). Returns (match_idx (N,) int32 into desc2 or -1,
    ok (N,) bool).

    "f32" runs kernel 3 (both directions, one launch) on the f32-normalized
    rows.
    "bf16" runs kernel 1 on a two-image bf16 pool whose invalid rows are
    zero, as in the stage's pool, so it decides as the resident and banked
    plans do."""
    _check_precision(precision)
    N = desc1.shape[0]
    valid1 = valid1.to(torch.bool)
    valid2 = valid2.to(torch.bool)
    d1 = normalize_descriptors(desc1)
    d2 = normalize_descriptors(desc2)
    if precision == "f32":
        best, second, idx, rev = top2_cross(d1, d2, valid1, valid2)
        idx = decide(best[None], second[None], idx[None], rev[None], max_ratio,
                     max_distance, cross_check)[0]
    else:
        M = desc2.shape[0]
        K = -(-max(N, M, 1) // 64) * 64   # kernel 1 takes K % 64 == 0
        pool = torch.zeros((2, K, 128), dtype=torch.bfloat16, device=d1.device)
        pool[0, :N] = (d1 * valid1[:, None]).to(torch.bfloat16)
        pool[1, :M] = (d2 * valid2[:, None]).to(torch.bfloat16)
        vb = torch.zeros((2, K), dtype=torch.float32, device=d1.device)
        vb[1, :M] = valid2.to(torch.float32)
        ab = torch.tensor([0, 1], dtype=torch.int32, device=d1.device)
        best, second, bidx, rev = pair_match(pool, vb, ab[:1], ab[1:])
        idx = decide(best, second, bidx, rev, max_ratio, max_distance,
                     cross_check)[0, :N]
    ok = valid1 & (idx >= 0)
    return torch.where(ok, idx, torch.full_like(idx, -1)).to(torch.int32), ok


def match_descriptors_guided(desc1, desc2, valid1, valid2, uv1, uv2, F,
                             max_epipolar_error: float = 4.0,
                             max_ratio: float = 0.9, max_distance: float = 0.7,
                             cross_check: bool = True, precision: str = "bf16"):
    """Guided matching (JAX ``match_descriptors_guided``): candidates are
    restricted to epipolar-consistent pairs (Sampson distance of uv1 (N, 2)
    and uv2 (M, 2) under F below ``max_epipolar_error`` px) before the
    nearest-neighbour search. The similarity takes bf16-rounded or f32
    operands with f32 sums; the gate is computed in the dtype of uv1.
    Batched over leading dimensions, which broadcast: G pairs give desc
    (G, N, 128), valid (G, N), uv (G, N, 2), F (G, 3, 3), and one call.
    Plain torch: a kernel for it waits for a measurement on the card.
    Returns (match_idx (..., N) int32 or -1, ok (..., N) bool)."""
    _check_precision(precision)
    valid1 = valid1.to(torch.bool)
    valid2 = valid2.to(torch.bool)
    d1 = normalize_descriptors(desc1)
    d2 = normalize_descriptors(desc2)
    if precision == "bf16":
        d1 = d1.to(torch.bfloat16).to(torch.float32)
        d2 = d2.to(torch.bfloat16).to(torch.float32)
    sim = d1 @ d2.mT
    F = F.to(uv1.dtype)
    p1 = torch.cat([uv1, torch.ones_like(uv1[..., :1])], dim=-1)
    p2 = torch.cat([uv2, torch.ones_like(uv2[..., :1])], dim=-1)
    Fx1 = p1 @ F.mT                      # (..., N, 3) lines in image 2
    Ftx2 = p2 @ F                        # (..., M, 3) lines in image 1
    x2Fx1 = Fx1 @ p2.mT
    denom = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2)[..., :, None] + \
        (Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2)[..., None, :]
    epi_ok = x2Fx1 ** 2 / torch.clamp(denom, min=1e-12) < max_epipolar_error ** 2
    sim = torch.where(valid2[..., None, :] & epi_ok, sim, torch.full_like(sim, NEG))
    N, M = sim.shape[-2:]
    col = torch.arange(M, device=sim.device)
    best = sim.amax(dim=-1)
    idx = torch.where(sim >= best[..., None], col, M).amin(dim=-1)
    second = torch.where(col == idx[..., None], torch.full_like(sim, NEG),
                         sim).amax(dim=-1)
    dist = torch.arccos(torch.clamp(best, -1.0, 1.0))
    dist2 = torch.arccos(torch.clamp(second, -1.0, 1.0))
    ok = valid1 & (best > -1.0) & (dist < max_distance) & (dist < max_ratio * dist2)
    if cross_check:
        sim_r = torch.where(valid1[..., :, None], sim, torch.full_like(sim, NEG))
        row = torch.arange(N, device=sim.device)
        rev = torch.where(sim_r >= sim_r.amax(dim=-2, keepdim=True), row[:, None],
                          N).amin(dim=-2)
        ok &= torch.gather(rev, -1, idx) == row
    return torch.where(ok, idx, torch.full_like(idx, -1)).to(torch.int32), ok


def matches_to_pairs(match_idx: torch.Tensor, match_valid: torch.Tensor,
                     max_num_matches: int):
    """Compact (K,) match indices into fixed-capacity (max_num_matches, 2)
    index pairs + mask, valid first in index order (stable)."""
    order = torch.argsort((~match_valid).to(torch.int8), stable=True)
    idx1 = order[:max_num_matches]
    idx2 = match_idx[idx1]
    m = match_valid[idx1]
    m &= torch.arange(max_num_matches, device=m.device) < match_valid.sum()
    pairs = torch.stack([idx1.to(torch.int32), idx2.to(torch.int32)], dim=-1)
    return torch.where(m[:, None], pairs, torch.full_like(pairs, -1)), m
