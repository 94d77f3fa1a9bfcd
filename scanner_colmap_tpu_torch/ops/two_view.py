"""Two-view geometry (port of ``ops/two_view.py``: ``estimate_two_view_geometry``,
calibrated and uncalibrated, and its multiple-model form).

Every estimator runs on a batch of pairs with a leading pair dimension,
as the JAX stage maps it over a chunk; one pair is the batch of one.
Minimal solvers run on a static batch of samples per chunk (8-point F/E and
4-point H with the solve-free ``_null_vec_fast`` null vector), every
hypothesis is MSAC-scored against the correspondences, chunks repeat until
COLMAP's confidence bound is met (``ransac_adaptive``), and the winner is
refit once on its inliers. Then the COLMAP configuration decision, pose
from E (or from the H decomposition for planar pairs) and watermark
detection, as in the reference.

Random draws come from one explicit ``torch.Generator`` per pair, and only
while the pair is still active, so a pair's result is the same alone and in
any batch. Every RANSAC entry point also takes injected sample indices
(``draws``) so tests can hand it exactly the reference's ``jax.random``
draws.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from scanner_colmap_tpu_torch.models import geometry as geom
from scanner_colmap_tpu_torch.ops.linalg3 import inv33

# COLMAP TwoViewGeometry configuration enum (interchange-compatible)
UNDEFINED = 0
DEGENERATE = 1
CALIBRATED = 2
UNCALIBRATED = 3
PLANAR = 4
PANORAMIC = 5
PLANAR_OR_PANORAMIC = 6
WATERMARK = 7
MULTIPLE = 8

SUB = 192   # preemptive-scoring subset size
TOP = 32    # trials rescored on all correspondences per chunk
# The most matrices one torch.linalg.eigh call is given. On an H100 with
# torch 2.11 (CUDA 12.8), cuSOLVER's batched eigensolver refuses a larger
# batch in its buffer query (cusolverDnXsyevBatched_bufferSize:
# CUSOLVER_STATUS_INVALID_VALUE) whatever the values: it ran 31291 4x4,
# 29586 9x9 and 28631 12x12 matrices, f64 or f32, and raised at one more
# (tools/exp_eigh_batch.py). The smallest of the three.
EIGH_MAX_BATCH = 28631


@dataclasses.dataclass
class TwoViewGeometry:
    config: torch.Tensor       # () int
    E: torch.Tensor            # (3, 3)
    F: torch.Tensor
    H: torch.Tensor
    qvec: torch.Tensor         # (4,) relative pose cam1 -> cam2
    tvec: torch.Tensor         # (3,)
    tri_angle: torch.Tensor    # () median triangulation angle (rad)
    inlier_mask: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # () int


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Normalization + DLT solvers (batch-friendly; shapes (..., K, 2))
# ---------------------------------------------------------------------------

def _normalize_points(pts: torch.Tensor, mask: torch.Tensor):
    """Hartley normalization (masked): centroid 0, mean distance sqrt(2)."""
    w = mask.to(pts.dtype)
    n = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    mean = torch.sum(pts * w[..., None], dim=-2, keepdim=True) / n[..., None]
    d = torch.linalg.norm(pts - mean, dim=-1)
    mean_d = torch.sum(d * w, dim=-1, keepdim=True) / n
    scale = math.sqrt(2.0) / torch.clamp(mean_d, min=1e-12)
    normed = (pts - mean) * scale[..., None]
    s = scale[..., 0]
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    mx, my = mean[..., 0, 0], mean[..., 0, 1]
    T = torch.stack([s, z, -s * mx, z, s, -s * my, z, z, o],
                    dim=-1).reshape(scale.shape[:-1] + (3, 3))
    return normed, T


def eigh_calls(batch: int) -> int:
    """``torch.linalg.eigh`` calls ``_smallest_eigvec`` makes for ``batch``
    matrices."""
    return max(-(-batch // EIGH_MAX_BATCH), 1)


def _smallest_eigvec(A: torch.Tensor) -> torch.Tensor:
    """Right null vector of A: eigenvector of A^T A, smallest eigenvalue.
    A batch above ``EIGH_MAX_BATCH`` matrices is split into calls of at
    most that many, in order."""
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    n = AtA.shape[-1]
    flat = AtA.reshape(-1, n, n)
    if len(flat) <= EIGH_MAX_BATCH:
        _, V = torch.linalg.eigh(AtA)
        return V[..., :, 0]
    V = torch.cat([torch.linalg.eigh(part)[1] for part in torch.split(flat, EIGH_MAX_BATCH)])
    return V[..., :, 0].reshape(AtA.shape[:-1])


def _null_vec_fast(A: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """Approximate right null vector of A (..., m, n), m < n, without a
    factorization: modified Gram-Schmidt over the rows, then the largest
    column of the residual projector I - Q^T Q."""
    m, n = A.shape[-2], A.shape[-1]
    rows = []
    for i in range(m):
        r = A[..., i, :]
        for q in rows:
            r = r - torch.sum(r * q, -1, keepdim=True) * q
        r = r * torch.rsqrt(torch.clamp(torch.sum(r * r, -1, keepdim=True), min=1e-30))
        rows.append(r)
    Q = torch.stack(rows, -2)
    P = _eye(n, A) - torch.einsum("...ki,...kj->...ij", Q, Q)
    best = torch.argmax(torch.sum(P * P, dim=-2), dim=-1)
    v = torch.gather(P, -1, best[..., None, None].expand(P.shape[:-1] + (1,)))[..., 0]
    for _ in range(max(iters - 1, 0)):
        v = v - torch.einsum("...kj,...k->...j", Q,
                             torch.einsum("...ki,...i->...k", Q, v))
    v = v * torch.rsqrt(torch.clamp(torch.sum(v * v, -1, keepdim=True), min=1e-30))
    return torch.where(torch.isfinite(v), v, torch.full_like(v, 1.0 / n ** 0.5))


def enforce_rank2(Fm: torch.Tensor) -> torch.Tensor:
    U, S, Vh = torch.linalg.svd(Fm)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return U @ (S[..., None] * Vh)


def _rank2_project_fast(F: torch.Tensor) -> torch.Tensor:
    """Approximate rank-2 projection without SVD (two inverse iterations
    for the smallest singular pair)."""
    def smallest_vec(M):
        tr = torch.einsum("...ii->...", M)[..., None, None]
        Minv = inv33(M + (1e-6 * tr + 1e-25) * _eye(3, M))
        v = torch.sum(Minv, dim=-1)
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)
        v = torch.einsum("...ij,...j->...i", Minv, v)
        return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)

    v3 = smallest_vec(torch.einsum("...ki,...kj->...ij", F, F))
    u3 = smallest_vec(torch.einsum("...ik,...jk->...ij", F, F))
    s3 = torch.einsum("...i,...ij,...j->...", u3, F, v3)
    F2 = F - s3[..., None, None] * u3[..., :, None] * v3[..., None, :]
    return torch.where(torch.isfinite(F2), F2, torch.zeros_like(F2))


def fundamental_8pt(x1, x2, mask=None, exact: bool = True):
    """8-point F (rank 2, unit norm, de-normalized). x1, x2 (..., K, 2)."""
    if mask is None:
        mask = torch.ones(x1.shape[:-1], dtype=torch.bool, device=x1.device)
    x1n, T1 = _normalize_points(x1, mask)
    x2n, T2 = _normalize_points(x2, mask)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], dim=-1)
    A = A * mask[..., None].to(A.dtype)
    f = _smallest_eigvec(A) if exact else _null_vec_fast(A)
    Fm = f.reshape(f.shape[:-1] + (3, 3))
    Fm = enforce_rank2(Fm) if exact else _rank2_project_fast(Fm)
    Fm = T2.transpose(-1, -2) @ Fm @ T1
    norm = torch.linalg.norm(Fm, dim=(-2, -1), keepdim=True)
    return Fm / torch.clamp(norm, min=1e-12)


def essential_8pt(x1n, x2n, mask=None, exact: bool = True):
    """E from >= 8 normalized correspondences; (1, 1, 0) singular values
    enforced on the exact path."""
    E = fundamental_8pt(x1n, x2n, mask, exact=exact)
    if not exact:
        return E
    U, S, Vh = torch.linalg.svd(E)
    s = 0.5 * (S[..., 0] + S[..., 1])
    Snew = torch.stack([s, s, torch.zeros_like(s)], dim=-1)
    return U @ (Snew[..., None] * Vh)


def homography_dlt(x1, x2, mask=None, exact: bool = True):
    """DLT homography x2 ~ H x1 from >= 4 correspondences (..., K, 2)."""
    if mask is None:
        mask = torch.ones(x1.shape[:-1], dtype=torch.bool, device=x1.device)
    x1n, T1 = _normalize_points(x1, mask)
    x2n, T2 = _normalize_points(x2, mask)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    o = torch.ones_like(u1)
    z = torch.zeros_like(u1)
    r1 = torch.stack([-u1, -v1, -o, z, z, z, u2 * u1, u2 * v1, u2], dim=-1)
    r2 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=-1)
    m = mask[..., None].to(r1.dtype)
    A = torch.cat([r1 * m, r2 * m], dim=-2)
    h = _smallest_eigvec(A) if exact else _null_vec_fast(A)
    Hn = h.reshape(h.shape[:-1] + (3, 3))
    Hm = torch.linalg.solve_ex(T2, Hn @ T1)[0]     # no host sync
    h22 = Hm[..., 2:3, 2:3]
    return Hm / torch.clamp(torch.abs(h22), min=1e-12) * torch.sign(
        torch.where(h22 == 0, torch.ones_like(h22), h22))


# ---------------------------------------------------------------------------
# Residuals
# ---------------------------------------------------------------------------

def _homog(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def sampson_error(F, x1, x2):
    """Squared Sampson distance. F (..., 3, 3); x1, x2 (..., N, 2)."""
    p1, p2 = _homog(x1), _homog(x2)
    Fx1 = torch.einsum("...ij,...nj->...ni", F, p1)
    Ftx2 = torch.einsum("...ji,...nj->...ni", F, p2)
    x2Fx1 = torch.sum(p2 * Fx1, dim=-1)
    denom = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return x2Fx1 ** 2 / torch.clamp(denom, min=1e-12)


def homography_error(H, x1, x2):
    """Squared transfer error |x2 - H x1|^2."""
    Hx1 = torch.einsum("...ij,...nj->...ni", H, _homog(x1))
    w = Hx1[..., 2]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return torch.sum((x2 - Hx1[..., :2] / w[..., None]) ** 2, dim=-1)


# ---------------------------------------------------------------------------
# Confidence-adaptive RANSAC, batched over pairs
# ---------------------------------------------------------------------------

def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of x (C, n, d) at idx (C, ...) -> (C, ..., d)."""
    C, d = x.shape[0], x.shape[-1]
    flat = idx.reshape(C, -1, 1).expand(-1, -1, d)
    return torch.gather(x, 1, flat).reshape(idx.shape + (d,))


def _draw_indices(gens, valid: torch.Tensor, num: int, active, inject=None):
    """(C, num) indices drawn uniformly (with replacement) from each pair's
    valid entries, from the pair's own generator: one draw per active pair,
    then one batched search. Other pairs draw nothing and get index 0, as
    does a pair with no valid entry. ``inject`` ({pair: (num,) indices})
    replaces the generator's draw of those pairs."""
    C, n = valid.shape
    cs = torch.cumsum(valid.to(torch.int64), 1)
    nv = cs[:, -1:].clamp(min=1)
    u = torch.zeros((C, num), dtype=torch.float64, device=valid.device)
    inject = inject or {}
    for s in active:
        if s not in inject:
            u[s].uniform_(generator=gens[s])
    rank = torch.minimum((u * nv).long(), nv - 1) + 1
    idx = torch.searchsorted(cs, rank).clamp(max=n - 1)
    for s, val in inject.items():
        idx[s] = val.to(idx.device)
    return idx


def draw_samples(gen: torch.Generator, num_trials: int, sample_size: int,
                 valid: torch.Tensor) -> torch.Tensor:
    """(num_trials, sample_size) indices drawn uniformly (with replacement)
    from the valid entries of one pair; all-invalid input draws index 0."""
    idx = _draw_indices([gen], valid[None], num_trials * sample_size, [0])
    return idx[0].reshape(num_trials, sample_size)


def _topk_first(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the top-k along the last dim, descending, equal values
    ordered by lower index first (the order of ``lax.top_k``)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


RANSAC_TOP = 128   # trials rescored on all correspondences by ``ransac``


def ransac(gen, x1, x2, valid, solver, residual_fn, num_trials: int,
           sample_size: int, max_error: float, samples=None, sub_idx=None):
    """Static-shape RANSAC over one pair (the JAX ``ransac``): num_trials
    minimal hypotheses at once, preemptive MSAC scoring on a subset of SUB
    correspondences when there are more than RANSAC_TOP trials and SUB
    correspondences (the best RANSAC_TOP rescored on all), then one refit on
    the winner's inliers, kept if it scores better.

    x1, x2 (N, 2); valid (N,) bool; ``solver(x1, x2, mask, exact)`` and
    ``residual_fn(models, x1, x2)`` broadcast over leading axes, as
    ``_f_solver`` and ``sampson_error`` do. Draws come from ``gen`` unless
    given: ``samples`` (num_trials, sample_size) and ``sub_idx`` (SUB,)
    indices, for parity with the reference's draws. Returns (model (3, 3),
    inlier_mask (N,), num_inliers, best_score)."""
    n = x1.shape[0]
    thr = max_error * max_error
    if samples is None:
        samples = draw_samples(gen, num_trials, sample_size, valid)
    models = solver(x1[samples], x2[samples], None, False)          # (S, 3, 3)
    if num_trials > RANSAC_TOP and n > SUB:
        if sub_idx is None:
            sub_idx = draw_samples(gen, 1, SUB, valid)[0]
        e = residual_fn(models, x1[sub_idx][None], x2[sub_idx][None])
        e = torch.where(valid[sub_idx][None], e, thr)
        models = models[_topk_first(-torch.clamp(e, max=thr).sum(-1), RANSAC_TOP)]
    errs = torch.where(valid[None], residual_fn(models, x1[None], x2[None]), thr)
    score = torch.clamp(errs, max=thr).sum(-1)
    best = torch.argmin(score)
    inliers = (errs[best] < thr) & valid
    refit = solver(x1[None], x2[None], inliers[None])[0]
    errs2 = torch.where(valid, residual_fn(refit[None], x1[None], x2[None])[0], thr)
    score2 = torch.clamp(errs2, max=thr).sum()
    use2 = (score2 < score[best]) & (inliers.sum() >= sample_size)
    model = torch.where(use2, refit, models[best])
    inl = (torch.where(use2, errs2, errs[best]) < thr) & valid
    return model, inl, inl.sum(), torch.minimum(score2, score[best])


def ransac_adaptive(gens, x1, x2, valid, solver, residual_fn,
                    max_num_trials: int, sample_size: int, max_error,
                    confidence: float = 0.999, min_num_trials: int = 30,
                    chunk: int = 128, draws=None, live=None):
    """Chunked confidence-adaptive RANSAC over a batch of C pairs, with
    preemptive MSAC scoring and one local-optimization refit (COLMAP
    trial-count semantics; the JAX ``lax.while_loop``).

    x1, x2 (C, n, 2); valid (C, n); max_error a float or a (C,) tensor;
    ``gens`` one torch.Generator per pair; ``live`` host bools, the pairs to
    estimate (default all; the others never draw). Each chunk draws for the
    pairs still active, then hypothesizes and scores for all of them; a pair
    stops once its trials reach the confidence bound, and from then on its
    state stays as it was and it draws nothing more, so a pair's result never
    depends on the rest of the batch. The host syncs once per chunk, to learn
    which pairs are still active.

    draws: optional per-pair lists (None for a pair that draws from its
    generator) of per-chunk (samples (chunk, k), sub_idx (SUB,)) indices.
    Returns (model (C, 3, 3), inlier_mask (C, n), num_inliers (C,),
    best_score (C,), trials_used (C,))."""
    C, n = valid.shape
    dev, dtype = x1.device, x1.dtype
    live = np.ones(C, bool) if live is None else np.asarray(live, bool)
    live_t = torch.as_tensor(live, device=dev)
    err = torch.as_tensor(max_error, dtype=dtype, device=dev).expand(C)
    thr = err * err
    thr_c = thr[:, None]
    max_chunks = -(-max_num_trials // chunk)
    log_nom = math.log(max(1.0 - confidence, 1e-12))
    use_pre = n > SUB
    n_valid = valid.sum(1).clamp(min=1).to(torch.float64)
    ar = torch.arange(C, device=dev)
    n_draw = chunk * sample_size + (SUB if use_pre else 0)

    best_score = thr * (n + 1)
    best_model = _eye(3, x1).expand(C, 3, 3).clone()
    best_ninl = torch.zeros(C, dtype=torch.int64, device=dev)
    trials = torch.zeros(C, dtype=torch.int64, device=dev)
    for c in range(max_chunks):
        if c * chunk < min_num_trials:
            active = live_t
            act = live
        else:
            ratio = (best_ninl.to(torch.float64) / n_valid).clamp(0.0, 1.0)
            p_good = (ratio ** sample_size).clamp(1e-12, 1.0 - 1e-9)
            active = live_t & (c * chunk < log_nom / torch.log1p(-p_good))
            act = active.cpu().numpy()              # the chunk's one host sync
        if not act.any():
            break
        on = np.nonzero(act)[0]
        inject = {}
        for s in on:
            if draws is not None and draws[s] is not None:
                smp, sub = draws[s][c]
                inject[s] = torch.cat([smp.reshape(-1)]
                                      + ([sub.reshape(-1)] if use_pre else []))
        idx = _draw_indices(gens, valid, n_draw, on, inject)
        samples = idx[:, :chunk * sample_size].reshape(C, chunk, sample_size)
        models = solver(_gather_rows(x1, samples), _gather_rows(x2, samples),
                        None, False)                # (C, chunk, 3, 3)
        if use_pre:
            sub = idx[:, chunk * sample_size:]
            e = residual_fn(models, _gather_rows(x1, sub)[:, None],
                            _gather_rows(x2, sub)[:, None])
            e = torch.where(torch.gather(valid, 1, sub)[:, None, :], e, thr[:, None, None])
            pre = torch.minimum(e, thr[:, None, None]).sum(-1)
            top = _topk_first(-pre, min(TOP, chunk))
            models = torch.gather(models, 1, top[..., None, None].expand(-1, -1, 3, 3))
        errs = residual_fn(models, x1[:, None], x2[:, None])     # (C, T, n)
        errs = torch.where(valid[:, None, :], errs, thr[:, None, None])
        score = torch.minimum(errs, thr[:, None, None]).sum(-1)
        b = torch.argmin(score, dim=1)
        score_b = score[ar, b]
        better = active & (score_b < best_score)
        ninl = ((errs[ar, b] < thr_c) & valid).sum(1)
        best_model = torch.where(better[:, None, None], models[ar, b], best_model)
        best_ninl = torch.where(better, ninl, best_ninl)
        best_score = torch.where(active, torch.minimum(score_b, best_score), best_score)
        trials = trials + active * chunk

    best_err = residual_fn(best_model[:, None], x1[:, None], x2[:, None])[:, 0]
    best_err = torch.where(valid, best_err, thr_c)
    inliers = (best_err < thr_c) & valid
    refit = solver(x1, x2, inliers)
    errs2 = residual_fn(refit[:, None], x1[:, None], x2[:, None])[:, 0]
    errs2 = torch.where(valid, errs2, thr_c)
    score2 = torch.minimum(errs2, thr_c).sum(-1)
    use2 = (score2 < best_score) & (inliers.sum(-1) >= sample_size)
    model = torch.where(use2[:, None, None], refit, best_model)
    err_f = torch.where(use2[:, None], errs2, best_err)
    inl = (err_f < thr_c) & valid
    return model, inl, inl.sum(-1), torch.minimum(score2, best_score), trials


def _f_solver(x1, x2, mask=None, exact=True):
    return fundamental_8pt(x1, x2, mask, exact=exact)


def _e_solver(x1, x2, mask=None, exact=True):
    return essential_8pt(x1, x2, mask, exact=exact)


def _h_solver(x1, x2, mask=None, exact=True):
    return homography_dlt(x1, x2, mask, exact=exact)


# ---------------------------------------------------------------------------
# Pose recovery (batched: leading dimensions broadcast)
# ---------------------------------------------------------------------------

def _matvec(M, v):
    return (M @ v[..., None])[..., 0]


def _triangulate_simple(R, t, x1n, x2n):
    """Closed-form midpoint triangulation for cheirality checks. R (..., 3,
    3), t (..., 3) cam1 -> cam2; x1n, x2n (..., N, 2). Returns points in the
    cam1 frame (..., N, 3) and depths in both cameras."""
    d1 = _homog(x1n)
    d2 = _homog(x2n) @ R
    c2 = -_matvec(R.mT, t)[..., None, :]
    a = torch.sum(d1 * d1, dim=-1)
    b = torch.sum(d1 * d2, dim=-1)
    c = torch.sum(d2 * d2, dim=-1)
    e1 = torch.sum(d1 * c2, dim=-1)
    e2 = torch.sum(d2 * c2, dim=-1)
    det = a * c - b * b
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    s = (c * e1 - b * e2) / det
    u = (b * e1 - a * e2) / det
    X = 0.5 * (s[..., None] * d1 + c2 + u[..., None] * d2)
    return X, X[..., 2], (X @ R.mT + t[..., None, :])[..., 2]


def _cheirality(R, tv, x1n, x2n, inliers):
    """(count, ok, angles) of the points in front of both cameras."""
    X, z1, z2 = _triangulate_simple(R, tv, x1n, x2n)
    ok = (z1 > 1e-6) & (z2 > 1e-6) & inliers
    c2 = -_matvec(R.mT, tv)[..., None, :]
    ang = geom.triangulation_angle(torch.zeros_like(c2), c2, X)
    return ok.sum(-1), ok, ang


def _best_of_four(Rs, ts, x1n, x2n, inliers):
    """The candidate (C, 4) with the most points in front of both cameras
    (first on ties): its index, R, unit t, and the median triangulation
    angle over its good points (0 when none)."""
    counts, oks, angs = _cheirality(Rs, ts, x1n[:, None], x2n[:, None], inliers[:, None])
    best = torch.argmax(counts, dim=1)
    ar = torch.arange(Rs.shape[0], device=Rs.device)
    okb, angb = oks[ar, best], angs[ar, best]
    ang_sorted = torch.sort(torch.where(okb, angb, torch.full_like(angb, math.inf)), dim=-1)[0]
    ngood = okb.sum(-1)
    med = ang_sorted.gather(-1, torch.clamp(ngood // 2, 0, angb.shape[-1] - 1)[:, None])[:, 0]
    return best, Rs[ar, best], ts[ar, best], ngood, med, counts[ar, best]


def pose_from_essential(E, x1n, x2n, inliers):
    """(qvec, tvec, tri_angle, num_good) of each pair: the 4-fold
    decomposition of E (C, 3, 3) resolved by cheirality voting over the
    inliers (C, N) of x1n, x2n (C, N, 2). One pair's arrays without the
    leading dimension give its values alone."""
    if E.ndim == 2:
        return tuple(v[0] for v in pose_from_essential(E[None], x1n[None], x2n[None],
                                                       inliers[None]))
    U, _, Vh = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[:, None, None]
    Vh = Vh * torch.sign(torch.linalg.det(Vh))[:, None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vh
    R2 = U @ W.T @ Vh
    t = U[..., :, 2]
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)
    Rs = torch.stack([R1, R1, R2, R2], 1)
    ts = torch.stack([t, -t, t, -t], 1)
    _, Rb, tb, ngood, med, count = _best_of_four(Rs, ts, x1n, x2n, inliers)
    tri_angle = torch.where(ngood > 0, med, torch.zeros_like(med))
    return geom.rotmat_to_quat(Rb), tb, tri_angle, count


def decompose_homography(Hc):
    """Candidate (R, t, n) triples of calibrated homographies (..., 3, 3)
    (constructive SVD decomposition, Ma-Soatto-Kosecka Thm 5.19): stacked
    (..., 4, 3, 3) R, (..., 4, 3) t, (..., 4, 3) n."""
    S0 = torch.linalg.svdvals(Hc)
    H = Hc / torch.clamp(S0[..., 1], min=1e-12)[..., None, None]
    _, S, Vh = torch.linalg.svd(H)
    V = Vh.mT
    V = V * torch.sign(torch.linalg.det(V))[..., None, None]
    v1, v2, v3 = V[..., :, 0], V[..., :, 1], V[..., :, 2]
    s1, s3 = S[..., 0:1], S[..., 2:3]
    denom = torch.clamp(s1 * s1 - s3 * s3, min=1e-12)
    a = torch.sqrt(torch.clamp((1.0 - s3 * s3) / denom, min=0.0))
    b = torch.sqrt(torch.clamp((s1 * s1 - 1.0) / denom, min=0.0))

    def sol(u):
        nvec = torch.linalg.cross(v2, u, dim=-1)
        U1 = torch.stack([v2, u, nvec], dim=-1)
        Hv2, Hu = _matvec(H, v2), _matvec(H, u)
        W = torch.stack([Hv2, Hu, torch.linalg.cross(Hv2, Hu, dim=-1)], dim=-1)
        R = W @ U1.mT
        return R, _matvec(H - R, nvec), nvec

    R1, t1, n1 = sol(a * v1 + b * v3)
    R2, t2, n2 = sol(a * v1 - b * v3)
    return (torch.stack([R1, R1, R2, R2], -3), torch.stack([t1, -t1, t2, -t2], -2),
            torch.stack([n1, -n1, n2, -n2], -2))


def pose_from_homography(H, K1, K2, x1n, x2n, inliers):
    """Relative pose of PLANAR_OR_PANORAMIC pairs from K2^-1 H K1 (unit
    tvec; zero when panoramic), cheirality-voted over the H inliers.
    Batched: H, K1, K2 (C, 3, 3), x1n, x2n (C, N, 2), inliers (C, N)."""
    Hc = inv33(K2) @ H @ K1
    p1, p2 = _homog(x1n), _homog(x2n)
    s = torch.sum(torch.where(inliers, torch.sum(p2 * (p1 @ Hc.mT), -1),
                              torch.zeros_like(p1[..., 0])), -1)
    Hc = Hc * torch.where(s < 0, -1.0, 1.0).to(Hc.dtype)[:, None, None]
    Rs, ts, _ = decompose_homography(Hc)
    t_norms = torch.linalg.norm(ts, dim=-1)
    tu = ts / torch.clamp(t_norms, min=1e-12)[..., None]
    best, Rb, tb, ngood, med, count = _best_of_four(Rs, tu, x1n, x2n, inliers)
    panoramic = t_norms.gather(1, best[:, None])[:, 0] < 1e-3
    tb = torch.where(panoramic[:, None], torch.zeros_like(tb), tb)
    tri_angle = torch.where((ngood > 0) & ~panoramic, med, torch.zeros_like(med))
    return geom.rotmat_to_quat(Rb), tb, tri_angle, count


def detect_watermark(x1, x2, inliers, size1, size2, max_error: float,
                     min_inlier_ratio: float = 0.7, border_size: float = 0.1,
                     max_candidates: int = 128, gens=None, cand_idx=None,
                     live=None):
    """Per pair of the batch, True iff its inliers look like a static
    overlay: a pure 2-D translation supported by >= min_inlier_ratio of
    them, concentrated in the image border (COLMAP config WATERMARK).
    x1, x2 (C, N, 2); inliers (C, N); size1, size2 (C, 2) (width, height).
    The candidates are drawn from each live pair's generator (``gens``),
    unless ``cand_idx`` (per pair, None or (max_candidates,) indices)
    injects them."""
    C = x1.shape[0]
    live = np.ones(C, bool) if live is None else np.asarray(live, bool)
    on = np.nonzero(live)[0]
    inject = {s: cand_idx[s] for s in on
              if cand_idx is not None and cand_idx[s] is not None}
    cand_i = _draw_indices(gens, inliers, max_candidates, on, inject)
    d = x2 - x1
    thr = max_error * max_error
    cand = _gather_rows(d, cand_i)
    err = torch.sum((cand[:, :, None, :] - d[:, None, :, :]) ** 2, -1)
    votes = torch.sum((err < thr) & inliers[:, None, :], dim=-1)
    votes = torch.where(torch.gather(inliers, 1, cand_i), votes, torch.full_like(votes, -1))
    best = torch.argmax(votes, dim=1)
    trans_inl = (err[torch.arange(C, device=err.device), best] < thr) & inliers
    n_trans = trans_inl.sum(-1)
    n_inl = torch.clamp(inliers.sum(-1), min=1)

    def in_border(x, size):
        bx, by = border_size * size[:, None, 0], border_size * size[:, None, 1]
        return ((x[..., 0] < bx) | (x[..., 0] > size[:, None, 0] - bx)
                | (x[..., 1] < by) | (x[..., 1] > size[:, None, 1] - by))

    border = trans_inl & in_border(x1, size1) & in_border(x2, size2)
    frac_trans = n_trans.to(x1.dtype) / n_inl.to(x1.dtype)
    frac_border = border.sum(-1).to(x1.dtype) / torch.clamp(n_trans, min=1).to(x1.dtype)
    return (frac_trans >= min_inlier_ratio) & (frac_border >= min_inlier_ratio)


def _first(g: TwoViewGeometry) -> TwoViewGeometry:
    """The first pair of a batched geometry, without the pair dimension."""
    return TwoViewGeometry(**{f.name: getattr(g, f.name)[0]
                              for f in dataclasses.fields(g)})


def estimate_two_view_geometry(gens, x1, x2, valid, K1, K2,
                               calibrated: bool = True, max_error: float = 4.0,
                               min_num_inliers: int = 15,
                               min_inlier_ratio: float = 0.25,
                               num_trials: int = 512, min_num_trials: int = 30,
                               confidence: float = 0.999,
                               watermark_detection: bool = True,
                               size1=None, size2=None, draws=None, live=None
                               ) -> TwoViewGeometry:
    """E/F/H, configuration and relative pose of a batch of verified pairs
    (COLMAP TwoViewGeometry::Estimate decision logic; see the reference).

    Batched over a leading pair dimension, as the JAX stage maps the
    estimator over a chunk: x1, x2 (C, N, 2) pixels; valid (C, N) bool; K1,
    K2 (C, 3, 3); size1, size2 (C, 2) or None (2 x the principal point);
    ``gens`` one torch.Generator per pair, which feeds the F, H and E
    RANSACs and the watermark candidates in turn (with ``calibrated=False``
    the F and H RANSACs and the watermark candidates: E is K2^T F K1, and
    no pair comes back CALIBRATED); ``live`` host bools, the
    pairs to estimate (default all; the others draw nothing and their rows
    are meaningless). A pair's draws and result never depend on the rest of
    the batch. ``draws`` optionally injects, per pair, the sample indices:
    {"F": [...], "H": [...], "E": [...], "wm": cand_idx} with per-chunk
    lists as in :func:`ransac_adaptive`.

    One pair's arrays without the leading dimension (``gens`` a generator,
    ``draws`` a dict) give the batch of one, returned without it."""
    if x1.ndim == 2:
        return _first(estimate_two_view_geometry(
            [gens], x1[None], x2[None], valid[None], K1[None], K2[None], calibrated,
            max_error, min_num_inliers, min_inlier_ratio, num_trials, min_num_trials,
            confidence, watermark_detection,
            None if size1 is None else size1[None], None if size2 is None else size2[None],
            [draws]))
    C = x1.shape[0]
    live = np.ones(C, bool) if live is None else np.asarray(live, bool)

    def injected(key):
        got = [d.get(key) if d else None for d in (draws or [None] * C)]
        return got if any(g is not None for g in got) else None

    kw = dict(confidence=confidence, min_num_trials=min_num_trials, live=live)
    F, inl_F, n_F, _, _ = ransac_adaptive(
        gens, x1, x2, valid, _f_solver, sampson_error, num_trials, 8,
        max_error, draws=injected("F"), **kw)
    F = enforce_rank2(F)
    F = F / torch.clamp(torch.linalg.norm(F, dim=(-2, -1), keepdim=True), min=1e-12)
    H, inl_H, n_H, _, _ = ransac_adaptive(
        gens, x1, x2, valid, _h_solver, homography_error, num_trials, 4,
        max_error, draws=injected("H"), **kw)

    fxy1 = torch.stack([K1[:, 0, 0], K1[:, 1, 1]], -1)
    fxy2 = torch.stack([K2[:, 0, 0], K2[:, 1, 1]], -1)
    x1n = (x1 - K1[:, None, :2, 2]) / fxy1[:, None]
    x2n = (x2 - K2[:, None, :2, 2]) / fxy2[:, None]
    if calibrated:
        thr_n = max_error / (0.5 * (fxy1.mean(-1) + fxy2.mean(-1)))
        E, inl_E, n_E, _, _ = ransac_adaptive(
            gens, x1n, x2n, valid, _e_solver, sampson_error, num_trials, 8, thr_n,
            draws=injected("E"), **kw)
        use_E = n_E.float() >= 0.95 * n_F.float()
    else:
        # no E RANSAC (nothing drawn for it): E's inliers are F's, and the
        # pose comes from K2^T F K1 (configuration UNCALIBRATED or planar)
        E, inl_E, n_E = K2.mT @ F @ K1, inl_F, n_F
        use_E = torch.zeros_like(n_F, dtype=torch.bool)
    epi_inl = torch.where(use_E[:, None], inl_E, inl_F)
    n_epi = torch.where(use_E, n_E, n_F)
    planar = n_H.float() > 0.8 * n_epi.float()
    enough = (n_epi >= min_num_inliers) & (
        n_epi.float() >= min_inlier_ratio * torch.clamp(valid.sum(-1), min=1).float())
    config = torch.where(~enough, DEGENERATE, torch.where(
        planar, PLANAR_OR_PANORAMIC, torch.where(use_E, CALIBRATED, UNCALIBRATED)))

    if watermark_detection:
        s1 = 2.0 * K1[:, :2, 2] if size1 is None else size1
        s2 = 2.0 * K2[:, :2, 2] if size2 is None else size2
        wm = detect_watermark(x1, x2, inl_H, s1, s2, max_error, gens=gens,
                              cand_idx=injected("wm"), live=live)
        config = torch.where(enough & wm, WATERMARK, config)
        planar = planar & ~wm

    E_pose = torch.where(use_E[:, None, None], E, K2.mT @ F @ K1)
    Ue, Se, Vhe = torch.linalg.svd(E_pose)
    s = 0.5 * (Se[:, 0] + Se[:, 1])
    E_pose = Ue @ (torch.stack([s, s, torch.zeros_like(s)], -1)[..., None] * Vhe)
    qvec_e, tvec_e, tri_e, _ = pose_from_essential(E_pose, x1n, x2n, epi_inl)
    qvec_h, tvec_h, tri_h, _ = pose_from_homography(H, K1, K2, x1n, x2n, inl_H)
    p = planar[:, None]
    n_pair = torch.where(planar, n_H, n_epi)
    return TwoViewGeometry(
        config=config, E=E_pose, F=F, H=H, qvec=torch.where(p, qvec_h, qvec_e),
        tvec=torch.where(p, tvec_h, tvec_e),
        tri_angle=torch.where(planar, tri_h, tri_e),
        inlier_mask=torch.where(p, inl_H, epi_inl) & enough[:, None],
        num_inliers=torch.where(enough, n_pair, torch.zeros_like(n_pair)))


def estimate_two_view_geometry_multiple(gens, x1, x2, valid, K1, K2,
                                        max_models: int = 3,
                                        min_num_inliers: int = 15, **kw):
    """COLMAP ``TwoViewGeometry::EstimateMultiple`` (JAX
    ``estimate_two_view_geometry_multiple``) over a batch of pairs: estimate
    a geometry, remove its inliers, re-estimate on the remainder, for
    ``max_models`` rounds.

    ``gens`` holds per pair one torch.Generator per round (at least
    ``max_models``; None for a pair that is not live), so a round's draws
    never depend on batching. Other keywords go to
    :func:`estimate_two_view_geometry`, with the same batched shapes; one
    pair's arrays without the leading dimension (``gens`` its list of
    generators) give the batch of one. Returns one TwoViewGeometry per
    round; a round that found fewer than ``min_num_inliers`` inliers is
    zeroed (empty mask, 0 inliers, DEGENERATE)."""
    if x1.ndim == 2:
        if len(gens) < max_models:
            raise ValueError(f"need {max_models} generators, got {len(gens)}")
        return [_first(g) for g in estimate_two_view_geometry_multiple(
            [gens], x1[None], x2[None], valid[None], K1[None], K2[None],
            max_models=max_models, min_num_inliers=min_num_inliers, **kw)]
    if any(g is not None and len(g) < max_models for g in gens):
        raise ValueError(f"need {max_models} generators per pair")
    remaining = valid
    models = []
    for r in range(max_models):
        g = estimate_two_view_geometry([None if gp is None else gp[r] for gp in gens],
                                       x1, x2, remaining, K1, K2,
                                       min_num_inliers=min_num_inliers, **kw)
        found = g.num_inliers >= min_num_inliers
        g.inlier_mask = g.inlier_mask & found[:, None]
        g.num_inliers = torch.where(found, g.num_inliers,
                                    torch.zeros_like(g.num_inliers))
        g.config = torch.where(found, g.config,
                               torch.full_like(g.config, DEGENERATE))
        remaining = remaining & ~g.inlier_mask
        models.append(g)
    return models
