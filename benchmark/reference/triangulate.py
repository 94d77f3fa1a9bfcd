"""The plain reference of the program's multi-view triangulation: the
points its merge retriangulates (``ops/triangulate.triangulate_tracks``).

Plain ``torch`` in float64, one track at a time, with TF32 off; it
imports no part of the program. It follows COLMAP's
``TriangulateMultiViewPoint`` (``src/colmap/geometry/triangulation.cc``)
and the acceptance tests of COLMAP's incremental triangulator, with these
departures, each of which the program shares:

- The system. COLMAP sums over the views the 4x4 normal matrix of the
  projector term ``P - x x^T P`` (x the view's normalised homogeneous ray)
  and takes the eigenvector of its smallest eigenvalue. Here each view
  gives the two rows ``u P_3 - P_1`` and ``v P_3 - P_2`` of the classical
  DLT system, and the point is the right singular vector of the smallest
  singular value of the track's 2M x 4 system (the program takes the
  eigenvector of that system's normal matrix, which is the same vector
  with the condition number squared). Both give the true point on
  noise-free data; they weight noisy views differently. A masked view's
  rows are zero in the program's system and change no singular vector,
  so only the observed views' rows are built here.
- No RANSAC over a track's views (COLMAP's ``EstimateTriangulation``):
  every observed view enters the solve, and the tests below then drop
  the views that fail.
- The tests, as the program's: a view passes with a depth above 1e-6 and
  a reprojection error under the track's threshold in normalised units
  (COLMAP: squared pixel error under ``max_reproj_error``^2); a track is
  accepted with two passing views whose rays meet at ``min_tri_angle`` or
  more (COLMAP: the angle of any pair of the views used).
- A track's w below 1e-12 in magnitude is replaced by 1e-12 before the
  point is dehomogenised, as in the program (COLMAP divides by it).
- Poses are world-to-camera wxyz quaternions and translations, as the
  program stores them; coordinates are normalised (K^-1 applied).
"""

from __future__ import annotations

import contextlib
import math

import torch

DEPTH_MIN = 1e-6      # cheirality: depth in the camera above this
W_MIN = 1e-12         # homogeneous w clamped away from zero


@contextlib.contextmanager
def no_tf32():
    """TF32 off in matrix products for the block (it is off for float64
    anyway; the reference states it)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rotation(q: torch.Tensor) -> torch.Tensor:
    """A wxyz quaternion, normalised first, as a 3x3 rotation."""
    w, x, y, z = (q / torch.linalg.norm(q)).tolist()
    return torch.tensor([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], dtype=torch.float64, device=q.device)


def triangulate_point(P: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """One track's point from its observed views: P (M, 3, 4) projections
    [R|t], xn (M, 2) normalised coordinates. The right singular vector of
    the smallest singular value of the 2M x 4 DLT system, dehomogenised."""
    rows = []
    for m in range(len(P)):
        rows.append(xn[m, 0] * P[m, 2] - P[m, 0])
        rows.append(xn[m, 1] * P[m, 2] - P[m, 1])
    A = torch.stack(rows)
    _, _, Vh = torch.linalg.svd(A)
    X = Vh[-1]
    w = X[3]
    if abs(float(w)) < W_MIN:
        w = torch.tensor(W_MIN, dtype=X.dtype, device=X.device)
    return X[:3] / w


def accept(R, t, xn, xyz, thr_n: float, min_tri_angle: float):
    """(ok, view_ok (M,)) of one track's point against its views."""
    x_cam = R @ xyz + t                       # (M, 3)
    z = x_cam[:, 2]
    view_ok = []
    for m in range(len(R)):
        zm = float(z[m])
        zs = zm if abs(zm) >= W_MIN else W_MIN
        err = float(torch.linalg.norm(x_cam[m, :2] / zs - xn[m]))
        view_ok.append(zm > DEPTH_MIN and err < thr_n)
    centres = [-(R[m].T @ t[m]) for m in range(len(R))]
    widest = 0.0
    for a in range(len(R)):
        for b in range(len(R)):
            if not (view_ok[a] and view_ok[b]):
                continue
            ra, rb = centres[a] - xyz, centres[b] - xyz
            ra = ra / max(float(torch.linalg.norm(ra)), W_MIN)
            rb = rb / max(float(torch.linalg.norm(rb)), W_MIN)
            cos = min(max(float(ra @ rb), -1.0), 1.0)
            widest = max(widest, math.acos(cos))
    ok = sum(view_ok) >= 2 and widest >= min_tri_angle
    return ok, view_ok


def triangulate_tracks(qvecs, tvecs, xn, mask, max_reproj_error_n, min_tri_angle: float):
    """The program's ``triangulate_tracks`` contract, one track at a time.

    qvecs (B, M, 4), tvecs (B, M, 3), xn (B, M, 2), mask (B, M) bool,
    max_reproj_error_n a number or (B,), min_tri_angle in radians.
    Returns (xyz (B, 3), ok (B,), view_ok (B, M)); a view outside the mask
    never passes."""
    qvecs, tvecs, xn = (torch.as_tensor(a, dtype=torch.float64) for a in (qvecs, tvecs, xn))
    mask = torch.as_tensor(mask, dtype=torch.bool, device=qvecs.device)
    B, M = mask.shape
    thr = torch.as_tensor(max_reproj_error_n, dtype=torch.float64).reshape(-1)
    thr = thr.expand(B) if thr.numel() == 1 else thr
    xyz = torch.zeros(B, 3, dtype=torch.float64, device=qvecs.device)
    ok = torch.zeros(B, dtype=torch.bool)
    view_ok = torch.zeros(B, M, dtype=torch.bool)
    with no_tf32():
        for b in range(B):
            views = torch.nonzero(mask[b]).flatten().tolist()
            R = torch.stack([rotation(qvecs[b, m]) for m in views])
            t = tvecs[b, views]
            P = torch.cat([R, t[:, :, None]], dim=2)
            xyz[b] = triangulate_point(P, xn[b, views])
            good, per_view = accept(R, t, xn[b, views], xyz[b], float(thr[b]), min_tri_angle)
            ok[b] = good
            view_ok[b, views] = torch.tensor(per_view, dtype=torch.bool)
    return xyz, ok, view_ok
