"""Kernel 2: sparse Schur accumulation (``csrc/schur.cu``).

Replaces the Pallas TPU kernel ``scanner_colmap_tpu/ops/pallas_ba.py
::_schur_kernel`` (``schur_accumulate``): the point-block part
S = sum_p B_p Vinv_p B_p^T of the dense-Schur reduced camera system that
``ops/ba._build_normal_eqs`` assembles in every LM trial. The kernel takes
the per-observation coupling blocks before they are scattered by camera —
cam_idx (P, T), Wc (P, T, 8, 3), Vinv (P, 3, 3) — so the dense (P, M*8, 3)
B of the TPU kernel never exists.

The kernel is output-stationary: a block holds one 128 x 128 tile of S (16
cameras by 16) in registers, queues the slots of its points whose camera
lies in the tile's windows, merges a track's slots that see one camera, and
adds each camera pair once per point, in point order. When tiles alone
cannot fill the card, the points are split over up to 128 blocks
(``launch_plan``) in one cooperative launch: each block writes its partial
tile to a workspace, all pass one grid-wide barrier, and each then sums its
share of the tile over the splits in a fixed order. There are no float
atomics, so S is bitwise the same from run to run, and every element of S
is written once, so it needs no memset: one kernel launch per call. What
bounds it at the main path's sizes is latency (a chain of dependent loads
and barriers), not bytes or operations; see the source note. Cameras
outside [0, M) are ignored by the kernel.

``schur_accumulate`` launches the kernel on CUDA tensors and takes the
plain PyTorch version (``schur_accumulate_plain``, the literal one-hot B
per chunk and the einsum pair of ``ba.py``) only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from scanner_colmap_tpu_torch.kernels import _build

NUM_CAM_PARAMS = 8
T_MAX = 32
WINDOW = 16          # cameras per output tile side (128 rows of S)
# blocks a launch with split tiles may have: all of them must be resident at
# once (a cooperative launch, for the grid-wide barrier), and the kernel
# holds one block per SM; an H100 SXM has 132
MAX_SPLIT_BLOCKS = 128
MIN_SPLIT_POINTS = 8   # mapping's M=8, P=1024 calls: 128 blocks beat 64


def schur_dense(B: torch.Tensor, Vinv: torch.Tensor) -> torch.Tensor:
    """S = sum_p B[p] Vinv[p] B[p]^T for a dense B (P, MC, 3)."""
    BV = torch.einsum("pai,pij->paj", B, Vinv)
    return torch.einsum("pai,pbi->ab", BV, B)


def schur_accumulate_plain(cam_idx: torch.Tensor, Wc: torch.Tensor,
                           Vinv: torch.Tensor, M: int,
                           chunk: int = 1024) -> torch.Tensor:
    """Dense reference: scatter Wc into a one-hot B per point chunk, then
    the einsum pair (ba._build_normal_eqs chunk_body)."""
    P, T = cam_idx.shape
    MC = M * NUM_CAM_PARAMS
    S = torch.zeros((MC, MC), dtype=Wc.dtype, device=Wc.device)
    for s in range(0, P, chunk):
        oh = torch.nn.functional.one_hot(cam_idx[s:s + chunk].long(),
                                         M).to(Wc.dtype)
        B = torch.einsum("ptm,ptij->pmij", oh, Wc[s:s + chunk])
        S = S + schur_dense(B.reshape(B.shape[0], MC, 3), Vinv[s:s + chunk])
    return S


def launch_plan(M: int, P: int):
    """(windows, tiles, splits): the kernel's grid, a function of (M, P)
    only. Tiles are the window pairs R1 <= R2 (``tile_windows``); splits,
    the blocks per tile, is as many as keep tiles x splits within
    MAX_SPLIT_BLOCKS and at least MIN_SPLIT_POINTS points a block."""
    windows = -(-M // WINDOW)
    tiles = windows * (windows + 1) // 2
    splits = min(MAX_SPLIT_BLOCKS // tiles, -(-P // MIN_SPLIT_POINTS))
    return windows, tiles, max(splits, 1)


def tile_windows(windows: int, tile: int):
    """(R1, R2) of tile index ``tile``: the upper triangle row by row, as
    the kernel walks it."""
    r1 = 0
    while tile >= windows - r1:
        tile -= windows - r1
        r1 += 1
    return r1, r1 + tile


def _check(cam_idx, Wc, Vinv, M):
    if cam_idx.dtype != torch.int32 or cam_idx.dim() != 2:
        raise ValueError(f"cam_idx must be (P, T) int32, got "
                         f"{tuple(cam_idx.shape)} {cam_idx.dtype}")
    P, T = cam_idx.shape
    # f32; the plain version also sums f64 (CPU tensors only)
    dtypes = (torch.float32,) if Wc.is_cuda else (torch.float32, torch.float64)
    if Wc.dtype not in dtypes or tuple(Wc.shape) != (P, T, NUM_CAM_PARAMS, 3):
        raise ValueError(f"Wc must be ({P}, {T}, 8, 3) f32, got "
                         f"{tuple(Wc.shape)} {Wc.dtype}")
    if Vinv.dtype != Wc.dtype or tuple(Vinv.shape) != (P, 3, 3):
        raise ValueError(f"Vinv must be ({P}, 3, 3) of Wc's dtype, got "
                         f"{tuple(Vinv.shape)} {Vinv.dtype}")
    if M < 1:
        raise ValueError("M must be positive")
    devs = {t.device for t in (cam_idx, Wc, Vinv)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    if cam_idx.is_cuda:
        if T > T_MAX:
            raise ValueError(f"track length T={T} exceeds {T_MAX}")
        for name, t in (("cam_idx", cam_idx), ("Wc", Wc), ("Vinv", Vinv)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if Wc.data_ptr() % 16:
            raise ValueError("Wc must be 16-byte aligned (the kernel loads float4)")
        windows = -(-M // WINDOW)
        if P * T >= 2 ** 31 or windows * (windows + 1) // 2 > 65535:
            raise ValueError(f"P*T={P * T} or M={M} too large for the kernel's "
                             "int32 slot index or its grid")


def schur_accumulate(cam_idx: torch.Tensor, Wc: torch.Tensor,
                     Vinv: torch.Tensor, M: int) -> torch.Tensor:
    """S (M*8, M*8) = sum_p B_p Vinv_p B_p^T from the unscattered blocks.

    Slots with Wc == 0 are dead. On the card, camera indices outside
    [0, M) are ignored (the plain version's one_hot rejects them), and S is
    bitwise the same from run to run. One kernel launch per call, counted
    in ``schur_accumulate.launches``."""
    _check(cam_idx, Wc, Vinv, M)
    if not cam_idx.is_cuda:
        return schur_accumulate_plain(cam_idx, Wc, Vinv, M)
    P, T = cam_idx.shape
    if T == 0:
        P, T = 0, 1
    MC = M * NUM_CAM_PARAMS
    windows, tiles, splits = launch_plan(M, P)
    S = torch.empty((MC, MC), dtype=torch.float32, device=Wc.device)
    n_ws = tiles * splits * (WINDOW * NUM_CAM_PARAMS) ** 2
    ws = torch.empty(n_ws if splits > 1 else 0, dtype=torch.float32,
                     device=Wc.device)
    lib = _lib()
    stream = torch.cuda.current_stream(Wc.device).cuda_stream
    _build.check(lib.schur_launch(
        cam_idx.data_ptr(), Wc.data_ptr(), Vinv.data_ptr(), P, T, M, windows,
        splits, S.data_ptr(), ws.data_ptr(), stream), "schur")
    schur_accumulate.launches += 1
    return S


schur_accumulate.launches = 0

def _lib():
    lib = _build.load_library("schur")
    fn = lib.schur_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
    return lib
