"""Hand-written CUDA kernels for Hopper: one per Pallas TPU kernel of the
JAX package (``pair_match``, ``schur``, ``top2``), and ``plane_cost``,
PatchMatch's cost and Jacobi sweep, which the JAX package leaves to XLA's
fusion. Sources live in ``csrc/``; ``_build`` compiles them with ``nvcc``
at first use on a CUDA tensor. Every wrapper takes its plain PyTorch
version for CPU tensors only and counts its launches in
``<wrapper>.launches``."""

from scanner_colmap_tpu_torch.kernels import pair_match as _pair_match_mod
from scanner_colmap_tpu_torch.kernels import plane_cost as _plane_cost_mod
from scanner_colmap_tpu_torch.kernels import schur as _schur_mod
from scanner_colmap_tpu_torch.kernels import top2 as _top2_mod

# name -> (wrapper, CUDA source, the TPU kernel or XLA function it replaces)
KERNELS = {
    "pair_match": (_pair_match_mod.pair_match,
                   "scanner_colmap_tpu_torch/kernels/csrc/pair_match.cu",
                   "scanner_colmap_tpu/ops/pallas_matching.py:129"),
    "schur": (_schur_mod.schur_accumulate,
              "scanner_colmap_tpu_torch/kernels/csrc/schur.cu",
              "scanner_colmap_tpu/ops/pallas_ba.py:44"),
    "top2": (_top2_mod.top2_bank,
             "scanner_colmap_tpu_torch/kernels/csrc/top2.cu",
             "scanner_colmap_tpu/ops/pallas_matching.py:38"),
    "plane_cost": (_plane_cost_mod.plane_cost,
                   "scanner_colmap_tpu_torch/kernels/csrc/plane_cost.cu",
                   "scanner_colmap_tpu/ops/patch_match.py:251"),
}


def reset_launch_counts() -> None:
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0


def launch_counts() -> dict:
    return {name: wrapper.launches for name, (wrapper, _, _) in KERNELS.items()}
