"""Kernel 1 (``kernels/pair_match.py``, bf16 similarity on the tensor
cores, the best and second-best match of each row and column), frozen from
``chip_smoke.py``'s kernel-1 check.

Per call: 2 x 128 operations for each similarity of a valid descriptor of
image a with a valid one of image b, summed over the pairs; bytes: the bf16
pool and the f32 validity read once, the pair indices, and per pair and
slot the best, second, index and column key written once.
"""

KIND = "bf16"
DEVICE_KERNELS = ("pair_match_kernel",)
DESC_DIM = 128


def work(valid_products: float, pool_elements: int, valid_elements: int, pairs: int,
         slots: int):
    """(operations, bytes) of one call. valid_products: the sum over the
    pairs of (valid descriptors of a) x (valid descriptors of b); with
    every slot valid it is pairs x slots^2."""
    flops = 2.0 * DESC_DIM * valid_products
    nbytes = (pool_elements * 2 + valid_elements * 4 + 2 * pairs * 4
              + pairs * slots * (4 + 4 + 4 + 8))
    return flops, nbytes
