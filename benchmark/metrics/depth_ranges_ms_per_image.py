"""``run_prepare_patch_match``'s per-point loop over each image's sparse
points (the program's ``prepare_patch_match.depth_ranges`` spans) in the
traced pass, ms per offered image. None where the program records no such
span."""

from benchmark.harness import program


def read(t):
    s = program.span_seconds("prepare_patch_match", "prepare_patch_match.depth_ranges")
    return None if s is None else 1e3 * s / t.images
