"""Matching and two-view verification (``run_matching``), ms per offered
image, from its span summed over the untraced window's passes."""


def read(t):
    return t.stage_ms_per_image("run_matching")
