"""The host-only stages (``prepare_images``, ``run_prepare_patch_match``), ms
per offered image, from their spans summed over the untraced window's
passes."""


def read(t):
    return t.stage_ms_per_image("prepare_images", "run_prepare_patch_match")
