"""Image ingest on the host: decode, EXIF focal, gray, downscale, pad.

The port's own copy of what its stages use from the JAX package's
``ops/image.py``: ``list_images``, ``to_grayscale``, ``pad_to_canvas`` and
``load_for_extraction`` with their helpers. Ids follow sorted path order.
PIL is imported only where a file is decoded.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from scanner_colmap_tpu_torch.utils.metrics import span

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".ppm", ".pgm"}


def list_images(image_dir: str) -> List[str]:
    """Sorted image paths (order defines image ids)."""
    out = []
    for name in sorted(os.listdir(image_dir)):
        if os.path.splitext(name)[1].lower() in IMAGE_EXTS:
            out.append(os.path.join(image_dir, name))
    return out


def decode_image(path: str) -> np.ndarray:
    """Decode to RGB uint8 (H, W, 3)."""
    from PIL import Image as PILImage

    with PILImage.open(path) as im:
        return np.asarray(im.convert("RGB"))


def exif_focal_px(path: str, width: int) -> Optional[float]:
    """Focal length in pixels from EXIF (COLMAP-style priority):

    1. FocalLength (mm) + FocalPlaneXResolution / FocalPlaneResolutionUnit,
       which give the sensor width: focal_px = f_mm / sensor_w_mm * width.
    2. FocalLengthIn35mmFilm fallback: focal_35 / 36.0 * width (an integer
       tag, so up to ~2% rounding).

    Returns None when neither is available (no sensor-database guessing)."""
    try:
        from PIL import Image as PILImage
        from PIL.ExifTags import TAGS

        with PILImage.open(path) as im:
            exif = im.getexif()
        if not exif:
            return None
        vals = {TAGS.get(k, k): v for k, v in exif.items()}
        # merge EXIF IFD where focal tags usually live
        try:
            ifd = exif.get_ifd(0x8769)
            vals.update({TAGS.get(k, k): v for k, v in ifd.items()})
        except Exception:
            pass
        f_mm = vals.get("FocalLength")
        xres = vals.get("FocalPlaneXResolution")
        unit = vals.get("FocalPlaneResolutionUnit", 2)
        exif_w = vals.get("ExifImageWidth") or width
        if f_mm and xres:
            unit_mm = {2: 25.4, 3: 10.0, 4: 1.0, 5: 0.001}.get(int(unit))
            if unit_mm and float(xres) > 0:
                sensor_w_mm = float(exif_w) / float(xres) * unit_mm
                if sensor_w_mm > 0:
                    return float(f_mm) / sensor_w_mm * width
        f35 = vals.get("FocalLengthIn35mmFilm")
        if f35:
            return float(f35) / 36.0 * width
        return None
    except Exception:
        return None


def to_grayscale(rgb: np.ndarray) -> np.ndarray:
    """ITU-R BT.601 luma, float32 in [0, 1]."""
    w = np.array([0.299, 0.587, 0.114], np.float32)
    return (rgb.astype(np.float32) @ w) / 255.0


def resize_max(img: np.ndarray, max_size: int) -> Tuple[np.ndarray, float]:
    """Downscale so max(H, W) <= max_size, PIL bilinear on the host.

    Returns (resized, scale) with scale = new / old (<= 1)."""
    from PIL import Image as PILImage

    h, w = img.shape[:2]
    m = max(h, w)
    if m <= max_size:
        return img, 1.0
    scale = max_size / m
    nh, nw = int(round(h * scale)), int(round(w * scale))
    mode = "F" if img.ndim == 2 else "RGB"
    pim = PILImage.fromarray(img if img.ndim == 3 else img.astype(np.float32), mode)
    out = np.asarray(pim.resize((nw, nh), PILImage.BILINEAR))
    return out, scale


def pad_to_canvas(img: np.ndarray, canvas_hw: Tuple[int, int]) -> np.ndarray:
    """Zero-pad bottom/right to a fixed canvas."""
    H, W = canvas_hw
    h, w = img.shape[:2]
    if h > H or w > W:
        raise ValueError(f"image {img.shape} exceeds canvas {canvas_hw}")
    pad = [(0, H - h), (0, W - w)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad)


def load_for_extraction(path: str, max_image_size: int,
                        canvas: Tuple[int, int]):
    """Full ingest for one image: decode -> gray -> downscale -> pad.

    Returns a dict with the uint8 (H, W) canvas image (8-bit grayscale;
    consumers cast on the device), valid (h, w), the downscale factor (to
    map keypoints back to original pixels), original (width, height), and
    the EXIF focal in ORIGINAL pixels (or None).
    """
    with span("image.decode"):
        rgb = decode_image(path)
        oh, ow = rgb.shape[:2]
        gray = to_grayscale(rgb)
        gray, scale = resize_max(gray, max_image_size)
    h, w = gray.shape
    out = pad_to_canvas(gray, canvas)
    # gray is [0, 1] luma: quantize to 8-bit levels for the transfer
    out = np.clip(np.round(out * 255.0), 0, 255).astype(np.uint8)
    return {
        "image": out,
        "valid_hw": np.array([h, w], np.int32),
        "scale": scale,
        "orig_wh": (ow, oh),
        "exif_focal_px": exif_focal_px(path, ow),
        "name": os.path.basename(path),
    }
