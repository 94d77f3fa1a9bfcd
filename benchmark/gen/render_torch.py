"""The blob field rendered on the card: the same frames as
``scene.render_frames``, in float64, a few large calls a frame.

Each frame's sub-blobs are projected on the host (a few thousand points),
grouped by their window radius, and splatted chunk by chunk: every blob of
a chunk gets a (2R+1)^2 patch, R the chunk's largest radius, masked to the
blob's own window as the plain renderer clips it, and the patches are
added into the frame with one ``index_add_``. Only the order of the sums
differs from the plain renderer, so a pixel can differ by one grey level
where its value falls on a rounding edge.
"""

from __future__ import annotations

import numpy as np

from benchmark.gen.scene import project_blobs

PATCH_ELEMENTS = 1 << 25   # float64 patch elements a chunk holds (256 MiB)


def render_torch(scene: dict, width: int, height: int, focal: float, device):
    """(N, height, width) uint8 frames on ``device``."""
    import torch

    n = len(scene["qvecs"])
    out = torch.empty((n, height, width), dtype=torch.uint8, device=device)
    signed = scene["signs"] * scene["amps"]
    for i in range(n):
        u, v, s, cand = project_blobs(scene, i, width, height, focal)
        idx = np.nonzero(cand)[0]
        u, v, s = u[idx], v[idx], s[idx]
        r = (4 * s).astype(np.int64) + 1
        iu, iv = np.trunc(u).astype(np.int64), np.trunc(v).astype(np.int64)
        keep = ((np.minimum(iv + r + 1, height) > np.maximum(iv - r, 0))
                & (np.minimum(iu + r + 1, width) > np.maximum(iu - r, 0)))
        idx, u, v, s, r, iu, iv = (a[keep] for a in (idx, u, v, s, r, iu, iv))
        order = np.argsort(r, kind="stable")
        img = torch.full((height * width,), 0.15, dtype=torch.float64, device=device)
        start = 0
        while start < len(order):
            R = int(r[order[start]])
            stop = start
            # grow the chunk while its largest patch keeps within the budget
            while stop < len(order):
                R = int(r[order[stop]])
                if (stop - start + 1) * (2 * R + 1) ** 2 > PATCH_ELEMENTS and stop > start:
                    R = int(r[order[stop - 1]])
                    break
                stop += 1
            sel = order[start:stop]
            start = stop
            t = lambda a, dt=torch.float64: torch.as_tensor(a[sel], dtype=dt, device=device)  # noqa: E731
            bu, bv, bs, br = t(u), t(v), t(s), t(r, torch.int64)
            biu, biv, amp = t(iu, torch.int64), t(iv, torch.int64), t(signed[idx])
            off = torch.arange(-R, R + 1, device=device)
            ys = biv[:, None] + off                       # (B, 2R+1)
            xs = biu[:, None] + off
            my = (off.abs()[None] <= br[:, None]) & (ys >= 0) & (ys < height)
            mx = (off.abs()[None] <= br[:, None]) & (xs >= 0) & (xs < width)
            dy2 = (ys.to(torch.float64) - bv[:, None]) ** 2
            dx2 = (xs.to(torch.float64) - bu[:, None]) ** 2
            patch = torch.exp(-(dx2[:, None, :] + dy2[:, :, None])
                              / (2 * bs * bs)[:, None, None])
            mask = my[:, :, None] & mx[:, None, :]
            flat = (ys.clamp(0, height - 1)[:, :, None] * width
                    + xs.clamp(0, width - 1)[:, None, :])
            img.index_add_(0, flat[mask], (amp[:, None, None] * patch)[mask])
        out[i] = (img.clamp(0, 1) * 255).to(torch.uint8).view(height, width)
    return out
