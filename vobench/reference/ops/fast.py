"""Dense FAST-9/16 corner score.

Port of svo_tpu/ops/fast.py: the 16-pixel Bresenham ring becomes 16
shifted copies of the image and the score is the largest threshold at
which the pixel is still a corner, in closed form.
"""

from __future__ import annotations

import torch

# OpenCV's 16-point Bresenham circle of radius 3, clockwise from 12 o'clock,
# as (dx, dy) offsets.
RING = (
    (0, -3), (1, -3), (2, -2), (3, -1),
    (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1),
    (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)

ARC = 9  # FAST-9: at least 9 contiguous ring pixels brighter/darker


def fast_score(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """(..., H, W) f32 image in [0, 255] -> (..., H, W) score map; score >
    0 exactly where the FAST-9 test at `threshold` passes (the margin of the
    best contiguous arc above the threshold). A 3-pixel border is zero."""
    H, W = img.shape[-2:]
    d = torch.stack(
        [torch.roll(img, (-dy, -dx), dims=(-2, -1)) - img for dx, dy in RING]
    )  # (16, ..., H, W): ring minus centre
    d_ext = torch.cat([d, d[: ARC - 1]], dim=0)  # circular windows
    bright_best = torch.full_like(img, -torch.inf)
    dark_best = torch.full_like(bright_best, -torch.inf)
    for s in range(16):
        w = d_ext[s : s + ARC]
        bright_best = torch.maximum(bright_best, w.amin(dim=0))
        dark_best = torch.maximum(dark_best, (-w).amin(dim=0))
    score = torch.clamp(torch.maximum(bright_best, dark_best) - threshold, min=0.0)
    # zero the 3px border (the ring wraps around the image via roll)
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    interior = (ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3)
    return torch.where(interior, score, 0.0)
