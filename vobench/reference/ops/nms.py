"""Non-maximum suppression and the dense suppression mask.

Port of svo_tpu/ops/nms.py (nms3x3, suppression_mask).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _window_max(img: torch.Tensor, size: int) -> torch.Tensor:
    """Separable sliding-window max with -inf padding, (..., H, W)."""
    pad = size // 2
    x = img.reshape((-1, 1) + img.shape[-2:])
    x = F.max_pool2d(x, (size, 1), stride=1, padding=(pad, 0))
    x = F.max_pool2d(x, (1, size), stride=1, padding=(0, pad))
    return x.reshape(img.shape)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep score only at 3x3 local maxima (ties all kept, as svo_tpu)."""
    m = _window_max(score, 3)
    return torch.where((score >= m) & (score > 0), score, 0.0)


def suppression_mask(
    shape: tuple[int, int],
    pos: torch.Tensor,
    valid: torch.Tensor,
    halfwidth: int,
) -> torch.Tensor:
    """(..., H, W) bool mask, True where detection is suppressed: a
    (2*halfwidth+1)^2 square around every valid feature's truncated
    (x, y) position. shape is (H, W); pos (..., N, 2), valid (..., N)."""
    H, W = shape
    x = torch.clamp(pos[..., 0].to(torch.int32), 0, W - 1).long()
    y = torch.clamp(pos[..., 1].to(torch.int32), 0, H - 1).long()
    hits = torch.zeros(valid.shape[:-1] + (H * W,), dtype=torch.float32, device=pos.device)
    hits.scatter_add_(-1, y * W + x, valid.to(torch.float32))
    hits = hits.reshape(valid.shape[:-1] + (H, W))
    return _window_max(hits, 2 * halfwidth + 1) > 0.0
