"""Dense FAST-9/16 corner score.

Port of svo_tpu/ops/fast.py: the 16-pixel Bresenham ring becomes 16
shifted copies of the image and the score is the largest threshold at
which the pixel is still a corner, in closed form.

fast_nms(img, threshold, suppress) is what both detectors call: the score,
the 3x3 non-maximum suppression and the optional suppression mask. On a
CUDA tensor it launches the hand-written kernel csrc/fast_nms.cu once for
all streams, bit-equal to the plain composition; on a CPU tensor it runs
fast_nms_ref, the plain composition (the CPU tests' path, and what the card
tests hold the kernel against).
"""

from __future__ import annotations

import ctypes

import torch

from svo_tpu_torch import _build
from svo_tpu_torch.ops import nms

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


def fast_nms_ref(img: torch.Tensor, threshold: float,
                 suppress: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of fast_nms: nms3x3(fast_score(img, threshold)), zero
    where `suppress` (the image's shape, bool) is True."""
    score = nms.nms3x3(fast_score(img, threshold))
    if suppress is not None:
        score = torch.where(suppress, 0.0, score)
    return score


# counted: its launches and the pixels it scores (S x H x W a call)
_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FAST_NMS = _build.entry("svo_fast_nms", [_p, _p, _p, _i, _i, _i, _f, _p], "fast_nms",
                         counts=("launches", "pixels"))


def fast_nms_kernel(img: torch.Tensor, threshold: float,
                    suppress: torch.Tensor | None = None) -> torch.Tensor:
    """fast_nms on CUDA tensors through csrc/fast_nms.cu: one launch for all
    streams, on the current stream, with no host read (so a CUDA graph
    captures it). Takes a contiguous float32 (..., H, W) stack, its leading
    axes the streams, and a contiguous bool mask of the same shape; anything
    else raises ValueError before anything is built or launched."""
    if img.dtype != torch.float32 or img.dim() < 2 or not img.is_contiguous():
        raise ValueError(f"img must be a contiguous float32 (..., H, W) tensor, got "
                         f"{img.dtype} {tuple(img.shape)} with strides {img.stride()}")
    H, W = img.shape[-2:]
    S = img.numel() // (H * W) if H * W else 0
    if not (1 <= S <= 65535 and H >= 1 and W >= 1 and S * H * W < 2**31):
        raise ValueError(f"img {tuple(img.shape)}: the kernel takes 1 to 65535 streams of "
                         f"fewer than 2**31 pixels in all")
    if suppress is not None and (suppress.dtype != torch.bool or suppress.shape != img.shape
                                 or not suppress.is_contiguous()
                                 or suppress.device != img.device):
        raise ValueError(f"suppress must be a contiguous bool tensor of img's shape "
                         f"{tuple(img.shape)} on {img.device}, got {suppress.dtype} "
                         f"{tuple(suppress.shape)} on {suppress.device}")
    if img.device.type != "cuda":
        raise ValueError(f"the kernel runs on a CUDA device, not {img.device}")
    out = torch.empty_like(img)
    _build.launch(_FAST_NMS, img.device, img.data_ptr(),
                  suppress.data_ptr() if suppress is not None else None,
                  out.data_ptr(), S, H, W, float(threshold))
    _build.count("fast_nms.pixels", S * H * W)
    return out


def fast_nms(img: torch.Tensor, threshold: float,
             suppress: torch.Tensor | None = None) -> torch.Tensor:
    """(..., H, W) FAST-9 score map after 3x3 NMS, zero where `suppress`
    (bool, the image's shape) is True: the candidates both detectors select
    from. img's device picks the path: the kernel on a CUDA tensor (what it
    does not take raises ValueError, never a fall back to the plain path),
    fast_nms_ref on a CPU tensor."""
    if img.device.type == "cpu":
        return fast_nms_ref(img, threshold, suppress)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    return fast_nms_kernel(img, threshold, suppress)
