"""Image pyramid and gradients for the KLT tracker.

Port of svo_tpu/ops/pyramid.py (pyr_down, klt_pyramid, scharr_gradients).
svo_tpu folds blur and decimation into one banded matrix product for the
TPU's matrix unit; the port keeps its numerics, not its form: a 5-tap
[1,4,6,4,1]/16 filter with a replicate border, sampled at every second
pixel, per axis. Both are out[i] = sum_k taps[k] * x[clip(2i + k - 2)].

Every function takes (..., H, W): leading axes (the streams of the batched
engine) pass through.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_PYR_TAPS = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def pad_replicate(img: torch.Tensor, pad_y: int, pad_x: int) -> torch.Tensor:
    """Replicate-pad (..., H, W) by pad_y rows and pad_x columns on both
    sides."""
    H, W = img.shape[-2:]
    out = F.pad(img.reshape(-1, 1, H, W), (pad_x, pad_x, pad_y, pad_y), mode="replicate")
    return out.reshape(img.shape[:-2] + out.shape[-2:])


def _pad_replicate(img: torch.Tensor, pad: int, axis: int) -> torch.Tensor:
    """Replicate-pad by `pad` on both sides of one image axis (0 rows, 1
    columns)."""
    return pad_replicate(img, pad, 0) if axis == 0 else pad_replicate(img, 0, pad)


def _slice(x: torch.Tensor, start: int, stop: int, step: int, axis: int):
    return x[..., start:stop:step, :] if axis == 0 else x[..., start:stop:step]


def _tap_filter(img: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """1-D FIR along an axis, replicate border; result[i] = sum_k taps[k] *
    img[i + k - r], terms added in tap order as svo_tpu does."""
    r = len(taps) // 2
    n = img.shape[axis - 2]
    xp = _pad_replicate(img, r, axis)
    out = None
    for k, t in enumerate(taps):
        if t == 0.0:
            continue
        term = _slice(xp, k, k + n, 1, axis) * t
        out = term if out is None else out + term
    return out


def _decimate(img: torch.Tensor, axis: int) -> torch.Tensor:
    """Blur with the 5-tap filter and keep every second sample along one
    axis: out[i] = sum_k taps[k] * x[clip(2i + k - 2, 0, n-1)]."""
    n = img.shape[axis - 2]
    n_out = -(-n // 2)
    xp = _pad_replicate(img, 2, axis)
    out = None
    for k, t in enumerate(_PYR_TAPS):
        term = _slice(xp, k, k + 2 * n_out - 1, 2, axis) * t
        out = term if out is None else out + term
    return out


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """cv2-style pyrDown: 5x5 Gaussian blur then every 2nd pixel, replicate
    border. (H, W) -> (ceil(H/2), ceil(W/2)); rows first, as svo_tpu's
    (Dh @ img) @ Dw^T."""
    return _decimate(_decimate(img, 0), 1)


def klt_pyramid(img: torch.Tensor, max_level: int) -> list[torch.Tensor]:
    """Levels 0..max_level (cv2 maxLevel semantics: max_level+1 images)."""
    levels = [img]
    for _ in range(max_level):
        levels.append(pyr_down(levels[-1]))
    return levels


def scharr_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """3x3 Scharr dx, dy with cv2's 1/32 normalisation, replicate border."""
    smooth = (3.0 / 32, 10.0 / 32, 3.0 / 32)
    diff = (-1.0, 0.0, 1.0)
    ix = _tap_filter(_tap_filter(img, smooth, 0), diff, 1)
    iy = _tap_filter(_tap_filter(img, diff, 0), smooth, 1)
    return ix, iy
