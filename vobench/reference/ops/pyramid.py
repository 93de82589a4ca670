"""Image pyramids, gradients and box sums.

Port of svo_tpu/ops/pyramid.py: the KLT pyramid (pyr_down, klt_pyramid,
scharr_gradients) and what the ORB detector needs (resize_linear,
scale_pyramid, sobel_gradients, box_filter).
svo_tpu folds blur and decimation into one banded matrix product for the
TPU's matrix unit; the port keeps its numerics, not its form: a 5-tap
[1,4,6,4,1]/16 filter with a replicate border, sampled at every second
pixel, per axis. Both are out[i] = sum_k taps[k] * x[clip(2i + k - 2)].

Every function takes (..., H, W): leading axes (the streams of the batched
engine) pass through.
"""

from __future__ import annotations

import functools

import numpy as np
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


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """(n_in, n_out) linear-interpolation matrix (align_corners=False, the
    cv2 'linear' convention), built on the host in f32 as svo_tpu builds
    it, and kept on `device` (the level widths of a run are few; a 1241 x
    1034 matrix is 5 MB that would otherwise cross to the card every
    keyframe)."""
    scale = n_in / n_out
    src = (np.arange(n_out) + 0.5) * scale - 0.5
    src = np.clip(src, 0, n_in - 1)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    f = (src - i0).astype(np.float32)
    M = np.zeros((n_in, n_out), np.float32)
    M[i0, np.arange(n_out)] += 1.0 - f
    M[i1, np.arange(n_out)] += f
    return torch.from_numpy(M).to(device)


def resize_linear(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """Bilinear resize of (..., h, w) to (..., nh, nw) as svo_tpu's two
    matrix products, (Mh^T @ img) @ Mw, in full f32 (the package turns
    TF32 off at import)."""
    h, w = img.shape[-2:]
    Mh = _resize_matrix(h, nh, img.device)  # (h, nh)
    Mw = _resize_matrix(w, nw, img.device)  # (w, nw)
    return (Mh.T @ img) @ Mw


def scale_pyramid(img: torch.Tensor, n_levels: int, scale_factor: float) -> list[torch.Tensor]:
    """Geometric pyramid for multi-scale detection (ORB's scale_factor
    chain): level l is the image resized by 1/scale_factor**l, each side
    at least 16 pixels."""
    h, w = img.shape[-2:]
    levels = [img]
    for lvl in range(1, n_levels):
        s = scale_factor ** lvl
        nh, nw = max(int(round(h / s)), 16), max(int(round(w / s)), 16)
        levels.append(resize_linear(img, nh, nw))
    return levels


def sobel_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel dx, dy (cv2 kernel, no scaling), replicate border."""
    smooth = (1.0, 2.0, 1.0)
    diff = (-1.0, 0.0, 1.0)
    ix = _tap_filter(_tap_filter(img, smooth, 0), diff, 1)
    iy = _tap_filter(_tap_filter(img, diff, 0), smooth, 1)
    return ix, iy


def box_filter(img: torch.Tensor, size: int) -> torch.Tensor:
    """Sliding-window sum (not mean) of (..., H, W) with zero padding,
    separable, through a prefix sum per axis as svo_tpu computes it (rows
    first), so that the rounding stays close to svo_tpu's."""
    pad = size // 2
    for dim in (-2, -1):
        n = img.shape[dim]
        c = torch.cumsum(img, dim=dim)
        c = torch.cat([torch.zeros_like(c.narrow(dim, 0, 1)), c], dim=dim)
        idx = torch.arange(n, device=img.device)
        hi = torch.clamp(idx + (size - pad), 0, n)
        lo = torch.clamp(idx - pad, 0, n)
        img = c.index_select(dim, hi) - c.index_select(dim, lo)
    return img
