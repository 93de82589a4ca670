"""(vobench's frozen copy: the wrapper below runs the plain version on every
device; the CUDA kernel is not launched.)

Per-feature patch extraction for the KLT tracker.

Port of svo_tpu/ops/klt_pallas.py::extract_klt_patches. On a CUDA tensor
the wrapper launches the hand-written kernel csrc/klt_patches.cu; on a CPU
tensor it runs extract_klt_patches_ref, the plain PyTorch version of the
same copy (the CPU tests' path, and what chip_smoke.py holds the kernel
against on the card).

Contract (that of the TPU kernel): for each of N features, copy the
(py, px) windows of prev, gx and gy at (ty0, tx0) and of curr at
(cy0, cx0); each corner is clamped to [0, H-py] x [0, W-px] as
jax.lax.dynamic_slice clamps; slots with valid == False come back zeroed.

One launch covers one extraction: four images, every feature of every
stream. The copy itself is a few microseconds on the card, so a call is
bound by its launch and by this wrapper's host work. The wrapper therefore
issues no device op of its own when the caller's tensors are what the
kernel reads (int32 corners as ops/klt.py::_corners makes them, a bool
valid, all contiguous): the four corner tensors and valid's own bytes go
to the kernel as they lie, one (4, ..., N, py, px) buffer is allocated,
and the four results are views of it. Anything else (int64 or strided
corners, another mask type) is converted first. On the card px must be a
multiple of 4 (the kernel stores 16 bytes a thread; ops/klt.py's
_patch_cols gives multiples of 8).

The stream axis: images (S, H, W) with corners and valid (S, N) give
(S, N, py, px) patches, stream s cut from image s, in ONE launch (the TPU
kernel's batched rule, klt_pallas.py::_extract_batched). Images (H, W)
with (N,) corners are one stream.
"""

from __future__ import annotations

import torch

from vobench.reference.ops.index import gather_hw


def _check(imgs, corners, valid, py: int, px: int) -> None:
    first = imgs[0]
    shape = first.shape
    if len(shape) not in (2, 3):
        raise ValueError(f"images must be (H, W) or (S, H, W), got {tuple(shape)}")
    H, W = shape[-2:]
    if any(im.dtype != torch.float32 or im.shape != shape for im in imgs):
        raise ValueError(
            f"images must be four float32 tensors of one shape (H, W) or "
            f"(S, H, W), got {[(tuple(i.shape), i.dtype) for i in imgs]}"
        )
    if any(im.device != first.device for im in imgs):
        raise ValueError("images lie on different devices")
    if not all(im.is_contiguous() for im in imgs):
        raise ValueError("images must be contiguous")
    if valid.dim() != len(shape) - 1 or valid.shape[:-1] != shape[:-2]:
        raise ValueError(
            f"valid {tuple(valid.shape)} does not match images {tuple(shape)}: (N,) "
            f"for (H, W) images, (S, N) for (S, H, W)"
        )
    if any(c.shape != valid.shape for c in corners):
        raise ValueError(
            f"corners {[tuple(c.shape) for c in corners]} / valid {tuple(valid.shape)}"
        )
    if not (0 < py <= H and 0 < px <= W):
        raise ValueError(f"patch {py}x{px} does not fit the {H}x{W} image")


def extract_klt_patches_ref(
    prev, gx, gy, curr, ty0, tx0, cy0, cx0, valid, py: int, px: int
):
    """Plain PyTorch version: a gather of the same clamped windows, with
    the same optional stream axis."""
    H, W = prev.shape[-2:]
    dev = prev.device
    rows = torch.arange(py, device=dev)[:, None]
    cols = torch.arange(px, device=dev)[None, :]
    live = valid.to(torch.bool)[..., None, None]

    def windows(img, y0, x0):
        y0 = torch.clamp(y0.long(), 0, H - py)[..., None, None]
        x0 = torch.clamp(x0.long(), 0, W - px)[..., None, None]
        win = gather_hw(img, y0 + rows, x0 + cols)
        return torch.where(live, win, 0.0)

    return (
        windows(prev, ty0, tx0),
        windows(gx, ty0, tx0),
        windows(gy, ty0, tx0),
        windows(curr, cy0, cx0),
    )


def extract_klt_patches(
    prev: torch.Tensor,
    gx: torch.Tensor,
    gy: torch.Tensor,
    curr: torch.Tensor,
    ty0: torch.Tensor,
    tx0: torch.Tensor,
    cy0: torch.Tensor,
    cx0: torch.Tensor,
    valid: torch.Tensor,
    py: int,
    px: int,
):
    """Extract (N, py, px) patches: prev/gx/gy at (ty0, tx0), curr at
    (cy0, cx0). Corners are (N,) integer tensors, valid (N,) bool; with
    (S, H, W) images they are (S, N) and the patches (S, N, py, px), from
    one launch whatever S is. On the card the four results are views of
    one buffer."""
    imgs = (prev, gx, gy, curr)
    corners = (ty0, tx0, cy0, cx0)
    _check(imgs, corners, valid, py, px)
    return extract_klt_patches_ref(*imgs, *corners, valid, py, px)

