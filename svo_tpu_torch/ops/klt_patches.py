"""Per-feature patch extraction for the KLT tracker.

Port of svo_tpu/ops/klt_pallas.py::extract_klt_patches. On a CUDA tensor
the wrapper launches the hand-written kernel csrc/klt_patches.cu; on a CPU
tensor it runs extract_klt_patches_ref, the plain PyTorch version of the
same copy (the CPU tests' path, and what chip_smoke.py holds the kernel
against on the card).

Contract (that of the TPU kernel): for each of N features, copy the
(py, px) windows of prev, gx and gy at (ty0, tx0) and of curr at
(cy0, cx0); each corner is clamped to [0, H-py] x [0, W-px] as
jax.lax.dynamic_slice clamps; slots with valid == False come back zeroed.
"""

from __future__ import annotations

import torch

from svo_tpu_torch import _build


def _check(imgs, corners, valid, py: int, px: int) -> None:
    H, W = imgs[0].shape
    for im in imgs:
        if im.dtype != torch.float32 or im.dim() != 2 or tuple(im.shape) != (H, W):
            raise ValueError(
                f"images must be four (H, W) float32 tensors of one shape, got "
                f"{[(tuple(i.shape), i.dtype) for i in imgs]}"
            )
        if im.device != imgs[0].device:
            raise ValueError("images lie on different devices")
        if not im.is_contiguous():
            raise ValueError("images must be contiguous")
    N = valid.shape[0]
    if tuple(corners.shape) != (N, 4) or valid.dim() != 1:
        raise ValueError(f"corners {tuple(corners.shape)} / valid {tuple(valid.shape)}")
    if not (0 < py <= H and 0 < px <= W):
        raise ValueError(f"patch {py}x{px} does not fit the {H}x{W} image")


def extract_klt_patches_ref(
    prev, gx, gy, curr, ty0, tx0, cy0, cx0, valid, py: int, px: int
):
    """Plain PyTorch version: a gather of the same clamped windows."""
    H, W = prev.shape
    dev = prev.device
    rows = torch.arange(py, device=dev)
    cols = torch.arange(px, device=dev)
    live = valid.to(torch.bool)[:, None, None]

    def windows(img, y0, x0):
        y0 = torch.clamp(y0.long(), 0, H - py)
        x0 = torch.clamp(x0.long(), 0, W - px)
        win = img[(y0[:, None] + rows)[:, :, None], (x0[:, None] + cols)[:, None, :]]
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
    (cy0, cx0). Corners are (N,) integer tensors, valid (N,) bool."""
    imgs = (prev, gx, gy, curr)
    corners = torch.stack([ty0, tx0, cy0, cx0], dim=-1).to(torch.int32).contiguous()
    _check(imgs, corners, valid, py, px)
    if prev.device.type == "cpu":
        return extract_klt_patches_ref(*imgs, ty0, tx0, cy0, cx0, valid, py, px)
    if prev.device.type != "cuda":
        raise ValueError(f"unsupported device {prev.device}")
    if corners.device != prev.device or valid.device != prev.device:
        raise ValueError("corners and valid must lie on the images' device")
    lib = _build.load()
    H, W = prev.shape
    N = valid.shape[0]
    v = valid.to(torch.uint8).contiguous()
    outs = [torch.empty((N, py, px), dtype=torch.float32, device=prev.device) for _ in range(4)]
    code = lib.svo_klt_patches(
        *(im.data_ptr() for im in imgs), H, W, corners.data_ptr(), v.data_ptr(),
        N, py, px, *(o.data_ptr() for o in outs),
        torch.cuda.current_stream(prev.device).cuda_stream,
    )
    _build.check(lib, code, "klt_patches")
    extract_klt_patches.launches += 1
    return tuple(outs)


extract_klt_patches.launches = 0  # kernel launches since the last reset
