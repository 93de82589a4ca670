"""Batched triangulation with cheirality masking.

Port of svo_tpu/geometry/triangulate.py. Invalid points are masked by the
caller, never compacted, so every shape stays fixed.
"""

from __future__ import annotations

import torch


def triangulate_dlt(
    P_left: torch.Tensor,
    P_right: torch.Tensor,
    uv_left: torch.Tensor,
    uv_right: torch.Tensor,
) -> torch.Tensor:
    """Linear (DLT) triangulation: (...,2) pixel pairs -> (...,3) points in
    the projection frame (left camera = world)."""
    rows = []
    for P, uv in ((P_left, uv_left), (P_right, uv_right)):
        rows.append(uv[..., 0:1] * P[2] - P[0])
        rows.append(uv[..., 1:2] * P[2] - P[1])
    A = torch.stack(rows, dim=-2)
    # row-normalise for conditioning (scale-invariant in exact arithmetic)
    A = A / (torch.linalg.norm(A, dim=-1, keepdim=True) + 1e-12)
    # smallest eigenvector of the symmetric 4x4 A^T A = null direction
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)  # ascending eigenvalues
    Xh = V[..., :, 0]
    w = Xh[..., 3:4]
    return Xh[..., :3] / torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)


def triangulate_rectified(
    fx: torch.Tensor,
    baseline: torch.Tensor,
    uv_left: torch.Tensor,
    uv_right: torch.Tensor,
    K: torch.Tensor,
) -> torch.Tensor:
    """Closed-form triangulation for a rectified rig (disparity route)."""
    disparity = uv_left[..., 0] - uv_right[..., 0]
    z = fx * baseline / torch.where(
        torch.abs(disparity) < 1e-6, torch.full_like(disparity, 1e-6), disparity
    )
    cx, cy = K[0, 2], K[1, 2]
    fy = K[1, 1]
    x = (uv_left[..., 0] - cx) / fx * z
    y = (uv_left[..., 1] - cy) / fy * z
    return torch.stack([x, y, z], dim=-1)
