"""Pinhole camera model of a rectified stereo rig.

Port of svo_tpu/geometry/camera.py (Camera, from_intrinsics, project).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Camera(NamedTuple):
    """Rectified stereo camera rig.

    K: (3,3) intrinsics of the left camera.
    P_left / P_right: (3,4) projection matrices mapping world
    (= left-camera-at-origin) homogeneous points to pixels.
    """

    K: torch.Tensor
    P_left: torch.Tensor
    P_right: torch.Tensor

    @property
    def fx(self):
        return self.K[0, 0]

    @property
    def fy(self):
        return self.K[1, 1]

    @property
    def cx(self):
        return self.K[0, 2]

    @property
    def cy(self):
        return self.K[1, 2]

    @property
    def baseline(self):
        """Stereo baseline in meters: b = -P_right[0,3] / fx."""
        return -self.P_right[0, 3] / self.K[0, 0]

    def to(self, device) -> "Camera":
        return Camera(*(t.to(device) for t in self))


def from_intrinsics(fx, fy, cx, cy, baseline, device=None) -> Camera:
    """Build a rectified rig from intrinsics + baseline (meters)."""
    f32 = dict(dtype=torch.float32, device=device)
    K = torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], **f32)
    P_left = torch.cat([K, torch.zeros((3, 1), **f32)], dim=1)
    t = torch.tensor([[-fx * baseline], [0.0], [0.0]], **f32)
    P_right = torch.cat([K, t], dim=1)
    return Camera(K=K, P_left=P_left, P_right=P_right)


def project(K: torch.Tensor, X_cam: torch.Tensor) -> torch.Tensor:
    """Project camera-frame points (...,3) to pixels (...,2)."""
    z = X_cam[..., 2:3]
    xy = X_cam[..., :2] / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    return torch.stack([fx * xy[..., 0] + cx, fy * xy[..., 1] + cy], dim=-1)
