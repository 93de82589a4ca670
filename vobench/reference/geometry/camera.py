"""Pinhole camera model of a rectified stereo rig.

Port of svo_tpu/geometry/camera.py: Camera, from_projections,
from_intrinsics, parse_kitti_calib (KITTI calib.txt, P2/P3), project,
project_P, backproject.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


def from_projections(P_left, P_right, device=None) -> Camera:
    """Build a Camera from two 3x4 projections (KITTI P2, P3)."""
    P_left = torch.as_tensor(np.asarray(P_left, np.float32).reshape(3, 4), device=device)
    P_right = torch.as_tensor(np.asarray(P_right, np.float32).reshape(3, 4), device=device)
    return Camera(K=P_left[:, :3].clone(), P_left=P_left, P_right=P_right)


def from_intrinsics(fx, fy, cx, cy, baseline, device=None) -> Camera:
    """Build a rectified rig from intrinsics + baseline (meters)."""
    f32 = dict(dtype=torch.float32, device=device)
    K = torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], **f32)
    P_left = torch.cat([K, torch.zeros((3, 1), **f32)], dim=1)
    t = torch.tensor([[-fx * baseline], [0.0], [0.0]], **f32)
    P_right = torch.cat([K, t], dim=1)
    return Camera(K=K, P_left=P_left, P_right=P_right)


def parse_kitti_calib(path: str, device=None) -> Camera:
    """Parse a KITTI calib.txt, reading P2 and P3 (the color stereo pair)."""
    mats = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            key = parts[0].rstrip(":")
            vals = np.array([float(x) for x in parts[1:]], dtype=np.float32)
            if vals.size == 12:
                mats[key] = vals.reshape(3, 4)
    if "P2" not in mats or "P3" not in mats:
        raise ValueError(f"calib file {path} missing P2/P3")
    return from_projections(mats["P2"], mats["P3"], device=device)


def project(K: torch.Tensor, X_cam: torch.Tensor) -> torch.Tensor:
    """Project camera-frame points (...,3) to pixels (...,2)."""
    z = X_cam[..., 2:3]
    xy = X_cam[..., :2] / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    return torch.stack([fx * xy[..., 0] + cx, fy * xy[..., 1] + cy], dim=-1)


def project_P(P: torch.Tensor, X_world: torch.Tensor) -> torch.Tensor:
    """Project world points (...,3) through a 3x4 projection to pixels."""
    Xh = torch.cat([X_world, torch.ones_like(X_world[..., :1])], dim=-1)
    uvw = Xh @ P.T
    w = uvw[..., 2:3]
    return uvw[..., :2] / torch.where(torch.abs(w) < 1e-9, torch.full_like(w, 1e-9), w)


def backproject(K: torch.Tensor, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Unproject pixels (...,2) at given depth (...) to camera-frame points."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x * depth, y * depth, depth], dim=-1)
