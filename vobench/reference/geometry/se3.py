"""SE(3) rigid transforms as (..., 4, 4) homogeneous matrices.

Port of svo_tpu/geometry/se3.py: composition, inverse and the exp/log maps
used by the PnP refinement. All functions are batched over leading
dimensions and safe at the small-angle limit (Taylor fallbacks).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def _eye3_like(x: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(shape)


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Build (...,4,4) from rotation (...,3,3) and translation (...,3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3].fill_(1.0)  # a fill on the device: no host scalar copied in
    return torch.cat([top, bottom], dim=-2)


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B (apply B first, then A)."""
    return A @ B


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Analytic inverse: [R t]^-1 = [R^T  -R^T t]."""
    Rt = rotation(T).transpose(-1, -2)
    return from_rt(Rt, -(Rt @ translation(T)[..., None])[..., 0])


def transform(T: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Apply (...,4,4) to points (...,N,3) or (...,3)."""
    R = rotation(T)
    t = translation(T)
    if X.dim() == T.dim() - 1:  # (...,3)
        return (R @ X[..., None])[..., 0] + t
    return X @ R.transpose(-1, -2) + t[..., None, :]


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (...,3) -> (...,3,3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _rodrigues_coeffs(theta2: torch.Tensor):
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    return small, A, B


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) rotation -> (...,3) axis-angle."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    small = theta < 1e-4
    # w = theta / (2 sin(theta)) * v ; near 0: 1/2 * (1 + theta^2/6).
    # theta near pi is not handled, as in svo_tpu: the pipeline only sees
    # small inter-frame rotations.
    scale = torch.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / (2.0 * torch.where(small, torch.ones_like(theta), torch.sin(theta)) + _EPS),
    )
    return scale[..., None] * v


def exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exponential: (...,6) twist [v, w] -> (...,4,4)."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    small, A, B = _rodrigues_coeffs(theta2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / theta2)
    W = hat(w)
    I = _eye3_like(xi, W.shape)
    WW = W @ W
    R = I + A[..., None, None] * W + B[..., None, None] * WW
    V = I + B[..., None, None] * W + C[..., None, None] * WW
    return from_rt(R, (V @ v[..., None])[..., 0])


def log(T: torch.Tensor) -> torch.Tensor:
    """(...,4,4) -> (...,6) twist [v, w], inverse of exp."""
    w = so3_log(rotation(T))
    theta2 = torch.sum(w * w, dim=-1)
    small, A, B = _rodrigues_coeffs(theta2)
    # V^-1 = I - 1/2 W + (1/theta^2)(1 - A/(2B)) W^2
    coef = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - A / (2.0 * B)) / torch.where(small, torch.ones_like(theta2), theta2),
    )
    W = hat(w)
    Vinv = _eye3_like(T, W.shape) - 0.5 * W + coef[..., None, None] * (W @ W)
    v = (Vinv @ translation(T)[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)

