"""Synthetic stereo frames rendered on the device from the seed.

A frozen PyTorch copy of svo_tpu_torch/io/synthetic.py's ray-caster (the
"corridor" world: ground at y=1.7, walls at x=+-10, each with a blocky
value-noise texture; the "wobble" trajectory), so the benchmark makes its
frames on the card in a few batched calls instead of 0.5 s a stereo pair
in numpy on the host. The textures are drawn with numpy from the seed,
exactly as the original draws them; rays are cast in float64 and the
texture is blended in float32, as there. vobench/tests holds the two
within a stated tolerance.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def _value_noise_texture(rng, n=512, cell=8, blur=1, lo=40.0, hi=215.0, fine_amp=15.0):
    coarse = rng.uniform(lo, hi, (n // cell, n // cell)).astype(np.float32)
    tex = np.kron(coarse, np.ones((cell, cell), np.float32))
    tex = tex + rng.uniform(-fine_amp, fine_amp, (n, n)).astype(np.float32)
    for _ in range(blur):
        tex = 0.25 * (np.roll(tex, 1, 0) + np.roll(tex, -1, 0)
                      + np.roll(tex, 1, 1) + np.roll(tex, -1, 1))
    return np.clip(tex, 0, 255)


class Plane(NamedTuple):
    p: np.ndarray      # a point of the plane
    n: np.ndarray      # unit normal
    u: np.ndarray      # unit texture axes
    v: np.ndarray
    tex: np.ndarray    # (512, 512) float32
    scale: float       # metres a texel


def _plane(point, normal, u_axis, tex, scale=0.15) -> Plane:
    n = np.asarray(normal, np.float64)
    n = n / np.linalg.norm(n)
    u = np.asarray(u_axis, np.float64)
    u = u / np.linalg.norm(u)
    return Plane(np.asarray(point, np.float64), n, u, np.cross(n, u), tex, scale)


def corridor(rng) -> list[Plane]:
    """Ground at y=1.7 (camera height), walls at x=+-10."""
    return [
        _plane([0, 1.7, 0], [0, -1, 0], [1, 0, 0], _value_noise_texture(rng)),
        _plane([-10, 0, 0], [1, 0, 0], [0, 0, 1], _value_noise_texture(rng)),
        _plane([10, 0, 0], [-1, 0, 0], [0, 0, 1], _value_noise_texture(rng)),
    ]


WORLDS = {"corridor": corridor}


def wobble(n_frames: int, speed: float = 0.35, yaw_amp: float = 0.06) -> np.ndarray:
    """(F, 4, 4) camera-to-world poses: forward motion with a zero-mean yaw
    wobble, yaw = yaw_amp * sin(0.05 i)."""
    poses = np.zeros((n_frames, 4, 4))
    pos = np.zeros(3)
    for i in range(n_frames):
        yaw = yaw_amp * np.sin(i * 0.05)
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        poses[i] = np.eye(4)
        poses[i, :3, :3] = R
        poses[i, :3, 3] = pos
        pos = pos + speed * (R @ np.array([0.0, 0.0, 1.0]))
    return poses


TRAJECTORIES = {"wobble": wobble}


def render(planes: list[Plane], T_wc: torch.Tensor, K: np.ndarray, shape: tuple[int, int],
           t_cam=None) -> torch.Tensor:
    """Ray-cast a batch of camera images: T_wc (B, 4, 4) float64 on the
    device -> (B, H, W) float32. t_cam: a camera-frame offset of the ray
    origin (the right camera of a rectified rig sits at [b, 0, 0])."""
    dev = T_wc.device
    H, W = shape
    fx, fy, cx, cy = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]))
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=dev),
                            torch.arange(W, dtype=torch.float64, device=dev), indexing="ij")
    dirs_cam = torch.stack([(xs - cx) / fx, (ys - cy) / fy, torch.ones_like(xs)], dim=-1)
    R = T_wc[:, :3, :3]
    origin = T_wc[:, :3, 3]
    if t_cam is not None:
        origin = origin + R @ torch.as_tensor(t_cam, dtype=torch.float64, device=dev)
    dirs = torch.einsum("hwk,bjk->bhwj", dirs_cam, R)  # dirs_cam @ R.T for each frame
    B = T_wc.shape[0]
    best_t = torch.full((B, H, W), math.inf, dtype=torch.float64, device=dev)
    img = torch.full((B, H, W), 90.0, dtype=torch.float32, device=dev)  # sky
    for pl in planes:
        n = torch.as_tensor(pl.n, device=dev)
        p = torch.as_tensor(pl.p, device=dev)
        denom = dirs @ n
        num = (p - origin) @ n
        t = num[:, None, None] / denom
        hit = (t > 0.1) & (t < best_t) & (denom.abs() > 1e-9)
        t = torch.where(hit, t, torch.ones_like(t))
        rel = origin[:, None, None, :] + dirs * t[..., None] - p
        tu = (rel @ torch.as_tensor(pl.u, device=dev)) / pl.scale
        tv = (rel @ torch.as_tensor(pl.v, device=dev)) / pl.scale
        tex = torch.as_tensor(pl.tex, device=dev)
        th, tw = tex.shape
        iu = torch.floor(tu).to(torch.int64) % tw
        iv = torch.floor(tv).to(torch.int64) % th
        fu = (tu - torch.floor(tu)).to(torch.float32)
        fv = (tv - torch.floor(tv)).to(torch.float32)
        iu1 = (iu + 1) % tw
        iv1 = (iv + 1) % th
        val = (tex[iv, iu] * (1 - fu) * (1 - fv) + tex[iv, iu1] * fu * (1 - fv)
               + tex[iv1, iu] * (1 - fu) * fv + tex[iv1, iu1] * fu * fv)
        img = torch.where(hit, val, img)
        best_t = torch.where(hit, t, best_t)
    return img


class Sequence(NamedTuple):
    left: torch.Tensor      # (F, H, W) uint8 on the device
    right: torch.Tensor
    gt: np.ndarray          # (F, 4, 4) camera-to-world ground truth
    K: np.ndarray           # (3, 3)
    baseline: float


def make_sequence(seed: int, n_frames: int, shape: tuple[int, int], K: np.ndarray,
                  baseline: float, device, world: str = "corridor", trajectory: str = "wobble",
                  batch: int = 16) -> Sequence:
    """The whole sequence rendered on `device`, `batch` frames a call, and
    cast to uint8 as a camera hands it (clipped to [0, 255], truncated)."""
    planes = WORLDS[world](np.random.default_rng(seed))
    gt = TRAJECTORIES[trajectory](n_frames)
    T = torch.as_tensor(gt, dtype=torch.float64, device=device)

    def u8(x):
        return x.clamp(0, 255).to(torch.uint8)

    lefts, rights = [], []
    for b0 in range(0, n_frames, batch):
        Tb = T[b0:b0 + batch]
        lefts.append(u8(render(planes, Tb, K, shape)))
        rights.append(u8(render(planes, Tb, K, shape, t_cam=[baseline, 0.0, 0.0])))
    return Sequence(torch.cat(lefts), torch.cat(rights), gt, np.asarray(K, np.float64), baseline)
