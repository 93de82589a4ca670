"""Seeded synthetic back-end inputs with ground truth, made with numpy.

Small problems of known answer for checks that run without svo_tpu: the
card held against the CPU (chip_smoke.py), repeatability, timing. Three
generators, each a function of a seed:

- ba_problem: K cameras along +z looking at scattered points, noisy stereo
  and mono observations, cameras and points perturbed (a BAProblem);
- drifted_state: a pipeline-shaped (MapState, poses) whose trajectory was
  integrated from relative motions with a constant bias, as VO drifts,
  with its observations in the COO ring (the input of refine_global);
- drifted_graph: a chain whose estimates drift while its edges measure the
  true relative motions, closed by one strong edge (a PoseGraph).

Everything comes back as CPU tensors; move it with `.to(device)` per leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from svo_tpu_torch.ba.pose_graph import PoseGraph
from svo_tpu_torch.ba.solver import BAProblem
from svo_tpu_torch.pipeline.state import MapState, tensor

FX, CX, CY, BASELINE = 300.0, 160.0, 120.0, 0.5
K_MAT = np.array([[FX, 0, CX], [0, FX, CY], [0, 0, 1]], np.float32)


def _rot_y(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def _rotvec(w: np.ndarray) -> np.ndarray:
    """Rodrigues: a small rotation vector as a matrix."""
    th = float(np.linalg.norm(w))
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], np.float64)
    if th < 1e-12:
        return np.eye(3) + W
    return np.eye(3) + np.sin(th) / th * W + (1 - np.cos(th)) / th**2 * (W @ W)


def _project(T_cw: np.ndarray, pts: np.ndarray):
    """u, v, u_right, z of world points in one camera."""
    Xc = pts @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = Xc[:, 2]
    zs = np.maximum(z, 1e-6)
    u = FX * Xc[:, 0] / zs + CX
    v = FX * Xc[:, 1] / zs + CY
    return u, v, u - FX * BASELINE / zs, z


def ba_problem(seed: int, n_cams: int = 5, n_pts: int = 120, n_obs: int = 1024,
               noise_px: float = 0.5) -> BAProblem:
    rng = np.random.default_rng(seed)
    T_wc = np.tile(np.eye(4), (n_cams, 1, 1))
    for i in range(n_cams):
        T_wc[i, :3, :3] = _rot_y(0.02 * i)
        T_wc[i, :3, 3] = [0.1 * i, 0.02 * i, 0.6 * i]
    T_cw = np.linalg.inv(T_wc)
    pts = np.stack([rng.uniform(-5, 5, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(8, 30, n_pts)], axis=-1)
    cam, pnt, uv = [], [], []
    for c in range(n_cams):
        u, v, ur, z = _project(T_cw[c], pts)
        vis = (z > 1) & (u > 0) & (u < 2 * CX) & (v > 0) & (v < 2 * CY)
        for p in np.nonzero(vis)[0]:
            stereo = rng.uniform() < 0.5
            n = rng.normal(0, noise_px, 3)
            cam.append(c)
            pnt.append(p)
            uv.append([u[p] + n[0], v[p] + n[1], ur[p] + n[2] if stereo else -1.0])
    n = len(cam)
    if n > n_obs:
        raise ValueError(f"{n} observations do not fit n_obs={n_obs}")
    T_init = T_cw.copy()
    for i in range(1, n_cams):
        T_init[i, :3, :3] = _rotvec(rng.normal(0, 0.01, 3)) @ T_init[i, :3, :3]
        T_init[i, :3, 3] += rng.normal(0, 0.05, 3)

    def padded(x, dtype, fill=0):
        out = np.full((n_obs,) + np.shape(x)[1:], fill, dtype)
        out[:n] = x
        return tensor(out)

    return BAProblem(
        T_cw=tensor(T_init.astype(np.float32)),
        cam_valid=torch.ones(n_cams, dtype=torch.bool),
        points=tensor((pts + rng.normal(0, 0.1, pts.shape)).astype(np.float32)),
        pnt_valid=torch.ones(n_pts, dtype=torch.bool),
        obs_cam=padded(cam, np.int32),
        obs_pnt=padded(pnt, np.int32),
        obs_uv=padded(np.asarray(uv, np.float32), np.float32),
        obs_valid=tensor(np.arange(n_obs) < n),
    )


def drifted_state(seed: int, n_frames: int = 22, n_pts: int = 320, obs_per_frame: int = 48,
                  drift_rot: float = 0.002, drift_trans: float = 0.01,
                  obs_noise: float = 0.2, pnt_noise: float = 0.05,
                  max_points: int = 1 << 12, ring_obs: int = 1 << 14, max_frames: int = 64):
    """(MapState, poses (max_frames,4,4), gt (n_frames,4,4)): a gentle
    forward arc with landmarks ahead of the path, ground-truth projections
    (+ noise) in the ring, all stereo, and an estimate integrated from the
    true relative motions times a constant bias; map points near truth.
    drift_rot = drift_trans = 0 gives a healthy span."""
    rng = np.random.default_rng(seed)
    rel = np.eye(4)
    rel[:3, :3] = _rot_y(0.004)
    rel[:3, 3] = [0.02, 0.0, 0.35]
    bias = np.eye(4)
    bias[:3, :3] = _rot_y(drift_rot)
    bias[:3, 3] = [drift_trans, 0, 0]
    gt, est = [np.eye(4)], [np.eye(4)]
    for _ in range(1, n_frames):
        gt.append(gt[-1] @ rel)
        est.append(est[-1] @ rel @ bias)
    gt, est = np.stack(gt), np.stack(est)
    base = gt[rng.integers(0, n_frames, n_pts), :3, 3]
    pts = base + np.stack([rng.uniform(-6, 6, n_pts), rng.uniform(-2, 2, n_pts),
                           rng.uniform(4, 18, n_pts)], axis=-1)
    u_, v_, ur_ = (np.zeros(ring_obs, np.float32) for _ in range(3))
    ur_ -= 1.0
    pid = np.full(ring_obs, -1, np.int32)
    fid = np.full(ring_obs, -1, np.int32)
    n = 0
    for f in range(n_frames):
        u, v, ur, z = _project(np.linalg.inv(gt[f]), pts)
        ids = np.nonzero((z > 1.0) & (u >= 0) & (u < 2 * CX) & (v >= 0) & (v < 2 * CY))[0]
        rng.shuffle(ids)
        ids = ids[:obs_per_frame]
        k = len(ids)
        du, dv = rng.normal(0, obs_noise, (2, k)) if obs_noise else np.zeros((2, k))
        u_[n:n + k], v_[n:n + k], ur_[n:n + k] = u[ids] + du, v[ids] + dv, ur[ids] + du
        pid[n:n + k], fid[n:n + k] = ids, f
        n += k
    points = np.zeros((max_points, 3), np.float32)
    points[:n_pts] = pts + (rng.normal(0, pnt_noise, pts.shape) if pnt_noise else 0.0)
    mp = MapState(
        points=tensor(points), n_points=torch.tensor(n_pts, dtype=torch.int32),
        obs_u=tensor(u_), obs_v=tensor(v_), obs_ur=tensor(ur_),
        obs_pid=tensor(pid), obs_fid=tensor(fid),
        obs_cursor=torch.tensor(n, dtype=torch.int32),
    )
    poses = np.tile(np.eye(4, dtype=np.float32), (max_frames, 1, 1))
    poses[:n_frames] = est.astype(np.float32)
    return mp, tensor(poses), gt.astype(np.float32)


def drifted_graph(seed: int, n: int = 10) -> PoseGraph:
    rng = np.random.default_rng(seed)
    T_true = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        T_true[i, :3, :3] = _rot_y(0.01 * i)
        T_true[i, :3, 3] = [0, 0, 0.5 * i]
    T_est = T_true.copy()
    for i in range(1, n):
        T_est[i, :3, 3] += np.array([0.05, 0.02, 0.0]) * i + rng.normal(0, 0.005, 3)
        T_est[i, :3, :3] = _rotvec(np.array([0, 0, 0.004 * i])) @ T_est[i, :3, :3]
    ei = np.arange(n - 1, dtype=np.int32)
    rel = np.linalg.inv(T_true[:-1]) @ T_true[1:]
    closure = (np.linalg.inv(T_true[0]) @ T_true[n - 1])[None]
    return PoseGraph(
        T_wc=tensor(T_est.astype(np.float32)),
        node_valid=torch.ones(n, dtype=torch.bool),
        edge_i=tensor(np.concatenate([ei, [0]]).astype(np.int32)),
        edge_j=tensor(np.concatenate([ei + 1, [n - 1]]).astype(np.int32)),
        edge_T=tensor(np.concatenate([rel, closure]).astype(np.float32)),
        edge_w=tensor(np.concatenate([np.ones(n - 1), [5.0]]).astype(np.float32)),
    )
