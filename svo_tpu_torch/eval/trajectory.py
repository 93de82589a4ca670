"""Trajectory evaluation: ATE and RPE against ground truth.

A copy of svo_tpu/eval/trajectory.py (numpy only), so the port runs where jax is not
installed; tests/test_torch_geometry.py holds the two equal.

The reference never computes these numerically — it only draws the GT
trajectory for eyeball comparison (reference: src/map.cpp:15-43 GT parse,
src/drawer.cpp:114-115 overlay). BASELINE.md makes ATE/RPE the primary
accuracy metric, so this module is the quantitative replacement: standard
KITTI-style ATE (RMSE of translation after SE(3)/Sim(3) Umeyama alignment)
and RPE over fixed frame deltas.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(
    est: np.ndarray, gt: np.ndarray, with_scale: bool = False
) -> tuple[np.ndarray, np.ndarray, float]:
    """Least-squares rigid (or similarity) alignment est -> gt.

    Args:
        est, gt: (N, 3) corresponding points.
    Returns:
        (R (3,3), t (3,), s): gt ~ s * R @ est + t.
    """
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    e = est - mu_e
    g = gt - mu_g
    C = g.T @ e / len(est)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (e * e).sum() / len(est)
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(
    est_poses: np.ndarray, gt_poses: np.ndarray, align: bool = True
) -> float:
    """Absolute trajectory error (RMSE, meters) over translations."""
    n = min(len(est_poses), len(gt_poses))
    p_est = est_poses[:n, :3, 3]
    p_gt = gt_poses[:n, :3, 3]
    if align:
        R, t, s = umeyama_alignment(p_est, p_gt)
        p_est = (s * (R @ p_est.T)).T + t
    err = np.linalg.norm(p_est - p_gt, axis=-1)
    return float(np.sqrt(np.mean(err**2)))


def rpe(
    est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1
) -> tuple[float, float]:
    """Relative pose error over frame pairs (i, i+delta).

    Returns:
        (trans_rmse [m], rot_rmse [rad]) of the relative-motion residuals.
    """
    n = min(len(est_poses), len(gt_poses))
    terrs, rerrs = [], []
    for i in range(n - delta):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        err = np.linalg.inv(dg) @ de
        terrs.append(np.linalg.norm(err[:3, 3]))
        cos = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)
        rerrs.append(np.arccos(cos))
    return float(np.sqrt(np.mean(np.square(terrs)))), float(
        np.sqrt(np.mean(np.square(rerrs)))
    )
