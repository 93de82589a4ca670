"""EuRoC MAV dataset support: ASL-format reading + stereo rectification.

A copy of svo_tpu/io/euroc.py (numpy and scipy; tests/test_torch_io.py
holds the two equal), with PyYAML imported inside load_sensor_yaml so that
the module imports where PyYAML is not installed. Unlike KITTI,
EuRoC cameras are unrectified pinhole + radial-tangential; the pipeline's
stereo front-end assumes a rectified rig (epipolar rows, disparity
triangulation). This module implements Bouguet-style stereo rectification
from scratch (no OpenCV): it computes rectifying rotations that align both
optical frames with the baseline, builds inverse sampling maps through the
radtan model, and remaps frames host-side with bilinear interpolation.

ASL layout:
    mav0/cam0/data/<ts>.png,  mav0/cam0/sensor.yaml (T_BS, intrinsics, D)
    mav0/cam1/...
    mav0/state_groundtruth_estimate0/data.csv (ts, p_RS_R, q_RS)
"""

from __future__ import annotations

import csv
import os

import numpy as np

from svo_tpu_torch.geometry import camera as cam_mod
from svo_tpu_torch.io.kitti import load_gray


# --------------------------------------------------------------------------
# calibration model
# --------------------------------------------------------------------------

class PinholeRadtan:
    def __init__(self, K: np.ndarray, D: np.ndarray, T_BS: np.ndarray, size):
        self.K = np.asarray(K, np.float64)
        self.D = np.asarray(D, np.float64)  # k1 k2 p1 p2
        self.T_BS = np.asarray(T_BS, np.float64)  # body <- sensor? (sensor in body)
        self.size = size  # (H, W)

    def distort(self, xn: np.ndarray) -> np.ndarray:
        """Apply radtan to normalized coords (...,2)."""
        k1, k2, p1, p2 = self.D[:4]
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        return np.stack([xd, yd], axis=-1)


def load_sensor_yaml(path: str) -> PinholeRadtan:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    fu, fv, cu, cv = data["intrinsics"]
    K = np.array([[fu, 0, cu], [0, fv, cv], [0, 0, 1]])
    D = np.array(data["distortion_coefficients"])
    T = np.array(data["T_BS"]["data"]).reshape(4, 4)
    h, w = data["resolution"][1], data["resolution"][0]
    return PinholeRadtan(K, D, T, (h, w))


# --------------------------------------------------------------------------
# Bouguet rectification
# --------------------------------------------------------------------------

def _rot_align_baseline(t: np.ndarray) -> np.ndarray:
    """Rotation whose rows align the camera frame with the baseline: x along
    t, y ~ image-down orthogonal, z forward."""
    e1 = t / np.linalg.norm(t)
    e2 = np.array([-t[1], t[0], 0.0])
    n = np.linalg.norm(e2)
    if n < 1e-9:
        e2 = np.array([0.0, 1.0, 0.0])
    else:
        e2 = e2 / n
    e3 = np.cross(e1, e2)
    return np.stack([e1, e2, e3], axis=0)


class StereoRectifier:
    """Precomputed rectification for an unrectified stereo pair."""

    def __init__(self, cam0: PinholeRadtan, cam1: PinholeRadtan,
                 out_size: tuple[int, int] | None = None):
        self.cam0, self.cam1 = cam0, cam1
        H, W = out_size or cam0.size
        self.size = (H, W)

        # cam1 <- cam0 transform from body extrinsics: T_10 = T_S1B @ T_BS0
        T_10 = np.linalg.inv(cam1.T_BS) @ cam0.T_BS
        R_10 = T_10[:3, :3]
        t_10 = T_10[:3, 3]

        # Split the relative rotation between the two views (Bouguet), then
        # align with the baseline expressed in the cam0 frame.
        from scipy.spatial.transform import Rotation

        rvec = Rotation.from_matrix(R_10).as_rotvec()
        R_half1 = Rotation.from_rotvec(rvec * 0.5).as_matrix()      # applied to cam1
        R_half0 = Rotation.from_rotvec(-rvec * 0.5).as_matrix()     # applied to cam0
        # baseline in the half-rotated cam0 frame: t from cam0 to cam1 in
        # cam0 coords is -R_10^T t_10
        t0 = -R_10.T @ t_10
        R_align = _rot_align_baseline(R_half0 @ t0)
        self.R_rect0 = R_align @ R_half0
        self.R_rect1 = R_align @ R_half0 @ R_10.T
        self.baseline = float(np.linalg.norm(t_10))

        # shared rectified intrinsics
        f = (cam0.K[0, 0] + cam0.K[1, 1] + cam1.K[0, 0] + cam1.K[1, 1]) / 4.0
        self.K_new = np.array(
            [[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]]
        )
        self.map0 = self._make_map(cam0, self.R_rect0)
        self.map1 = self._make_map(cam1, self.R_rect1)
        # T: rectified-cam0 <- body (for GT conversion)
        T_rc0 = np.eye(4)
        T_rc0[:3, :3] = self.R_rect0
        self.T_rect0_body = T_rc0 @ np.linalg.inv(cam0.T_BS)

    def _make_map(self, cam: PinholeRadtan, R_rect: np.ndarray) -> np.ndarray:
        """(H,W,2) source-pixel sampling map for the rectified image."""
        H, W = self.size
        us, vs = np.meshgrid(np.arange(W), np.arange(H))
        Kinv = np.linalg.inv(self.K_new)
        rays = np.stack([us, vs, np.ones_like(us)], axis=-1) @ Kinv.T
        rays = rays @ R_rect  # = R_rect^T applied to each ray
        xn = rays[..., :2] / rays[..., 2:3]
        xd = cam.distort(xn)
        u_src = cam.K[0, 0] * xd[..., 0] + cam.K[0, 2]
        v_src = cam.K[1, 1] * xd[..., 1] + cam.K[1, 2]
        return np.stack([v_src, u_src], axis=-1).astype(np.float32)

    @staticmethod
    def _remap(img: np.ndarray, m: np.ndarray) -> np.ndarray:
        """Bilinear remap with border clamp (pure NumPy)."""
        H, W = img.shape
        v = np.clip(m[..., 0], 0, H - 1.001)
        u = np.clip(m[..., 1], 0, W - 1.001)
        v0 = v.astype(np.int64)
        u0 = u.astype(np.int64)
        fv = (v - v0).astype(np.float32)
        fu = (u - u0).astype(np.float32)
        a = img[v0, u0]
        b = img[v0, u0 + 1]
        c = img[v0 + 1, u0]
        d = img[v0 + 1, u0 + 1]
        return (
            a * (1 - fu) * (1 - fv) + b * fu * (1 - fv)
            + c * (1 - fu) * fv + d * fu * fv
        ).astype(np.float32)

    def rectify(self, img0: np.ndarray, img1: np.ndarray):
        return self._remap(img0, self.map0), self._remap(img1, self.map1)


# --------------------------------------------------------------------------
# sequence reader
# --------------------------------------------------------------------------

def parse_groundtruth(root: str) -> tuple[np.ndarray, np.ndarray]:
    """(timestamps (F,), T_WB (F,4,4)) from state_groundtruth_estimate0."""
    from scipy.spatial.transform import Rotation

    path = os.path.join(root, "mav0", "state_groundtruth_estimate0", "data.csv")
    ts, poses = [], []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            t = int(row[0])
            p = np.array([float(x) for x in row[1:4]])
            qw, qx, qy, qz = (float(x) for x in row[4:8])
            T = np.eye(4)
            T[:3, :3] = Rotation.from_quat([qx, qy, qz, qw]).as_matrix()
            T[:3, 3] = p
            ts.append(t)
            poses.append(T)
    return np.array(ts), np.stack(poses)


class EurocSequence:
    """Iterate rectified stereo pairs of an EuRoC sequence; exposes the
    rectified Camera (K_new + baseline) and GT poses in the rectified-cam0
    frame, index-aligned with the frames."""

    def __init__(self, root: str, start: int = 0, end: int | None = None,
                 out_size: tuple[int, int] | None = None):
        self.root = root
        cam0 = load_sensor_yaml(os.path.join(root, "mav0", "cam0", "sensor.yaml"))
        cam1 = load_sensor_yaml(os.path.join(root, "mav0", "cam1", "sensor.yaml"))
        self.rectifier = StereoRectifier(cam0, cam1, out_size)

        d0 = os.path.join(root, "mav0", "cam0", "data")
        d1 = os.path.join(root, "mav0", "cam1", "data")
        names0 = sorted(os.listdir(d0))
        names1 = set(os.listdir(d1))
        self.pairs = [
            (os.path.join(d0, n), os.path.join(d1, n))
            for n in names0
            if n in names1
        ][start:end]
        self.timestamps = np.array(
            [int(os.path.splitext(os.path.basename(l))[0]) for l, _ in self.pairs]
        )

    @property
    def camera(self) -> cam_mod.Camera:
        K = self.rectifier.K_new
        return cam_mod.from_intrinsics(
            K[0, 0], K[1, 1], K[0, 2], K[1, 2], self.rectifier.baseline
        )

    def gt_cam_poses(self) -> np.ndarray:
        """(F,4,4) GT poses of the rectified cam0 (camera-to-world),
        nearest-timestamp matched to the frames."""
        ts, T_WB = parse_groundtruth(self.root)
        idx = np.searchsorted(ts, self.timestamps)
        idx = np.clip(idx, 0, len(ts) - 1)
        T_inv = np.linalg.inv(self.rectifier.T_rect0_body)  # body <- rect0
        return T_WB[idx] @ T_inv[None]

    def __iter__(self):
        for i, (p0, p1) in enumerate(self.pairs):
            img0 = load_gray(p0)
            img1 = load_gray(p1)
            left, right = self.rectifier.rectify(img0, img1)
            yield i, left, right
