"""Synthetic stereo sequence generator with exact ground truth.

A copy of svo_tpu/io/synthetic.py (numpy only), so the port runs where jax is not
installed; tests/test_torch_geometry.py holds the two equal.

No KITTI data ships with this environment, so correctness (ATE bounds) and
benchmarks run on procedurally generated stereo sequences: a 3-plane world
(ground + two walls — non-coplanar, so PnP is well-posed) carrying a blocky
value-noise texture (sharp corners for FAST, smooth gradients for KLT),
ray-cast per pixel per camera. Ground-truth poses are exact, so ATE measures
pure pipeline error.

The rendering is plain vectorized NumPy (host-side, done once per run, not
benchmarked).
"""

from __future__ import annotations

import numpy as np


def _value_noise_texture(rng, n=512, cell=8, blur=1, lo=40.0, hi=215.0,
                         fine_amp=15.0):
    """Blocky texture: coarse random grid upsampled nearest + slight smoothing,
    plus a fine octave. Produces FAST corners at block boundaries and clean
    KLT gradients. cell/lo/hi/fine_amp parameterize feature density and
    contrast for the multi-world robustness suite."""
    coarse = rng.uniform(lo, hi, (n // cell, n // cell)).astype(np.float32)
    tex = np.kron(coarse, np.ones((cell, cell), np.float32))
    fine = rng.uniform(-fine_amp, fine_amp, (n, n)).astype(np.float32)
    tex = tex + fine
    for _ in range(blur):
        tex = 0.25 * (
            np.roll(tex, 1, 0) + np.roll(tex, -1, 0)
            + np.roll(tex, 1, 1) + np.roll(tex, -1, 1)
        )
    return np.clip(tex, 0, 255)


class Plane:
    def __init__(self, point, normal, u_axis, tex, tex_scale=0.15):
        self.p = np.asarray(point, np.float64)
        self.n = np.asarray(normal, np.float64)
        self.n /= np.linalg.norm(self.n)
        self.u = np.asarray(u_axis, np.float64)
        self.u /= np.linalg.norm(self.u)
        self.v = np.cross(self.n, self.u)
        self.tex = tex
        self.scale = tex_scale


def default_world(rng) -> list[Plane]:
    """Ground at y=1.7 (camera height), walls at x=±10."""
    return [
        Plane([0, 1.7, 0], [0, -1, 0], [1, 0, 0], _value_noise_texture(rng)),
        Plane([-10, 0, 0], [1, 0, 0], [0, 0, 1], _value_noise_texture(rng)),
        Plane([10, 0, 0], [-1, 0, 0], [0, 0, 1], _value_noise_texture(rng)),
    ]


def make_world(rng, kind: str = "corridor") -> list[Plane]:
    """Parameterized worlds for the robustness suite (WORLDS_r04):

    - corridor         the tuning world (ground + walls at +-10)
    - corridor-narrow  walls at +-6, coarse low-contrast texture
    - box              open ground inside a large 80 m box (turn/loop room)
    - box-fine         large box, fine high-frequency texture
    - corridor-lowtex  weak-gradient texture (contrast halved, heavy blur)
    """
    tex = _value_noise_texture
    if kind == "corridor":
        return default_world(rng)
    if kind == "corridor-narrow":
        t = dict(cell=16, fine_amp=8.0)
        return [
            Plane([0, 1.7, 0], [0, -1, 0], [1, 0, 0], tex(rng, **t)),
            Plane([-6, 0, 0], [1, 0, 0], [0, 0, 1], tex(rng, **t)),
            Plane([6, 0, 0], [-1, 0, 0], [0, 0, 1], tex(rng, **t)),
        ]
    if kind in ("box", "box-fine"):
        t = dict(cell=4, fine_amp=20.0) if kind == "box-fine" else {}
        s = 0.15 if kind != "box-fine" else 0.08
        return [
            Plane([0, 1.7, 0], [0, -1, 0], [1, 0, 0], tex(rng), 0.15),
            Plane([-40, 0, 0], [1, 0, 0], [0, 0, 1], tex(rng, **t), s),
            Plane([40, 0, 0], [-1, 0, 0], [0, 0, 1], tex(rng, **t), s),
            Plane([0, 0, 100], [0, 0, -1], [1, 0, 0], tex(rng, **t), s),
            Plane([0, 0, -40], [0, 0, 1], [1, 0, 0], tex(rng, **t), s),
        ]
    if kind == "corridor-lowtex":
        t = dict(lo=85.0, hi=170.0, fine_amp=6.0, blur=3)
        return [
            Plane([0, 1.7, 0], [0, -1, 0], [1, 0, 0], tex(rng, **t)),
            Plane([-10, 0, 0], [1, 0, 0], [0, 0, 1], tex(rng, **t)),
            Plane([10, 0, 0], [-1, 0, 0], [0, 0, 1], tex(rng, **t)),
        ]
    if kind == "atrium":
        # round-5 HELD-OUT world (never tuned on): a 60 m room whose walls
        # carry DIFFERENT texture statistics — coarse low-contrast left,
        # heavy-blur lowtex right, fine back, default front — so a yawing
        # camera sweeps across texture regimes mid-rotation.
        return [
            Plane([0, 1.7, 0], [0, -1, 0], [1, 0, 0], tex(rng), 0.15),
            Plane([-30, 0, 0], [1, 0, 0], [0, 0, 1],
                  tex(rng, cell=16, fine_amp=8.0), 0.15),
            Plane([30, 0, 0], [-1, 0, 0], [0, 0, 1],
                  tex(rng, lo=85.0, hi=170.0, fine_amp=6.0, blur=3), 0.15),
            Plane([0, 0, 70], [0, 0, -1], [1, 0, 0],
                  tex(rng, cell=4, fine_amp=20.0), 0.1),
            Plane([0, 0, -30], [0, 0, 1], [1, 0, 0], tex(rng), 0.15),
        ]
    raise ValueError(f"unknown world kind: {kind}")


def make_trajectory(n_frames: int, speed=0.35, yaw_amp=0.06,
                    kind: str = "wobble") -> np.ndarray:
    """(F,4,4) camera-to-world poses.

    kinds:
    - wobble  forward motion with a ZERO-MEAN yaw wobble
              (yaw = yaw_amp * sin(0.05 i)). The original formulation
              integrated the wobble (yaw += amp*sin(...)), which has a
              positive-mean integral — a constant ~1.7 deg heading bias
              that walked the camera laterally THROUGH the corridor wall at
              x=10 by frame ~1100 of a long run; from outside the corridor
              half the image is textureless sky and every VO pipeline (this
              one AND the reference-equivalent CPU one) collapsed
              identically. Zero-mean yaw keeps the same per-frame wobble
              magnitude while the lateral excursion stays bounded.
    - turns   two smooth 90-degree turns (right then left) at 1/3 and 2/3
              of the run, wobble overlaid — sustained-rotation content.
    - loop    constant yaw rate closing a full circle over the run
              (radius = n*speed / 2pi) — continuous rotation + revisits.
    - slalom  large-amplitude alternating heading sweeps
              (yaw = 0.5 sin(2pi * 2.5 i / n), ~+-29 deg, five reversals)
              — sustained rotation that REVERSES direction, round-5
              held-out content.
    """
    poses = np.zeros((n_frames, 4, 4))
    pos = np.zeros(3)

    def turn_profile(i):
        # smoothstep 90-deg turns over 80 frames centered at n/3 and 2n/3
        total = 0.0
        for center, sign in ((n_frames / 3, 1.0), (2 * n_frames / 3, -1.0)):
            t = np.clip((i - (center - 40)) / 80.0, 0.0, 1.0)
            total += sign * (np.pi / 2) * (3 * t * t - 2 * t * t * t)
        return total

    for i in range(n_frames):
        yaw = yaw_amp * np.sin(i * 0.05)
        if kind == "turns":
            yaw += turn_profile(i)
        elif kind == "loop":
            yaw += 2 * np.pi * i / max(n_frames - 1, 1)
        elif kind == "slalom":
            yaw += 0.5 * np.sin(2 * np.pi * 2.5 * i / max(n_frames - 1, 1))
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        poses[i] = np.eye(4)
        poses[i, :3, :3] = R
        poses[i, :3, 3] = pos
        heading = R @ np.array([0.0, 0.0, 1.0])
        pos = pos + speed * heading
    return poses


def render_rays(
    planes: list[Plane], origin: np.ndarray, dirs: np.ndarray
) -> np.ndarray:
    """Ray-cast arbitrary world-frame rays (origin (3,), dirs (H,W,3)) —
    shared by the rectified-pinhole renderer below and the distorted
    unrectified EuRoC-mini fixture generator (scripts/make_fixtures.py)."""
    H, W = dirs.shape[:2]
    best_t = np.full((H, W), np.inf)
    img = np.full((H, W), 90.0, np.float32)  # sky/background value
    for pl in planes:
        denom = dirs @ pl.n
        num = (pl.p - origin) @ pl.n
        with np.errstate(divide="ignore", invalid="ignore"):
            t = num / denom
        hit = (t > 0.1) & (t < best_t) & (np.abs(denom) > 1e-9)
        if not hit.any():
            continue
        # guard non-hit rays (t may be inf/NaN where denom ~ 0) before they
        # enter arithmetic below — keeps bench stderr free of numpy warnings
        t = np.where(hit, t, 1.0)
        pts = origin + dirs * t[..., None]
        rel = pts - pl.p
        tu = (rel @ pl.u) / pl.scale
        tv = (rel @ pl.v) / pl.scale
        th, tw = pl.tex.shape
        iu = np.floor(tu).astype(np.int64) % tw
        iv = np.floor(tv).astype(np.int64) % th
        fu = (tu - np.floor(tu)).astype(np.float32)
        fv = (tv - np.floor(tv)).astype(np.float32)
        iu1 = (iu + 1) % tw
        iv1 = (iv + 1) % th
        val = (
            pl.tex[iv, iu] * (1 - fu) * (1 - fv)
            + pl.tex[iv, iu1] * fu * (1 - fv)
            + pl.tex[iv1, iu] * (1 - fu) * fv
            + pl.tex[iv1, iu1] * fu * fv
        )
        img = np.where(hit, val, img)
        best_t = np.where(hit, t, best_t)
    return img.astype(np.float32)


def render_frame(
    planes: list[Plane],
    T_wc: np.ndarray,
    K: np.ndarray,
    shape: tuple[int, int],
    t_cam: np.ndarray | None = None,
) -> np.ndarray:
    """Ray-cast one camera image. T_wc: camera-to-world. t_cam: extra
    camera-frame translation (stereo baseline offset, e.g. [b,0,0] for the
    right camera of a rectified rig ... the right camera sits at +b on the
    left camera's x axis)."""
    H, W = shape
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    dirs_cam = np.stack(
        [(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs, np.float64)], axis=-1
    )
    R = T_wc[:3, :3]
    origin = T_wc[:3, 3].copy()
    if t_cam is not None:
        origin = origin + R @ np.asarray(t_cam, np.float64)
    dirs = dirs_cam @ R.T  # (H,W,3) world-frame ray directions
    return render_rays(planes, origin, dirs)


class SyntheticSequence:
    """Iterable of (idx, left, right) stereo frames + exact GT poses."""

    def __init__(
        self,
        n_frames: int = 60,
        shape: tuple[int, int] = (376, 1241),
        fx: float = 718.856,
        cx: float | None = None,
        cy: float | None = None,
        baseline: float = 0.5372,
        speed: float = 0.35,
        seed: int = 7,
        world: str = "corridor",
        traj: str = "wobble",
    ):
        rng = np.random.default_rng(seed)
        H, W = shape
        self.shape = shape
        self.K = np.array(
            [
                [fx, 0, cx if cx is not None else W / 2],
                [0, fx, cy if cy is not None else H / 2],
                [0, 0, 1],
            ]
        )
        self.baseline = baseline
        self.planes = make_world(rng, world)
        self.gt_poses = make_trajectory(n_frames, speed=speed, kind=traj)
        self.n_frames = n_frames

    def frame(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        T = self.gt_poses[i]
        left = render_frame(self.planes, T, self.K, self.shape)
        right = render_frame(
            self.planes, T, self.K, self.shape, t_cam=np.array([self.baseline, 0, 0])
        )
        return left, right

    def __iter__(self):
        for i in range(self.n_frames):
            left, right = self.frame(i)
            yield i, left, right
