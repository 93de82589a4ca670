#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (svo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. It builds the port's CUDA kernel from the
sources in the checkout (nvcc, sm_90a), holds it against its plain PyTorch
version at the main path's shapes, runs the main path (bench.py's 97-frame
376x1241 synthetic sequence through StereoVO.run_chunked with chunk 12 and
keyframe cadence 6) and checks its accuracy, then times a second, warm run.
Every phase prints one line; any failed check raises and the script exits
non-zero. Without a CUDA device it exits non-zero before printing a result.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SHAPE = (376, 1241)  # KITTI seq 00 image size, as bench.py
N_FRAMES = 97        # 1 bootstrap frame + 8 chunks of 12, as bench.py
ATE_LIMIT_M = 0.273  # the OpenCV reference pipeline's ATE on this sequence
REPS = 25            # timing samples per measurement (median reported)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def median_ms(fn, reps: int = REPS, inner: int = 10) -> float:
    """Median over `reps` samples of the mean time of `inner` back-to-back
    calls, from CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return float(np.median(samples))


def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name} | count {torch.cuda.device_count()} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    print(smi)  # name, power limit: exactly as nvidia-smi prints them
    return name


def phase_build() -> None:
    from svo_tpu_torch import _build

    t0 = time.perf_counter()
    path = _build.library_path()
    _build.load()
    print(f"build: {os.path.relpath(path, REPO)} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")


def phase_kernel(frame) -> dict:
    """Kernel against its plain version at every level of the temporal and
    stereo calls, with ~40% dead slots and corners at and past the borders."""
    from svo_tpu_torch.ops import klt
    from svo_tpu_torch.ops.klt_patches import (
        extract_klt_patches, extract_klt_patches_ref,
    )

    left, right = (torch.from_numpy(f).cuda() for f in frame)
    levels_l, grads_l = klt.KltTracker.build_pyramid(left, 3)
    levels_r, _ = klt.KltTracker.build_pyramid(right, 3)
    rng = np.random.default_rng(0)
    rows, worst = [], 0.0
    for kind, n, window, margin_x in (("temporal", 128, 21, 6), ("stereo", 192, 11, 16)):
        for lvl in range(4):
            prev, curr = levels_l[lvl], levels_r[lvl]
            gx, gy = grads_l[lvl]
            H, W = prev.shape
            py, px = klt._level_rows(window, H), klt._patch_cols(window, margin_x)
            pos = rng.uniform([-8, -8], [W + 8, H + 8], (n, 2)).astype(np.float32)
            pos[:4] = [[0, 0], [W - 1, H - 1], [-50, H + 50], [W + 50, -50]]
            guess = rng.uniform(-4, 4, (n, 2)).astype(np.float32)
            corners = klt._corners(
                torch.from_numpy(pos).cuda(), torch.from_numpy(guess).cuda(),
                H, W, py, px, window, margin_x,
            )
            # raw corners past the borders too: the kernel clamps them itself
            corners[1][4], corners[3][5] = W + 100, -100
            valid = torch.from_numpy(rng.random(n) >= 0.4).cuda()
            args = (prev, gx, gy, curr, *corners, valid, py, px)
            got = extract_klt_patches(*args)
            want = extract_klt_patches_ref(*args)
            torch.cuda.synchronize()
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            worst = max(worst, err)
            check(err == 0.0, f"{kind} level {lvl}: kernel differs from plain by {err}")
            ms = median_ms(lambda: extract_klt_patches(*args))
            plain = median_ms(lambda: extract_klt_patches_ref(*args))
            rows.append(dict(kind=kind, level=lvl, H=H, W=W, N=n, py=py, px=px,
                             ms=ms, plain_ms=plain, max_abs_err=err))
            print(f"kernel klt_patches {kind:8s} L{lvl} {H}x{W} N={n} {py}x{px}: "
                  f"max|diff| {err} | kernel {ms:.4f} ms | plain {plain:.4f} ms")
    return dict(rows=rows, max_abs_err=worst)


def _run(frames, seq, device, chunk=12, cadence=6):
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.geometry import camera as cam_mod
    from svo_tpu_torch.pipeline.odometry import StereoVO

    H, W = frames[0][1].shape
    cfg = Config(use_orb=False, image_height=H, image_width=W)
    cam = cam_mod.from_intrinsics(
        seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline
    )
    vo = StereoVO(cfg, cam, device=device, chunk=chunk, kf_cadence=cadence)
    return vo.run_chunked(frames)


def _drive_cadenced(frames, seq, device, noises, cadence=6):
    """The cadenced frame steps of run_chunked, with the PnP noise given."""
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.geometry import camera as cam_mod
    from svo_tpu_torch.pipeline import frontend

    H, W = frames[0][1].shape
    cfg = Config(use_orb=False, image_height=H, image_width=W)
    cam = cam_mod.from_intrinsics(
        seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline, device=device
    )

    def img(a):
        return torch.from_numpy(a).to(device)

    st = frontend.make_bootstrap(cam, cfg)(img(frames[0][1]), img(frames[0][2]))
    for i, (_, left, right) in enumerate(frames[1:]):
        st = frontend.step_body(
            st, img(left), img(right), cam, cfg,
            kf_mode="always" if i % cadence == 0 else "never",
            pnp_noise=noises[i].to(device),
        )
    return st.poses[: len(frames)].cpu().numpy()


def phase_small_agreement() -> None:
    """A small sequence through the card and through the CPU path (the
    plain version of every kernel) with the same PnP noise: trajectories
    within 10 cm and 1 deg, the bound svo_tpu's tests hold two tracker
    engines to."""
    from svo_tpu_torch.geometry.pnp import gumbel_noise
    from svo_tpu_torch.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(n_frames=13, shape=(96, 256), fx=120.0, speed=0.12, seed=3)
    frames = list(seq)
    gen = torch.Generator().manual_seed(0)
    noises = [gumbel_noise((128, 128), gen, "cpu") for _ in frames[1:]]
    gpu = _drive_cadenced(frames, seq, "cuda", noises)
    cpu = _drive_cadenced(frames, seq, "cpu", noises)
    check(bool(np.isfinite(gpu).all()), "small run: non-finite poses on the card")
    dt = np.linalg.norm(gpu[:, :3, 3] - cpu[:, :3, 3], axis=-1).max()
    ang = max(
        np.degrees(np.arccos(np.clip((np.trace(a[:3, :3].T @ b[:3, :3]) - 1) / 2, -1, 1)))
        for a, b in zip(gpu, cpu)
    )
    print(f"small run 96x256 x13, card vs CPU path, same PnP noise: max |dt| "
          f"{dt:.6f} m, max rotation diff {ang:.6f} deg")
    check(dt < 0.1 and ang < 1.0, "card and CPU paths disagree on the small run")


def phase_main_path(kernels) -> dict:
    from svo_tpu_torch.eval.trajectory import ate_rmse
    from svo_tpu_torch.io.synthetic import SyntheticSequence
    from svo_tpu_torch.ops.klt_patches import extract_klt_patches

    t0 = time.perf_counter()
    seq = SyntheticSequence(n_frames=N_FRAMES, shape=SHAPE, fx=718.856)
    frames = list(seq)
    print(f"rendered {N_FRAMES} frames {SHAPE[0]}x{SHAPE[1]} in "
          f"{time.perf_counter() - t0:.1f} s")

    for k in kernels:
        k.launches = 0
    res = _run(frames, seq, "cuda")
    launches = {k.__name__: k.launches for k in kernels}

    poses = res.poses
    check(poses.shape == (N_FRAMES, 4, 4), f"poses shape {poses.shape}")
    check(bool(np.isfinite(poses).all()), "NaN/inf in the poses")
    ate = ate_rmse(poses, seq.gt_poses)
    inl = float(res.metrics[1:, 1].mean())
    live = float(res.metrics[:, 2].mean())
    print(f"main path: ATE {ate:.4f} m (limit {ATE_LIMIT_M}) | mean inlier ratio "
          f"{inl:.4f} | mean live features {live:.1f} | keyframes "
          f"{int(res.kf_flags.sum())} | klt_patches launches {launches}")
    check(np.isfinite(ate) and ate <= ATE_LIMIT_M, f"ATE {ate} m > {ATE_LIMIT_M} m")
    check(inl >= 0.8, f"mean inlier ratio {inl} < 0.8")
    check(live >= 60, f"mean live features {live} < 60")
    check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
    check(extract_klt_patches.launches > 0, "klt_patches never launched")

    torch.cuda.reset_peak_memory_stats()
    warm = _run(frames, seq, "cuda")
    peak = torch.cuda.max_memory_allocated()
    check(np.isfinite(warm.poses).all(), "NaN/inf in the warm run's poses")
    print(f"warm run: {warm.fps:.3f} frames/s | {1e3 / warm.fps:.2f} ms/frame | "
          f"{warm.total_time_s:.3f} s for {N_FRAMES - 1} frames | peak device memory "
          f"{peak / 2**20:.1f} MiB | ATE {ate_rmse(warm.poses, seq.gt_poses):.4f} m")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from svo_tpu_torch.io.synthetic import SyntheticSequence
    from svo_tpu_torch.ops.klt_patches import extract_klt_patches

    name = phase_device()
    phase_build()
    frame = SyntheticSequence(n_frames=1, shape=SHAPE, fx=718.856).frame(0)
    kern = phase_kernel(frame)
    phase_small_agreement()
    launches = phase_main_path([extract_klt_patches])

    lvl0 = next(r for r in kern["rows"] if r["kind"] == "temporal" and r["level"] == 0)
    print(json.dumps({"kernels": [{
        "name": "klt_patches",
        "route": "cuda",
        "source": "svo_tpu_torch/csrc/klt_patches.cu",
        "replaces": "svo_tpu/ops/klt_pallas.py:139",
        "launches": launches["extract_klt_patches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": lvl0["ms"],
        "plain_ms": lvl0["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
