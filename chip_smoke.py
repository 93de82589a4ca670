#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (svo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. It builds the port's CUDA kernels from the
sources in the checkout (nvcc, sm_90a) and holds each against its plain
PyTorch version at the main path's shapes: KLT patch extraction
(klt_patches) and the fused LK level (lk_level). It runs a small
card-vs-CPU agreement check with both KLT engines, then the main path
(bench.py's 97-frame 376x1241 synthetic sequence through
StereoVO.run_chunked with chunk 12 and keyframe cadence 6) once with each
engine, lk_engine="patches" (svo_tpu's default, through klt_patches) and
"fused" (through lk_level), and checks accuracy and which kernel each run
launched. Warm runs of both engines, in turns, give frames/s; a profiled
chunk of each gives kernel launches per frame. Every phase prints its
lines; any failed check raises and the script exits non-zero. Without a
CUDA device it exits non-zero before printing a result. The last line is
{"ok": true, "device": {...}}.
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
ENGINES = ("patches", "fused")


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


def phase_lk_level(frame) -> dict:
    """The fused LK-level kernel against its plain version at the 9 shapes
    of the main path: temporal L0-L3 (N=128, window 21, margins 6/6), the
    fb re-track at L0, stereo L0-L3 (N=192, window 11, margins 16/6), all
    8 iterations, on the 376x1241 frame's padded pyramid, with ~40% dead
    slots and positions at and past the borders.

    Tolerances: flags (solvable, in_patch) equal on >= 99% of the slots; d
    within 1e-3 px where both sides say solvable and in_patch; a dead
    slot's d equal to its guess exactly; min_eig within 1e-4 of the call's
    largest min_eig (norm-wise: both sides take lambda_min = tr/2 - disc in
    f32 from window sums added in another order, so where G is
    ill-conditioned the elementwise relative error is not bounded); a
    second launch bit-identical to the first."""
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.ops import klt
    from svo_tpu_torch.ops.lk_fused import lk_track_level, lk_track_level_ref

    cfg = Config()
    left, right = (torch.from_numpy(f).cuda() for f in frame)
    levels_l, grads_l = klt.KltTracker.build_pyramid(left, 3)
    levels_r, _ = klt.KltTracker.build_pyramid(right, 3)
    rng = np.random.default_rng(1)
    shapes = [("temporal", lvl, 128, cfg.temporal_klt, 4.0) for lvl in range(4)]
    shapes.append(("fb", 0, 128, cfg.temporal_klt, 0.5))
    shapes += [("stereo", lvl, 192, cfg.stereo_klt, 4.0) for lvl in range(4)]
    rows, worst = [], 0.0
    for kind, lvl, n, params, reach in shapes:
        prev, curr = levels_l[lvl], levels_r[lvl]
        gx, gy = grads_l[lvl]
        H, W = prev.shape
        w, mx = params.window, params.margin_x
        py = klt._level_rows(w, H)
        check(klt._fused_level_ok(H, W, py, w, mx), f"{kind} L{lvl} {H}x{W} is not fused")
        pos = rng.uniform([-8, -8], [W + 8, H + 8], (n, 2)).astype(np.float32)
        pos[:4] = [[0, 0], [W - 1, H - 1], [-50, H + 50], [W + 50, -50]]
        guess = rng.uniform(-reach, reach, (n, 2)).astype(np.float32)
        valid = torch.from_numpy(rng.random(n) >= 0.4).cuda()
        guess_t = torch.from_numpy(guess).cuda()
        args = (prev, gx, gy, curr, torch.from_numpy(pos).cuda(), guess_t, valid)
        kw = dict(window=w, py=py, max_iters=params.max_iters, eps=params.eps,
                  min_eig_threshold=params.min_eig_threshold, margin_x=mx,
                  margin_y=klt._MY)
        got = lk_track_level(*args, **kw)
        again = lk_track_level(*args, **kw)
        want = lk_track_level_ref(*args, **kw)
        torch.cuda.synchronize()
        (d, me, sv, ip), (d_r, me_r, sv_r, ip_r) = got, want
        flags = min(float((sv == sv_r).float().mean()), float((ip == ip_r).float().mean()))
        ok = sv & ip & sv_r & ip_r
        n_ok = int(ok.sum())
        err = float((d - d_r)[ok].abs().max()) if n_ok else 0.0
        me_err = float((me - me_r)[valid].abs().max() / me_r[valid].abs().max())
        dead = ~valid
        dead_exact = bool(torch.equal(d[dead], guess_t[dead]) and not sv[dead].any())
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        worst = max(worst, err)
        ms = median_ms(lambda: lk_track_level(*args, **kw))
        plain = median_ms(lambda: lk_track_level_ref(*args, **kw))
        rows.append(dict(kind=kind, level=lvl, H=H, W=W, N=n, window=w, ms=ms,
                         plain_ms=plain, max_abs_err=err, min_eig_rel=me_err))
        print(f"kernel lk_level {kind:8s} L{lvl} {H}x{W} N={n} w={w} m={mx}/{klt._MY}: "
              f"flags agree {flags:.4f} | max|d diff| {err:.3g} px over {n_ok} "
              f"tracked | min_eig diff {me_err:.3g} of max | dead d == guess "
              f"{dead_exact} | repeat bit-identical {repeat} | kernel {ms:.4f} ms | "
              f"plain {plain:.4f} ms")
        check(flags >= 0.99, f"{kind} L{lvl}: flags agree on {flags}")
        check(n_ok >= 8, f"{kind} L{lvl}: only {n_ok} slots tracked by both")
        check(err <= 1e-3, f"{kind} L{lvl}: d differs by {err} px")
        check(me_err <= 1e-4, f"{kind} L{lvl}: min_eig differs by {me_err} of max")
        check(dead_exact, f"{kind} L{lvl}: a dead slot moved or is solvable")
        check(repeat, f"{kind} L{lvl}: a second launch differs")
    return dict(rows=rows, max_abs_err=worst)


def _run(frames, seq, device, lk_engine, chunk=12, cadence=6):
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.geometry import camera as cam_mod
    from svo_tpu_torch.pipeline.odometry import StereoVO

    H, W = frames[0][1].shape
    cfg = Config(use_orb=False, image_height=H, image_width=W)
    cam = cam_mod.from_intrinsics(
        seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline
    )
    vo = StereoVO(cfg, cam, device=device, chunk=chunk, kf_cadence=cadence,
                  lk_engine=lk_engine)
    return vo.run_chunked(frames)


def _drive_cadenced(frames, seq, device, noises, lk_engine, cadence=6):
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

    st = frontend.make_bootstrap(cam, cfg, lk_engine)(img(frames[0][1]), img(frames[0][2]))
    for i, (_, left, right) in enumerate(frames[1:]):
        st = frontend.step_body(
            st, img(left), img(right), cam, cfg,
            kf_mode="always" if i % cadence == 0 else "never",
            pnp_noise=noises[i].to(device), lk_engine=lk_engine,
        )
    return st.poses[: len(frames)].cpu().numpy()


def phase_small_agreement(lk_engine: str) -> None:
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
    gpu = _drive_cadenced(frames, seq, "cuda", noises, lk_engine)
    cpu = _drive_cadenced(frames, seq, "cpu", noises, lk_engine)
    check(bool(np.isfinite(gpu).all()), "small run: non-finite poses on the card")
    dt = np.linalg.norm(gpu[:, :3, 3] - cpu[:, :3, 3], axis=-1).max()
    ang = max(
        np.degrees(np.arccos(np.clip((np.trace(a[:3, :3].T @ b[:3, :3]) - 1) / 2, -1, 1)))
        for a, b in zip(gpu, cpu)
    )
    print(f"small run 96x256 x13, lk_engine={lk_engine}, card vs CPU path, same PnP noise: max |dt| "
          f"{dt:.6f} m, max rotation diff {ang:.6f} deg")
    check(dt < 0.1 and ang < 1.0, "card and CPU paths disagree on the small run")


def _launches_per_frame(frames, seq, lk_engine, n=6) -> tuple[float, float, dict]:
    """Kernel launches and device kernel ms per frame (torch.profiler) over
    one warm cadenced chunk of n frames: one keyframe step, n-1 tracking
    steps. The profiler counts every device activity: kernels, fills and
    copies. Also the mean device us per launch of the port's own kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from svo_tpu_torch.config import Config
    from svo_tpu_torch.geometry import camera as cam_mod
    from svo_tpu_torch.pipeline import frontend

    H, W = frames[0][1].shape
    cfg = Config(use_orb=False, image_height=H, image_width=W)
    cam = cam_mod.from_intrinsics(
        seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline, device="cuda"
    )
    step = frontend.make_cadenced_chunk_step(cam, cfg, n, 6, lk_engine)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def chunk(c):
        part = frames[1 + c * n: 1 + (c + 1) * n]
        return [torch.from_numpy(np.stack([np.clip(f[k], 0, 255).astype(np.uint8)
                                           for f in part])).cuda() for k in (1, 2)]

    def img(a):
        return torch.from_numpy(a).cuda()

    st = frontend.make_bootstrap(cam, cfg, lk_engine)(img(frames[0][1]), img(frames[0][2]))
    st = step(st, *chunk(0), gen)  # warm-up chunk
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        st = step(st, *chunk(1), gen)
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    launches = sum(e.count for e in dev)
    check(launches > 0, "the profiler saw no device activity")
    own = {}
    for name in ("klt_patches_kernel", "lk_level_kernel"):
        evs = [e for e in dev if name in e.key]
        count = sum(e.count for e in evs)
        if count:
            own[name] = sum(e.self_device_time_total for e in evs) / count
    return launches / n, sum(e.self_device_time_total for e in dev) / n / 1e3, own


def phase_main_path(kernels) -> dict:
    """bench.py's path once per KLT engine, then warm runs in turns and a
    profiled chunk of each. Returns the launches of each kernel wrapper in
    each engine's first run."""
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.eval.trajectory import ate_rmse
    from svo_tpu_torch.io.synthetic import SyntheticSequence

    t0 = time.perf_counter()
    seq = SyntheticSequence(n_frames=N_FRAMES, shape=SHAPE, fx=718.856)
    frames = list(seq)
    print(f"rendered {N_FRAMES} frames {SHAPE[0]}x{SHAPE[1]} in "
          f"{time.perf_counter() - t0:.1f} s")
    cfg = Config()
    # every level qualifies for the fused engine at 376x1241, so one level
    # is one launch: (temporal levels + the fb level) per frame, stereo
    # levels per keyframe (bootstrap included)
    per_frame = cfg.temporal_klt.max_level + 1 + 1
    per_kf = cfg.stereo_klt.max_level + 1
    path_kernel = {"patches": "extract_klt_patches", "fused": "lk_track_level"}

    launches = {}
    for engine in ENGINES:
        for k in kernels:
            k.launches = 0
        res = _run(frames, seq, "cuda", engine)
        counts = {k.__name__: k.launches for k in kernels}
        launches[engine] = counts
        poses = res.poses
        check(poses.shape == (N_FRAMES, 4, 4), f"poses shape {poses.shape}")
        check(bool(np.isfinite(poses).all()), f"{engine}: NaN/inf in the poses")
        ate = ate_rmse(poses, seq.gt_poses)
        inl = float(res.metrics[1:, 1].mean())
        live = float(res.metrics[:, 2].mean())
        n_kf = int(res.kf_flags.sum())
        print(f"main path lk_engine={engine}: ATE {ate:.4f} m (limit {ATE_LIMIT_M}) | "
              f"mean inlier ratio {inl:.4f} | mean live features {live:.1f} | "
              f"keyframes {n_kf} | launches {counts}")
        check(np.isfinite(ate) and ate <= ATE_LIMIT_M, f"{engine}: ATE {ate} m > {ATE_LIMIT_M} m")
        check(inl >= 0.8, f"{engine}: mean inlier ratio {inl} < 0.8")
        check(live >= 60, f"{engine}: mean live features {live} < 60")
        expected = per_frame * (N_FRAMES - 1) + per_kf * n_kf
        for name, count in counts.items():
            want = expected if name == path_kernel[engine] else 0
            check(count == want, f"{engine}: {name} launched {count} times, expected {want}")

    warm = {e: [] for e in ENGINES}
    for engine in ENGINES + ENGINES[::-1]:  # in turns: a, b, b, a
        torch.cuda.reset_peak_memory_stats()
        res = _run(frames, seq, "cuda", engine)
        peak = torch.cuda.max_memory_allocated()
        check(bool(np.isfinite(res.poses).all()), f"{engine}: NaN/inf in a warm run's poses")
        warm[engine].append(res.fps)
        print(f"warm run lk_engine={engine}: {res.fps:.3f} frames/s | "
              f"{1e3 / res.fps:.2f} ms/frame | {res.total_time_s:.3f} s for "
              f"{N_FRAMES - 1} frames | peak device memory {peak / 2**20:.1f} MiB | "
              f"ATE {ate_rmse(res.poses, seq.gt_poses):.4f} m")
    for engine in ENGINES:
        per, dev_ms, own = _launches_per_frame(frames, seq, engine)
        own_us = " | ".join(f"{k} {v:.2f} us device per launch" for k, v in own.items())
        print(f"profile lk_engine={engine}: {per:.0f} device launches per frame | "
              f"{dev_ms:.2f} ms device kernel time per frame | {own_us} | warm "
              f"frames/s {' / '.join(f'{f:.3f}' for f in warm[engine])}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from svo_tpu_torch.io.synthetic import SyntheticSequence
    from svo_tpu_torch.ops.klt_patches import extract_klt_patches
    from svo_tpu_torch.ops.lk_fused import lk_track_level

    name = phase_device()
    phase_build()
    frame = SyntheticSequence(n_frames=1, shape=SHAPE, fx=718.856).frame(0)
    kern = phase_kernel(frame)
    lk = phase_lk_level(frame)
    for engine in ENGINES:
        phase_small_agreement(engine)
    launches = phase_main_path([extract_klt_patches, lk_track_level])

    lvl0 = next(r for r in kern["rows"] if r["kind"] == "temporal" and r["level"] == 0)
    lk0 = next(r for r in lk["rows"] if r["kind"] == "temporal" and r["level"] == 0)
    print(json.dumps({"kernels": [{
        "name": "klt_patches",
        "route": "cuda",
        "source": "svo_tpu_torch/csrc/klt_patches.cu",
        "replaces": "svo_tpu/ops/klt_pallas.py:139",
        "launches": launches["patches"]["extract_klt_patches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": lvl0["ms"],
        "plain_ms": lvl0["plain_ms"],
    }, {
        "name": "lk_level",
        "route": "cuda",
        "source": "svo_tpu_torch/csrc/lk_level.cu",
        "replaces": "svo_tpu/ops/lk_pallas.py:432",
        "launches": launches["fused"]["lk_track_level"],
        "max_abs_err": lk["max_abs_err"],
        "ms": lk0["ms"],
        "plain_ms": lk0["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
