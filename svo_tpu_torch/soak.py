"""KITTI-scale soak run: thousands of frames through the chunked cadenced path.

    python3 -m svo_tpu_torch.soak [--frames 2401] [--small] [--chunk 12]
        [--cadence 6] [--ckpt-at C] [--resume-chunks 4] [--refine-every N]
        [--refine-reject 100] [--joint-alt] [--anchored] [--ba]
        [--device-window 80] [--device cuda|cpu] [--lk-engine fused|patches]
        [--out F]

The counterpart of scripts/soak.py, on the port's StereoVO. It exercises
what the capacity sizing (config.py Capacity, BaParams.ring_obs) encodes
and short runs never reach: the observation ring wrapping under the running
pipeline and window extraction over the wrapped ring, point-table headroom,
trajectory-slot use; and a checkpoint taken at the middle chunk (the PnP
key is part of the state) and restored into a fresh engine, whose
continuation must equal the uninterrupted run.

Frames are rendered one chunk at a time in threads (2,401 frames at
376x1241 do not fit in host RAM as a list); the time of the steps excludes
rendering. --device-window stages that many mid-run chunks on the device
first and times them between two synchronisations. --refine-every N runs
parallel/global_opt.refine_global after every N chunks (reject threshold
--refine-reject; --joint-alt makes the conservative candidate the joint
pose+point alternation, still applied to points only), built once for each
engine by make_refine_global with the engine's graph, so that on the card
the sweep replays as CUDA graphs with the state donated. It runs on the card
unless --device cpu is given. The result is a JSON object with the keys of
svo_tpu's SOAK_r05.json, plus the device; --out writes it, and one summary
line is printed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m svo_tpu_torch.soak")
    p.add_argument("--small", action="store_true", help="184x320 images")
    p.add_argument("--frames", type=int, default=2401)
    p.add_argument("--chunk", type=int, default=12)
    p.add_argument("--cadence", type=int, default=6)
    p.add_argument("--ckpt-at", type=int, default=0,
                   help="chunk index to checkpoint at (0 = halfway)")
    p.add_argument("--resume-chunks", type=int, default=4,
                   help="chunks to re-run from the checkpoint for the equivalence check")
    p.add_argument("--refine-every", type=int, default=0,
                   help="global refinement (keyframe-block BA + pose graph) every N chunks (0 = off)")
    p.add_argument("--refine-reject", type=float, default=100.0,
                   help="reject threshold (px) of the refinement")
    p.add_argument("--joint-alt", action="store_true",
                   help="joint pose+point alternation as the conservative candidate")
    p.add_argument("--anchored", action="store_true",
                   help="keyframe-anchored KLT (TrackingParams.anchored_klt)")
    p.add_argument("--ba", action="store_true", help="the in-pipeline keyframe-window BA")
    p.add_argument("--device-window", type=int, default=80,
                   help="stage this many mid-run chunks on the device and time them "
                        "between two synchronisations (0 = off)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--lk-engine", default="fused", choices=("patches", "fused"))
    p.add_argument("--out", default="", help="write the result JSON here")
    return p.parse_args(argv)


def _log(t_start: float, msg: str) -> None:
    print(f"[soak +{time.perf_counter() - t_start:7.1f}s] {msg}", file=sys.stderr, flush=True)


def soak(args: argparse.Namespace):
    """Run the soak; returns (result dict, the engine after the main run)."""
    import torch

    from svo_tpu_torch.config import Config
    from svo_tpu_torch.eval.trajectory import ate_rmse, rpe
    from svo_tpu_torch.geometry import camera as cam_mod
    from svo_tpu_torch.io.synthetic import SyntheticSequence
    from svo_tpu_torch.parallel.global_opt import make_refine_global
    from svo_tpu_torch.pipeline.odometry import StereoVO
    from svo_tpu_torch.utils import checkpoint

    t_start = time.perf_counter()
    shape = (184, 320) if args.small else (376, 1241)
    fx = 200.0 if args.small else 718.856
    seq = SyntheticSequence(n_frames=args.frames, shape=shape, fx=fx, speed=0.3)
    cfg = Config(use_orb=False, image_height=shape[0], image_width=shape[1])
    if args.ba:
        cfg = dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba, enabled=True))
    if args.anchored:
        cfg = dataclasses.replace(
            cfg, tracking=dataclasses.replace(cfg.tracking, anchored_klt=True)
        )
    camera = cam_mod.from_intrinsics(
        seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline
    )
    CH = args.chunk
    n_chunks = (args.frames - 1) // CH
    ckpt_at = args.ckpt_at or n_chunks // 2
    if not 0 < ckpt_at < n_chunks:
        raise ValueError(f"checkpoint chunk {ckpt_at} is not inside the run's {n_chunks} chunks")
    pool = ThreadPoolExecutor(min(8, os.cpu_count() or 1))  # numpy frees the GIL

    def render_chunk(c):
        pairs = list(pool.map(seq.frame, range(1 + c * CH, 1 + (c + 1) * CH)))
        return tuple(
            torch.from_numpy(np.stack([np.clip(p[k], 0, 255).astype(np.uint8) for p in pairs]))
            for k in (0, 1)
        )

    def engine():
        return StereoVO(cfg, camera, chunk=CH, kf_cadence=args.cadence,
                        device=args.device, lk_engine=args.lk_engine)

    def sync():
        if vo.device.type == "cuda":
            torch.cuda.synchronize(vo.device)

    vo = engine()
    l0, r0 = seq.frame(0)
    vo.start(l0, r0)
    _log(t_start, f"soak start: {args.frames} frames, {n_chunks} chunks of {CH}, "
         f"checkpoint at chunk {ckpt_at}, {vo.device}, lk_engine={args.lk_engine}")

    def make_refiner(eng):
        """The engine's refiner, built once with its graph (the sweep
        replayed on the card, its state donated): state -> (state, a copy
        of the verdict); None without --refine-every."""
        if not args.refine_every:
            return None
        refine = make_refine_global(
            eng.camera.K, eng.camera.K[0, 0] * eng.camera.baseline, graph=eng.graph,
            reject_threshold=args.refine_reject, alt_points_only=not args.joint_alt,
        )

        def refiner(state):
            res = refine(state.map, state.poses, state.frame_id)
            return state._replace(
                map=state.map._replace(points=res.map.points), poses=res.poses,
                pose=res.poses[state.frame_id.long()],
            ), res.accepted.clone()

        return refiner

    def step(eng, refiner, c, ls, rs):
        """One chunk, then the refinement where it is due; the verdict or
        None."""
        eng.state = eng._chunk_step(eng.state, ls.to(eng.device), rs.to(eng.device))
        if refiner is not None and (c + 1) % args.refine_every == 0:
            eng.state, acc = refiner(eng.state)
            return acc
        return None

    refiner = make_refiner(vo)
    tmp = tempfile.TemporaryDirectory()
    ckpt_path = os.path.join(tmp.name, "soak_ckpt.npz")
    hw = {"n_points": 0, "obs_cursor": 0}
    compute_s = 0.0
    verdicts = []
    dev_w = min(args.device_window, n_chunks // 2)
    dev_lo = n_chunks // 2
    dev_hi = dev_lo + dev_w
    staged = {}
    device_s = None
    r_chunks = min(args.resume_chunks, n_chunks - ckpt_at)
    rerun = {}  # the chunks the resumed engine re-runs, kept as rendered
    for c in range(n_chunks):
        if dev_w and c == dev_lo:
            sync()
            for cc in range(dev_lo, dev_hi):
                staged[cc] = tuple(x.to(vo.device) for x in render_chunk(cc))
            sync()
            t_dev = time.perf_counter()
        ls, rs = staged.pop(c) if c in staged else render_chunk(c)
        if ckpt_at <= c < ckpt_at + r_chunks:
            rerun[c] = (ls, rs)
        t0 = time.perf_counter()
        if c == ckpt_at:
            checkpoint.save_state(ckpt_path, vo.state)
        acc = step(vo, refiner, c, ls, rs)
        if acc is not None:
            verdicts.append(acc)
        if dev_w and c == dev_hi - 1:
            sync()
            device_s = time.perf_counter() - t_dev
            _log(t_start, f"device window: {dev_w * CH} frames in {device_s:.2f}s "
                 f"({dev_w * CH / device_s:.1f} frames/s)")
        if c in (0, n_chunks - 1) or c % 25 == 24:
            hw["n_points"] = max(hw["n_points"], int(vo.state.map.n_points))
            hw["obs_cursor"] = max(hw["obs_cursor"], int(vo.state.map.obs_cursor))
            compute_s += time.perf_counter() - t0
            if c % 25 == 24:
                _log(t_start, f"chunk {c + 1}/{n_chunks}: pts={hw['n_points']} "
                     f"obs_cursor={hw['obs_cursor']}")
        else:
            compute_s += time.perf_counter() - t0
    sync()

    n = 1 + n_chunks * CH
    est = vo.state.poses[:n].cpu().numpy()
    gt = seq.gt_poses[:n]
    traveled = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())
    ate = ate_rmse(est, gt)
    rpe_t, rpe_r = rpe(est, gt)

    # drift curve: unaligned position error and accumulated rotation error
    drift_curve = []
    for f in range(0, n, max(1, n // 12)):
        perr = float(np.linalg.norm(est[f, :3, 3] - gt[f, :3, 3]))
        Rerr = est[f, :3, :3] @ gt[f, :3, :3].T
        ang = float(np.degrees(np.arccos(np.clip((np.trace(Rerr) - 1) / 2, -1, 1))))
        drift_curve.append({"frame": f, "pos_err_m": round(perr, 2), "rot_err_deg": round(ang, 3)})

    mrows = vo.state.metrics[1:n].cpu().numpy()
    health = {
        "tracked_min": int(mrows[:, 0].min()),
        "tracked_p5": int(np.percentile(mrows[:, 0], 5)),
        "tracked_mean": round(float(mrows[:, 0].mean()), 1),
        "inlier_ratio_min": round(float(mrows[:, 1].min()), 3),
        "inlier_ratio_p5": round(float(np.percentile(mrows[:, 1], 5)), 3),
    }
    hw["n_points"] = max(hw["n_points"], int(vo.state.map.n_points))
    hw["obs_cursor"] = max(hw["obs_cursor"], int(vo.state.map.obs_cursor))
    kf_main = int(vo.state.kf_flags[:n].sum())
    _log(t_start, f"soak done: ATE {ate:.3f} m over {traveled:.0f} m, "
         f"{hw['n_points']} points, obs cursor {hw['obs_cursor']}")

    # resume equivalence: the mid-run checkpoint restored into a FRESH engine,
    # a few chunks re-run; the trajectory must equal the uninterrupted run's
    vo2 = engine()
    refiner2 = make_refiner(vo2)
    vo2.start(l0, r0)
    vo2.state = checkpoint.load_state(ckpt_path, vo2.state)
    tmp.cleanup()
    for c in range(ckpt_at, ckpt_at + r_chunks):
        step(vo2, refiner2, c, *rerun.pop(c))
    pool.shutdown()
    n_res = 1 + (ckpt_at + r_chunks) * CH
    # with refinement on, the main run's later refine calls adjust poses up
    # to one refine span behind the rerun's stopping point: that tail is left
    # out of the comparison (it is not nondeterminism)
    n_cmp = n_res - (36 if args.refine_every else 0)
    resume_err = float(np.abs(vo2.state.poses[:n_cmp].cpu().numpy() - est[:n_cmp]).max())
    kf_resume = 1 + int(vo2.state.kf_flags[1 + ckpt_at * CH:n_res].sum())
    _log(t_start, f"resume equivalence over {r_chunks} chunks: max |diff| {resume_err:.2e}")

    device = str(vo.device)
    if vo.device.type == "cuda":
        from svo_tpu_torch._measure import smi_line

        device = smi_line()
    ring = cfg.ba.ring_obs
    accepted = [bool(a) for a in verdicts]
    result = {
        "metric": "soak_kitti_scale",
        "frames": n,
        "image": f"{shape[0]}x{shape[1]}",
        "chunk": CH,
        "kf_cadence": args.cadence,
        "lk_engine": args.lk_engine,
        "device": device,
        "ate_m": round(ate, 4),
        "ate_pct_of_traveled": round(100.0 * ate / traveled, 3),
        "rpe_trans_m": round(rpe_t, 4),
        "rpe_rot_deg": round(float(np.degrees(rpe_r)), 4),
        "traveled_m": round(traveled, 1),
        "capacity": {
            "points_used": hw["n_points"],
            "points_capacity": cfg.capacity.max_points,
            "points_headroom_pct": round(100.0 * (1 - hw["n_points"] / cfg.capacity.max_points), 1),
            "obs_written": hw["obs_cursor"],
            "obs_ring": ring,
            "ring_wraps": hw["obs_cursor"] // ring,
            "frames_used": n,
            "frames_capacity": cfg.capacity.max_frames,
        },
        "resume": {
            "checkpoint_chunk": ckpt_at,
            "chunks_rerun": r_chunks,
            "max_pose_diff": resume_err,
            "equivalent": bool(resume_err < 1e-5),
        },
        "fps_excl_render": (n - 1) / compute_s if compute_s else None,
        "fps_device_sustained": dev_w * CH / device_s if device_s else None,
        "device_window_frames": dev_w * CH if device_s else 0,
        "finite": bool(np.isfinite(est).all()),
        "drift_curve": drift_curve,
        "health": health,
        "refine": {
            "every_chunks": args.refine_every,
            "reject_px": args.refine_reject,
            "joint_alt": args.joint_alt,
            "calls": len(accepted),
            "accepted": sum(accepted),
        } if args.refine_every else None,
        # the frame steps and keyframe steps (bootstraps included) of the
        # main run and the rerun together: what the kernels' launches follow
        "steps": {"frames": (n - 1) + r_chunks * CH, "keyframes": kf_main + kf_resume},
        "resolved_config": dataclasses.asdict(cfg),
    }
    return result, vo


def main(argv=None) -> int:
    args = parse_args(argv)
    result, _ = soak(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in ("metric", "frames", "ate_m", "ate_pct_of_traveled")}
                     | {"resume_ok": result["resume"]["equivalent"],
                        "ring_wraps": result["capacity"]["ring_wraps"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
