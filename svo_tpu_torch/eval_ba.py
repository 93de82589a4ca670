"""Back-end evaluation: does the global refinement improve a long drifting
trajectory?

    python3 -m svo_tpu_torch.eval_ba [--frames 505] [--small] [--chunk 12]
        [--cadence 6] [--blocks 4] [--cams-per-block 7]
        [--device cuda|cpu] [--lk-engine fused|patches] [--out F]

The counterpart of scripts/eval_ba.py. The front-end runs over a long
synthetic sequence (StereoVO.run_chunked, speed 0.3; frames rendered in
threads), then
parallel/global_opt.refine_global (keyframe-block BA + pose-graph
consensus) is swept across the finished trajectory in consecutive spans of
block_span(blocks, cams_per_block) frames that share one frame, each
sweep's map and trajectory feeding the next, with the script's sizes (512
points, 2,048 observations, 10 BA and 8 pose-graph iterations). It prints
the script's line, ATE before and after and as % of the distance; --out
writes the same numbers as JSON. It runs on the card unless --device cpu
is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SWEEP = dict(n_points=512, n_obs=2048, ba_iterations=10, pg_iterations=8)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m svo_tpu_torch.eval_ba")
    p.add_argument("--small", action="store_true", help="184x320 images, fx 200")
    p.add_argument("--frames", type=int, default=505)
    p.add_argument("--chunk", type=int, default=12)
    p.add_argument("--cadence", type=int, default=6)
    p.add_argument("--blocks", type=int, default=4)
    p.add_argument("--cams-per-block", type=int, default=7)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--lk-engine", default="fused", choices=("patches", "fused"))
    p.add_argument("--out", default="", help="write the result JSON here")
    return p.parse_args(argv)


def schedule(n: int, blocks: int, cams_per_block: int) -> list[int]:
    """The last frame of each sweep: every span - 1 frames, then n - 1."""
    from svo_tpu_torch.parallel.global_opt import block_span

    span = block_span(blocks, cams_per_block)
    his = list(range(span - 1, n, span - 1))
    if his and his[-1] != n - 1:
        his.append(n - 1)
    return his


def sweep(mp, poses, camera, his, blocks: int, cams_per_block: int):
    """refine_global over each frame_hi in his, each sweep's map and poses
    feeding the next. Returns the final map, poses and one (accepted,
    cost_per_obs) a sweep."""
    import torch

    from svo_tpu_torch.parallel import global_opt

    bfx = camera.K[0, 0] * camera.baseline
    verdicts = []
    for hi in his:
        out = global_opt.refine_global(
            mp, poses, torch.tensor(hi, dtype=torch.int32, device=poses.device), camera.K, bfx,
            n_blocks=blocks, cams_per_block=cams_per_block, **SWEEP,
        )
        mp, poses = out.map, out.poses
        verdicts.append((out.accepted, out.cost_per_obs))
    return mp, poses, [(bool(a), float(c)) for a, c in verdicts]


def evaluate(args: argparse.Namespace, frames=None, seq=None):
    """The run and the sweep; returns (result dict, the engine). frames
    (a list of (i, left, right)) and seq (its SyntheticSequence) may be
    given, else args.frames frames are rendered."""
    import torch

    from svo_tpu_torch.config import Config
    from svo_tpu_torch.eval.trajectory import ate_rmse
    from svo_tpu_torch.geometry import camera as cam_mod
    from svo_tpu_torch.io.synthetic import SyntheticSequence
    from svo_tpu_torch.pipeline.odometry import StereoVO, resolve_device

    resolve_device(args.device)  # before the rendering: no card, no run
    t0 = time.perf_counter()
    if frames is None:
        shape, fx = ((184, 320), 200.0) if args.small else ((376, 1241), 718.856)
        print(f"rendering {args.frames} frames...", file=sys.stderr, flush=True)
        seq = SyntheticSequence(n_frames=args.frames, shape=shape, fx=fx, speed=0.3)
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:  # numpy frees the GIL
            frames = [(i, *lr) for i, lr in enumerate(pool.map(seq.frame, range(args.frames)))]
        print(f"render done (+{time.perf_counter() - t0:.0f}s)", file=sys.stderr, flush=True)
    H, W = seq.shape
    cfg = Config(use_orb=False, image_height=H, image_width=W)
    camera = cam_mod.from_intrinsics(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2],
                                     seq.baseline)
    vo = StereoVO(cfg, camera, chunk=args.chunk, kf_cadence=args.cadence, device=args.device,
                  lk_engine=args.lk_engine)
    res = vo.run_chunked(frames)
    n = res.n_frames
    gt = seq.gt_poses[:n]
    ate_before = ate_rmse(res.poses, gt)
    print(f"VO done: {n} frames, {res.fps:.1f} fps", file=sys.stderr, flush=True)

    def sync():
        if vo.device.type == "cuda":
            torch.cuda.synchronize(vo.device)

    his = schedule(n, args.blocks, args.cams_per_block)
    sync()
    t1 = time.perf_counter()
    _, poses, verdicts = sweep(vo.state.map, vo.state.poses, vo.camera, his, args.blocks,
                               args.cams_per_block)
    sync()
    wall = time.perf_counter() - t1
    refined = poses[:n].cpu().numpy()
    ate_after = ate_rmse(refined, gt)
    traveled = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())
    device = str(vo.device)
    if vo.device.type == "cuda":
        from svo_tpu_torch._measure import smi_line

        device = smi_line()
    result = {
        "metric": "ba_sweep_ate",
        "frames": n,
        "image": f"{H}x{W}",
        "traveled_m": traveled,
        "ate_before_m": ate_before,
        "ate_after_m": ate_after,
        "ate_before_pct": 100 * ate_before / traveled,
        "ate_after_pct": 100 * ate_after / traveled,
        "sweeps": len(his),
        "his": his,
        "accepted": [a for a, _ in verdicts],
        "cost_per_obs": [c for _, c in verdicts],
        "block_lm_iters": len(his) * args.blocks * SWEEP["ba_iterations"],
        "sweep_wall_s": wall,
        "finite": bool(np.isfinite(refined).all()),
        "vo_fps": res.fps,
        "chunk": args.chunk,
        "kf_cadence": args.cadence,
        "lk_engine": args.lk_engine,
        "device": device,
        "steps": {"frames": n - 1, "keyframes": int(res.kf_flags.sum())},
        "wall_s": time.perf_counter() - t0,
    }
    return result, vo


def summary_line(r: dict) -> str:
    return (f"frames {r['frames']} | traveled {r['traveled_m']:.1f} m | "
            f"ATE {r['ate_before_m']:.4f} m -> {r['ate_after_m']:.4f} m "
            f"({r['ate_before_pct']:.2f}% -> {r['ate_after_pct']:.2f}%) | "
            f"{r['sweeps']} refine sweeps, {r['block_lm_iters']} block-LM iters in "
            f"{r['sweep_wall_s']:.1f}s")


def main(argv=None) -> int:
    args = parse_args(argv)
    result, _ = evaluate(args)
    print(summary_line(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
