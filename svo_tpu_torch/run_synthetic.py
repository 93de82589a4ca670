"""Run the port's VO pipeline end to end on a synthetic stereo sequence and
report ATE/RPE against its exact ground truth, and throughput.

    python3 -m svo_tpu_torch.run_synthetic [--frames N] [--small] [--fast]
        [--ba] [--chunk K --cadence C] [--device cuda|cpu]
        [--lk-engine patches|fused] [--seed S] [--out-json F]

The counterpart of examples/run_synthetic.py. The shipping configuration
(Config(), the ORB detector) at 376x1241, or 184x320 with --small; --fast
picks the FAST detector. It runs on the card unless --device cpu is
given, and raises without one. --out-json writes one JSON line of the
numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m svo_tpu_torch.run_synthetic")
    p.add_argument("--frames", type=int, default=40)
    p.add_argument("--small", action="store_true", help="184x320 images for fast iteration")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--fast", action="store_true", help="FAST detector instead of ORB")
    p.add_argument("--ba", action="store_true", help="enable sliding-window bundle adjustment")
    p.add_argument("--chunk", type=int, default=0, help="frames per chunked step")
    p.add_argument("--cadence", type=int, default=0,
                   help="static keyframe cadence for the chunked path "
                        "(0 = the reference's dynamic rule)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--lk-engine", default="patches", choices=("patches", "fused"))
    p.add_argument("--seed", type=int, default=0, help="seed of the PnP sampling")
    p.add_argument("--out-json", default="", help="write the summary as one JSON line")
    return p.parse_args(argv)


def render(seq) -> list:
    """Every frame of a SyntheticSequence as (idx, left, right), rendered
    in threads (numpy releases the GIL)."""
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        return [(i, *lr) for i, lr in enumerate(pool.map(seq.frame, range(seq.n_frames)))]


def main(argv=None) -> int:
    args = parse_args(argv)

    from svo_tpu_torch.config import BaParams, Config
    from svo_tpu_torch.eval.trajectory import ate_rmse, rpe
    from svo_tpu_torch.geometry import camera as cam_mod
    from svo_tpu_torch.io.synthetic import SyntheticSequence
    from svo_tpu_torch.pipeline.odometry import StereoVO

    shape = (184, 320) if args.small else (376, 1241)
    fx = 200.0 if args.small else 718.856
    t0 = time.time()
    seq = SyntheticSequence(n_frames=args.frames, shape=shape, fx=fx)
    frames = render(seq)
    print(f"rendered {len(frames)} synthetic frames in {time.time() - t0:.1f}s", flush=True)

    cfg = Config(
        use_orb=not args.fast,
        image_height=shape[0],
        image_width=shape[1],
        end_frame=args.frames,
        ba=BaParams(enabled=args.ba),
    )
    camera = cam_mod.from_intrinsics(
        seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline
    )
    vo = StereoVO(cfg, camera, seed=args.seed, chunk=args.chunk, kf_cadence=args.cadence,
                  device=args.device, lk_engine=args.lk_engine)
    t0 = time.time()
    if args.chunk:
        res = vo.run_chunked(frames)
    else:
        res = vo.run(frames, verbose=args.verbose)
    wall = time.time() - t0

    gt = seq.gt_poses[: res.n_frames]
    ate = ate_rmse(res.poses, gt)
    rpe_t, rpe_r = rpe(res.poses, gt)
    traveled = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())
    summary = {
        "frames": res.n_frames,
        "shape": list(shape),
        "detector": "fast" if args.fast else "orb",
        "device": str(vo.device),
        "lk_engine": args.lk_engine,
        "chunk": args.chunk,
        "cadence": args.cadence,
        "ate_m": float(ate),
        "traveled_m": traveled,
        "rpe_m": float(rpe_t),
        "rpe_deg": float(np.rad2deg(rpe_r)),
        "fps": float(res.fps),
        "wall_s": wall,
        "keyframes": int(res.kf_flags.sum()),
        "map_points": int(res.metrics[-1, 4]),
        "mean_features": float(res.metrics[1:, 2].mean()),
        "mean_inlier_ratio": float(res.metrics[1:, 1].mean()),
        "finite": bool(np.isfinite(res.poses).all()),
    }
    print(f"frames:        {res.n_frames}")
    print(f"wall:          {wall:.2f}s  ({res.fps:.2f} fps on {vo.device})")
    print(f"ATE RMSE:      {ate:.4f} m over {traveled:.1f} m traveled")
    print(f"RPE:           {rpe_t:.4f} m / {np.rad2deg(rpe_r):.4f} deg per frame")
    print(f"map points:    {summary['map_points']}")
    print(f"keyframes:     {summary['keyframes']}")
    print(f"mean features: {summary['mean_features']:.1f}")
    print(f"mean inlier%:  {summary['mean_inlier_ratio'] * 100:.1f}")
    if args.out_json:
        with open(args.out_json, "w") as f:
            f.write(json.dumps(summary) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
