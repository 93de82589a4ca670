"""EuRoC MAV runner of the port: ASL sequence -> rectified stereo VO ->
ATE/RPE against the ground truth.

    python3 -m svo_tpu_torch.run_euroc --root MH_01_easy [--ba] [--fast]
        [--start N] [--end N] [--out traj.txt] [--plot traj.png]
        [--device cuda|cpu] [--lk-engine patches|fused]

The counterpart of examples/run_euroc.py (--cpu becomes --device). The
sensor.yaml files need PyYAML; --plot needs matplotlib. It runs on the
card unless --device cpu is given, and raises without one.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m svo_tpu_torch.run_euroc")
    p.add_argument("--root", required=True, help="EuRoC sequence dir (contains mav0/)")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=None)
    p.add_argument("--ba", action="store_true")
    p.add_argument("--fast", action="store_true", help="FAST detector (default ORB)")
    p.add_argument("--out", default="", help="write estimated trajectory (KITTI format)")
    p.add_argument("--plot", default="", help="write top-down trajectory PNG (needs matplotlib)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--lk-engine", default="patches", choices=("patches", "fused"))
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from svo_tpu_torch.config import BaParams, Config
    from svo_tpu_torch.eval.trajectory import ate_rmse, rpe
    from svo_tpu_torch.io.euroc import EurocSequence
    from svo_tpu_torch.pipeline.odometry import StereoVO
    from svo_tpu_torch.viz import dump

    seq = EurocSequence(args.root, args.start, args.end)
    H, W = seq.rectifier.size
    cfg = Config(
        use_orb=not args.fast,
        image_height=H,
        image_width=W,
        ba=BaParams(enabled=args.ba),
    )
    vo = StereoVO(cfg, seq.camera, device=args.device, lk_engine=args.lk_engine)
    t0 = time.time()
    res = vo.run(seq)
    wall = time.time() - t0

    print(f"frames:       {res.n_frames}")
    print(f"wall:         {wall:.2f}s  ({res.fps:.2f} fps on {vo.device})")
    print(f"map points:   {int(res.metrics[-1, 4])}")
    print(f"keyframes:    {int(res.kf_flags.sum())}")
    print(f"mean feats:   {res.metrics[1:, 2].mean():.1f}")
    print(f"mean inlier%: {res.metrics[1:, 1].mean() * 100:.1f}")

    gt = seq.gt_cam_poses()
    if len(gt):
        n = min(res.n_frames, len(gt))
        rpe_t, rpe_r = rpe(res.poses[:n], gt[:n])
        print(f"ATE RMSE:     {ate_rmse(res.poses[:n], gt[:n]):.4f} m")
        print(f"RPE:          {rpe_t:.4f} m / {np.rad2deg(rpe_r):.4f} deg per frame")
    if args.out:
        dump.save_trajectory_kitti(args.out, res.poses)
        print(f"trajectory -> {args.out}")
    if args.plot:
        dump.plot_trajectory(args.plot, res.poses, gt if len(gt) else None)
        print(f"plot -> {args.plot}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
