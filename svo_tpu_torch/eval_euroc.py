"""EuRoC sequence-level evaluation artifact.

    python3 -m svo_tpu_torch.eval_euroc [--root <sequence dir>] [--start N]
        [--end N] [--device cuda|cpu] [--lk-engine fused|patches] [--out F]

The counterpart of scripts/eval_euroc.py. It runs the ASL-layout pipeline
end to end: the sensor.yaml files (PyYAML), rectification
(io/euroc.py, in numpy), StereoVO.run frame by frame with the FAST
detector (Config(use_orb=False)), ground truth matched by timestamp. The
root defaults to the checked-in tests/fixtures/euroc_mini (40 synthetic,
unrectified and radtan-distorted pairs); pass --root for a real EuRoC
sequence directory. The result has the keys of svo_tpu's EUROC_r05.json
(numbers unrounded; "backend" is the torch device type), plus the device;
--out writes it, and one summary line is printed. It runs on the card
unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EUROC_MINI = os.path.join(REPO, "tests", "fixtures", "euroc_mini")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m svo_tpu_torch.eval_euroc")
    p.add_argument("--root", default=EUROC_MINI, help="EuRoC sequence dir (contains mav0/)")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--lk-engine", default="fused", choices=("patches", "fused"))
    p.add_argument("--out", default="", help="write the result JSON here")
    return p.parse_args(argv)


def evaluate(args: argparse.Namespace):
    """The run; returns (result dict, the engine)."""
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.eval.trajectory import ate_rmse, rpe
    from svo_tpu_torch.io.euroc import EurocSequence
    from svo_tpu_torch.pipeline.odometry import StereoVO, resolve_device

    resolve_device(args.device)  # before the sequence is read: no card, no run
    seq = EurocSequence(args.root, args.start, args.end)
    H, W = seq.rectifier.size
    cfg = Config(use_orb=False, image_height=H, image_width=W)
    vo = StereoVO(cfg, seq.camera, device=args.device, lk_engine=args.lk_engine)
    frames = list(iter(seq))
    t0 = time.perf_counter()
    res = vo.run(frames)
    wall = time.perf_counter() - t0

    gt = seq.gt_cam_poses()
    n = min(res.n_frames, len(gt))
    traveled = float(np.linalg.norm(np.diff(gt[:n, :3, 3], axis=0), axis=1).sum())
    ate = ate_rmse(res.poses[:n], gt[:n])
    rpe_t, rpe_r = rpe(res.poses[:n], gt[:n])
    device = str(vo.device)
    if vo.device.type == "cuda":
        from svo_tpu_torch._measure import smi_line

        device = smi_line()
    result = {
        "metric": "euroc_ate",
        "root": os.path.basename(os.path.abspath(args.root)),
        "frames": int(res.n_frames),
        "image": f"{H}x{W}",
        "rectified_baseline_m": float(seq.rectifier.baseline),
        "ate_m": ate,
        "ate_pct_of_traveled": 100.0 * ate / max(traveled, 1e-9),
        "traveled_m": traveled,
        "rpe_trans_m": float(rpe_t),
        "rpe_rot_deg": float(np.rad2deg(rpe_r)),
        "fps_incl_compile": res.fps,
        "mean_inlier_ratio": float(res.metrics[1:n, 1].mean()),
        "mean_features": float(res.metrics[1:n, 2].mean()),
        "keyframes": int(res.kf_flags[:n].sum()),
        "backend": vo.device.type,
        "lk_engine": args.lk_engine,
        "device": device,
        "finite": bool(np.isfinite(res.poses).all()),
        "wall_s": wall,
        "resolved_config": dataclasses.asdict(cfg),
    }
    return result, vo


def main(argv=None) -> int:
    args = parse_args(argv)
    result, _ = evaluate(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in ("metric", "frames", "ate_m", "ate_pct_of_traveled")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
