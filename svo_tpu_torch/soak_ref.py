"""The reference CPU pipeline over the soak's long sequence: its drift.

    python3 -m svo_tpu_torch.soak_ref [--frames 1201] [--out F]

The counterpart of scripts/soak_ref.py. It runs the reference-equivalent
OpenCV pipeline (eval/reference_cpu.py, Config(use_orb=False)) over the
same synthetic sequence as the soak (376x1241, fx 718.856, speed 0.3,
seed 7) and records its drift: the baseline the soak's ATE is judged
against (the reference has no back-end either, so both accumulate
open-loop VO drift). The OpenCV pipeline runs on the host by nature, so
this tool has no --device: it needs neither a card nor the port's
kernels. Frames are rendered 12 at a time in threads and fed as float32,
as svo_tpu's script feeds them when it finds no frame cache (its cache,
scripts/render_cache.py, holds uint8 frames and is not ported). The
result has the keys and the rounding of svo_tpu's SOAK_REF_r05.json; fps
counts the pipeline's processing time only, not the rendering. --out
writes it, and one summary line is printed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SHAPE = (376, 1241)
RENDER_BATCH = 12  # frames rendered together, in threads


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m svo_tpu_torch.soak_ref")
    p.add_argument("--frames", type=int, default=1201)
    p.add_argument("--out", default="", help="write the result JSON here")
    return p.parse_args(argv)


def soak_ref(args: argparse.Namespace) -> dict:
    """Run the reference pipeline over the sequence; returns the result dict."""
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.eval.reference_cpu import ReferenceCpuPipeline
    from svo_tpu_torch.eval.trajectory import ate_rmse, rpe
    from svo_tpu_torch.geometry import camera as cam_mod
    from svo_tpu_torch.io.synthetic import SyntheticSequence

    t_start = time.perf_counter()
    seq = SyntheticSequence(n_frames=args.frames, shape=SHAPE, fx=718.856, speed=0.3)
    cfg = Config(use_orb=False, image_height=SHAPE[0], image_width=SHAPE[1])
    camera = cam_mod.from_intrinsics(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2],
                                     seq.baseline)
    ref = ReferenceCpuPipeline(cfg, camera.K.numpy(), camera.P_left.numpy(),
                               camera.P_right.numpy())
    proc_s = 0.0
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:  # numpy frees the GIL
        for b in range(0, args.frames, RENDER_BATCH):
            idx = range(b, min(b + RENDER_BATCH, args.frames))
            for i, (l, r) in zip(idx, pool.map(seq.frame, idx)):
                t0 = time.perf_counter()
                ref.process(l.astype(np.float32), r.astype(np.float32))
                proc_s += time.perf_counter() - t0
                if i % 200 == 199:
                    print(f"[ref-soak +{time.perf_counter() - t_start:7.1f}s] frame {i + 1}/"
                          f"{args.frames}", file=sys.stderr, flush=True)

    est = np.stack(ref.poses)
    gt = seq.gt_poses[: len(est)]
    traveled = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())
    ate = ate_rmse(est, gt)
    rpe_t, rpe_r = rpe(est, gt)
    n = len(est)
    drift_curve = []
    for f in range(0, n, max(1, n // 12)):
        perr = float(np.linalg.norm(est[f, :3, 3] - gt[f, :3, 3]))
        Rerr = est[f, :3, :3] @ gt[f, :3, :3].T
        ang = float(np.degrees(np.arccos(np.clip((np.trace(Rerr) - 1) / 2, -1, 1))))
        drift_curve.append({"frame": f, "pos_err_m": round(perr, 2), "rot_err_deg": round(ang, 3)})
    return {
        "metric": "soak_reference_cpu",
        "frames": n,
        "ate_m": round(ate, 4),
        "ate_pct_of_traveled": round(100.0 * ate / traveled, 3),
        "rpe_trans_m": round(rpe_t, 4),
        "rpe_rot_deg": round(float(np.degrees(rpe_r)), 4),
        "traveled_m": round(traveled, 1),
        "fps": round(n / proc_s, 2),
        "drift_curve": drift_curve,
        "finite": bool(np.isfinite(est).all()),
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    result = soak_ref(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in
                      ("metric", "frames", "ate_m", "ate_pct_of_traveled", "fps")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
