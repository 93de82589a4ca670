"""Fleet evaluation: a per-sequence ATE/RPE table.

    python3 -m svo_tpu_torch.eval_fleet                       # synthetic fleet
    python3 -m svo_tpu_torch.eval_fleet --kitti <root> --seqs 00,01,02
    python3 -m svo_tpu_torch.eval_fleet --small --device cpu  # quick run
        [--frames N] [--chunk 12] [--cadence 6] [--lk-engine fused|patches]
        [--out F]

The counterpart of scripts/eval_fleet.py. With a KITTI odometry root
(--kitti, holding sequences/<NN>/ and poses/<NN>.txt) it evaluates the
requested sequences, read through io/kitti.py at their own image size;
without one, a fleet of synthetic sequences, sequence i with seed i and
speed 0.25 + 0.03 i, 97 frames at 376x1241 (49 at 184x320 with fx 200
under --small), so that the harness always runs. BASELINE.json's
configurations name KITTI sequences 00-10; this is their table the moment
the data is there. Each sequence runs through StereoVO.run_chunked, cut to
1 + chunk * k frames (--frames caps it first). A row has the script's
keys; the table prints as it goes, then the mean ATE as % of the distance.
It runs on the card unless --device cpu is given; --out writes the rows
with the device.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m svo_tpu_torch.eval_fleet")
    p.add_argument("--kitti", default="", help="KITTI odometry root (dataset/)")
    p.add_argument("--seqs", default="00,01,02,03,04,05,06,07,08,09,10")
    p.add_argument("--small", action="store_true", help="small synthetic images")
    p.add_argument("--frames", type=int, default=0, help="cap frames per sequence")
    p.add_argument("--chunk", type=int, default=12)
    p.add_argument("--cadence", type=int, default=6)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--lk-engine", default="fused", choices=("patches", "fused"))
    p.add_argument("--out", default="", help="write the table as JSON")
    return p.parse_args(argv)


def run_sequence(args, name, frames, camera, gt, shape):
    """One row: the sequence through StereoVO.run_chunked. Returns the row
    and the engine."""
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.eval.trajectory import ate_rmse, rpe
    from svo_tpu_torch.pipeline.odometry import StereoVO

    cfg = Config(use_orb=False, image_height=shape[0], image_width=shape[1])
    if args.chunk:
        frames = frames[:1 + ((len(frames) - 1) // args.chunk) * args.chunk]
    vo = StereoVO(cfg, camera, chunk=args.chunk, kf_cadence=args.cadence, device=args.device,
                  lk_engine=args.lk_engine)
    t0 = time.perf_counter()
    res = vo.run_chunked(frames)
    wall = time.perf_counter() - t0
    gt = gt[: res.n_frames]
    ate = ate_rmse(res.poses, gt)
    t_err, r_err = rpe(res.poses, gt)
    traveled = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())
    row = {
        "seq": name,
        "frames": res.n_frames,
        "ate_m": ate,
        "ate_pct": 100 * ate / max(traveled, 1e-9),
        "rpe_t_m": t_err,
        "rpe_r_deg": r_err,
        "traveled_m": traveled,
        "fps_incl_compile": (res.n_frames - 1) / wall,
        "finite": bool(np.isfinite(res.poses).all()),
        "keyframes": int(res.kf_flags.sum()),
    }
    print(f"{name:>9s} | {row['frames']:5d} fr | ATE {ate:7.3f} m ({row['ate_pct']:5.2f}%) | "
          f"RPE {t_err:.3f} m / {r_err:.3f} deg | {row['fps_incl_compile']:6.1f} fps", flush=True)
    return row, vo


def _u8(img):
    return np.clip(img, 0, 255).astype(np.uint8)


def evaluate(args: argparse.Namespace):
    """The table; returns (result dict with the rows, the last engine)."""
    from svo_tpu_torch.geometry import camera as cam_mod
    from svo_tpu_torch.pipeline.odometry import resolve_device

    resolve_device(args.device)
    rows, vo = [], None
    seqs = [s.strip() for s in args.seqs.split(",") if s.strip()]
    if args.kitti:
        from svo_tpu_torch.geometry.camera import parse_kitti_calib
        from svo_tpu_torch.io import kitti

        for s in seqs:
            seq_dir = os.path.join(args.kitti, "sequences", s)
            if not os.path.isdir(seq_dir):
                print(f"{s:>9s} | missing ({seq_dir})", flush=True)
                continue
            camera = parse_kitti_calib(os.path.join(seq_dir, "calib.txt"))
            gt = kitti.parse_ground_truth(os.path.join(args.kitti, "poses", f"{s}.txt"))
            frames = list(kitti.SequenceReader(seq_dir, 0, args.frames or None))
            row, vo = run_sequence(args, s, frames, camera, gt, frames[0][1].shape)
            rows.append(row)
    else:
        from concurrent.futures import ThreadPoolExecutor

        from svo_tpu_torch.io.synthetic import SyntheticSequence

        shape = (184, 320) if args.small else (376, 1241)
        n = args.frames or (49 if args.small else 97)
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:  # numpy frees the GIL
            for i, s in enumerate(seqs):
                seq = SyntheticSequence(n_frames=n, shape=shape,
                                        fx=200.0 if args.small else 718.856,
                                        seed=i, speed=0.25 + 0.03 * i)
                camera = cam_mod.from_intrinsics(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2],
                                                 seq.K[1, 2], seq.baseline)
                frames = [(j, _u8(lr[0]), _u8(lr[1]))
                          for j, lr in enumerate(pool.map(seq.frame, range(n)))]
                row, vo = run_sequence(args, f"synth-{s}", frames, camera, seq.gt_poses, shape)
                rows.append(row)
    mean_pct = float(np.mean([r["ate_pct"] for r in rows])) if rows else None
    if rows:
        print(f"{'mean':>9s} | ATE {mean_pct:.2f}% of distance traveled", flush=True)
    device = args.device
    if device.startswith("cuda"):
        from svo_tpu_torch._measure import smi_line

        device = smi_line()
    result = {
        "metric": "fleet_ate",
        "source": "kitti" if args.kitti else ("synthetic-small" if args.small else "synthetic"),
        "chunk": args.chunk,
        "kf_cadence": args.cadence,
        "lk_engine": args.lk_engine,
        "device": device,
        "mean_ate_pct": mean_pct,
        "rows": rows,
    }
    return result, vo


def main(argv=None) -> int:
    args = parse_args(argv)
    result, _ = evaluate(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
