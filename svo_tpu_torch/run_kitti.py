"""KITTI odometry runner of the port: calibration, frames, the pipeline on
the card, trajectory and metric outputs.

    python3 -m svo_tpu_torch.run_kitti --config configs/kitti00.yaml
    python3 -m svo_tpu_torch.run_kitti --path <seq_dir> --calib <calib.txt> \\
        --gt <poses.txt> [--ba] [--chunk 12 [--cadence 6]] [--refine] \\
        [--out traj.txt] [--ply map.ply] [--metrics-out m.jsonl] [--plot t.png] \\
        [--device cuda|cpu] [--lk-engine patches|fused]

The counterpart of examples/run_kitti.py, with the same arguments (--cpu
becomes --device). The detector is Config()'s ORB unless --fast is given.
--config reads a YAML file and needs PyYAML. Frames come from the native
prefetcher (svo_tpu_torch/runtime/loader.py) where it can be built, else
from io.kitti.SequenceReader. --refine sweeps the global refinement
(keyframe-block BA and pose-graph consensus) over the finished trajectory
span by span. It runs on the card unless --device cpu is given, and raises
without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m svo_tpu_torch.run_kitti")
    p.add_argument("--config", help="YAML config (reference format accepted; needs PyYAML)")
    p.add_argument("--path", help="sequence dir containing image_2/ image_3/")
    p.add_argument("--calib", help="KITTI calib.txt (P2/P3)")
    p.add_argument("--gt", help="ground-truth poses txt", default="")
    p.add_argument("--start", type=int, default=None)
    p.add_argument("--end", type=int, default=None)
    p.add_argument("--ba", action="store_true", help="enable windowed BA")
    p.add_argument("--refine", action="store_true",
                   help="global refinement sweep (keyframe-block BA + pose-graph "
                        "consensus) over the finished trajectory")
    p.add_argument("--refine-blocks", type=int, default=4)
    p.add_argument("--refine-cams", type=int, default=7, help="cameras per refinement block")
    p.add_argument("--fast", action="store_true", help="FAST detector (default ORB)")
    p.add_argument("--chunk", type=int, default=0, help="frames per chunked step")
    p.add_argument("--cadence", type=int, default=0,
                   help="static keyframe cadence for the chunked path "
                        "(0 = the reference's dynamic rule)")
    p.add_argument("--out", default="", help="write estimated trajectory (KITTI format)")
    p.add_argument("--ply", default="", help="dump map point cloud to PLY")
    p.add_argument("--metrics-out", default="", help="write per-frame JSONL + summary")
    p.add_argument("--plot", default="", help="write top-down trajectory PNG (needs matplotlib)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--lk-engine", default="patches", choices=("patches", "fused"))
    p.add_argument("--verbose", action="store_true")
    return p.parse_args(argv)


def refine_sweep(vo, n: int, n_blocks: int, cams_per_block: int):
    """The global refiner over frames [0, n) in consecutive spans that
    share one frame, each span's refined map and trajectory feeding the
    next. Returns the refined (n, 4, 4) poses, the number of sweeps and the
    number accepted. The refiner is built once with the engine's graph: on
    the card each sweep replays, and the map and trajectory it hands to the
    next are its own buffers, not copied in again."""
    import torch

    from svo_tpu_torch.parallel import global_opt

    cam = vo.camera
    refine = global_opt.make_refine_global(cam.K, cam.K[0, 0] * cam.baseline, graph=vo.graph,
                                           n_blocks=n_blocks, cams_per_block=cams_per_block)
    span = global_opt.block_span(n_blocks, cams_per_block)
    his = list(range(span - 1, n, span - 1)) or [n - 1]
    if his[-1] != n - 1:
        his.append(n - 1)
    mp, poses = vo.state.map, vo.state.poses
    n_acc = 0
    for hi in his:
        out = refine(mp, poses, torch.tensor(hi, dtype=torch.int32, device=vo.device))
        mp, poses = out.map, out.poses
        n_acc += int(out.accepted)
    return poses[:n].cpu().numpy().astype(np.float64), len(his), n_acc


def main(argv=None) -> int:
    args = parse_args(argv)

    from svo_tpu_torch.config import BaParams, Config, load_config
    from svo_tpu_torch.eval.trajectory import ate_rmse, rpe
    from svo_tpu_torch.geometry.camera import parse_kitti_calib
    from svo_tpu_torch.io import kitti
    from svo_tpu_torch.pipeline.odometry import StereoVO
    from svo_tpu_torch.runtime import loader as native_loader
    from svo_tpu_torch.utils import metrics as metrics_mod
    from svo_tpu_torch.viz import dump

    cfg = load_config(args.config) if args.config else Config()
    updates = {}
    if args.path:
        updates["path"] = args.path
    if args.calib:
        updates["calib_path"] = args.calib
    if args.gt:
        updates["gt_path"] = args.gt
    if args.start is not None:
        updates["start_frame"] = args.start
    if args.end is not None:
        updates["end_frame"] = args.end
    if args.fast:
        updates["use_orb"] = False
    if args.ba:
        updates["ba"] = BaParams(enabled=True)
    cfg = dataclasses.replace(cfg, **updates)

    camera = parse_kitti_calib(cfg.calib_path)
    gt = kitti.parse_ground_truth(cfg.gt_path) if cfg.gt_path else np.zeros((0, 4, 4))

    H, W = cfg.image_height, cfg.image_width
    if native_loader.available():
        frames = native_loader.AsyncStereoLoader(
            cfg.path, cfg.start_frame, cfg.end_frame, H, W, threads=2
        )
        reader = "native prefetcher"
    else:
        frames = kitti.SequenceReader(cfg.path, cfg.start_frame, cfg.end_frame)
        reader = f"SequenceReader ({native_loader.unavailable_reason().splitlines()[0]})"
    print(f"frames:       {reader}", flush=True)

    vo = StereoVO(cfg, camera, chunk=args.chunk, kf_cadence=args.cadence,
                  device=args.device, lk_engine=args.lk_engine)
    t0 = time.time()
    if args.chunk:
        res = vo.run_chunked(list(frames))
    else:
        res = vo.run(frames, verbose=args.verbose)
    wall = time.time() - t0
    n = res.n_frames
    gt_run = gt[cfg.start_frame : cfg.start_frame + n]

    if args.refine:
        t_r = time.time()
        refined, n_sweeps, n_acc = refine_sweep(vo, n, args.refine_blocks, args.refine_cams)
        print(f"refine:       {n_sweeps} sweeps ({n_acc} accepted) over "
              f"{n} frames in {time.time() - t_r:.2f}s")
        if len(gt):
            print(f"refine ATE:   {ate_rmse(res.poses, gt_run):.4f} m -> "
                  f"{ate_rmse(refined, gt_run):.4f} m")
        res.poses = refined

    print(f"frames:       {n}")
    print(f"wall:         {wall:.2f}s  ({res.fps:.2f} fps on {vo.device})")
    print(f"map points:   {int(res.metrics[-1, 4])}")
    print(f"keyframes:    {int(res.kf_flags.sum())}")
    print(f"mean feats:   {res.metrics[1:, 2].mean():.1f}")
    print(f"mean inlier%: {res.metrics[1:, 1].mean() * 100:.1f}")
    if len(gt):
        rpe_t, rpe_r = rpe(res.poses, gt_run)
        print(f"ATE RMSE:     {ate_rmse(res.poses, gt_run):.4f} m")
        print(f"RPE:          {rpe_t:.4f} m / {np.rad2deg(rpe_r):.4f} deg per frame")
    if args.out:
        dump.save_trajectory_kitti(args.out, res.poses)
        print(f"trajectory -> {args.out}")
    if args.ply and res.map_points is not None:
        dump.save_ply(args.ply, res.map_points)
        print(f"map -> {args.ply}")
    if args.metrics_out:
        metrics_mod.write_frame_records(args.metrics_out, res)
        with open(args.metrics_out + ".summary.json", "w") as f:
            json.dump(metrics_mod.summarize(res), f, indent=1)
        print(f"metrics -> {args.metrics_out} (+ .summary.json)")
    if args.plot:
        dump.plot_trajectory(args.plot, res.poses, gt if len(gt) else None)
        print(f"plot -> {args.plot}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
