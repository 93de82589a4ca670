"""One process of the frontend strong-scaling measurement
(svo_tpu_torch/scaling_eff.py).

    python3 -m svo_tpu_torch.frontend_scaling_worker --rank R --nprocs 2 \
        --port PORT --backend gloo --device cpu --out fscale_R.json

The counterpart of scripts/frontend_scaling_worker.py. A fixed fleet of 2
VO streams (parallel/multi_seq.MultiStereoVO, svo_tpu's default KLT engine
"patches"): with --nprocs 1 one process holds both streams, with --nprocs 2
each process holds one. Stream s runs the 184x320 synthetic sequence of
seed 7 + s (rendered on every process, the same bytes) with PnP seed s. Per
frame step the only cross-process traffic is the fleet-health row of each
stream, all-gathered and folded in stream order. Start and 5 warm steps,
then the remaining --frames - 6 steps timed between synchronisations of
this process's devices. The JSON has svo_tpu's keys (rank, nprocs, wall_s,
frames_per_s_aggregate, steps, streams, health_finite) plus this process's
kernel launches by wrapper and its streams' keyframes (bootstraps
included), from which the launch rule follows; --arrays writes every
stream's trajectory (gathered, (2, frames, 4, 4)) as .npz.

It runs on the card unless --device cpu is given. --device is one device
for all of this process's streams, or a comma-separated list of one device
a stream (cuda:0,cuda:1); the first is where the streams' rows meet. NCCL
(--backend nccl, the default) needs one card a process; gloo lets
processes share a card. On the CPU it runs one thread.
"""

from __future__ import annotations

import argparse
import json
import time

STREAMS = 2
WARM = 6  # start and 5 warm steps, as svo_tpu's worker
SHAPE = (184, 320)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m svo_tpu_torch.frontend_scaling_worker")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--nprocs", type=int, required=True)
    p.add_argument("--port", type=int, required=True,
                   help="a free localhost port, the same for every process")
    p.add_argument("--out", required=True, help="JSON report")
    p.add_argument("--frames", type=int, default=31)
    p.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:N, cpu, or one device a stream, comma-separated")
    p.add_argument("--arrays", default="", help="every stream's trajectory as .npz")
    return p.parse_args(argv)


def fleet(frames: int):
    """(cfg, camera, lefts, rights): svo_tpu's worker's Config and camera,
    and each step's (STREAMS, H, W) frames, stream s from the sequence of
    seed 7 + s."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from svo_tpu_torch.config import Capacity, Config, RansacParams
    from svo_tpu_torch.geometry import camera as cam_mod
    from svo_tpu_torch.io.synthetic import SyntheticSequence

    cfg = Config(
        use_orb=False, image_height=SHAPE[0], image_width=SHAPE[1],
        capacity=Capacity(max_features=96, max_points=1 << 14, max_frames=256,
                          max_detections=128),
        ransac=RansacParams(num_hypotheses=64),
    )
    seqs = [SyntheticSequence(n_frames=frames, shape=SHAPE, fx=200.0, speed=0.3, seed=7 + s)
            for s in range(STREAMS)]
    camera = cam_mod.from_intrinsics(seqs[0].K[0, 0], seqs[0].K[1, 1], seqs[0].K[0, 2],
                                     seqs[0].K[1, 2], seqs[0].baseline)
    with ThreadPoolExecutor(len(os.sched_getaffinity(0))) as pool:  # numpy frees the GIL
        pairs = list(pool.map(lambda i: [sq.frame(i) for sq in seqs], range(frames)))
    lefts = [np.stack([np.clip(p[s][0], 0, 255) for s in range(STREAMS)]) for p in pairs]
    rights = [np.stack([np.clip(p[s][1], 0, 255) for s in range(STREAMS)]) for p in pairs]
    return cfg, camera, lefts, rights


def main(argv=None) -> int:
    args = parse_args(argv)
    import numpy as np
    import torch
    import torch.distributed as dist

    from svo_tpu_torch.ops.klt_patches import extract_klt_patches
    from svo_tpu_torch.ops.lk_fused import lk_track_level, lk_track_pyramid
    from svo_tpu_torch.ops.random import split_gumbel
    from svo_tpu_torch.parallel import multihost
    from svo_tpu_torch.parallel.multi_seq import MultiStereoVO
    from svo_tpu_torch.pipeline.odometry import resolve_device

    if STREAMS % args.nprocs:
        raise ValueError(f"{STREAMS} streams do not split over {args.nprocs} processes")
    if args.frames <= WARM:
        raise ValueError(f"--frames must exceed the {WARM} warm frames")
    k = STREAMS // args.nprocs
    names = args.device.split(",")
    if len(names) not in (1, k):
        raise ValueError(f"--device names {len(names)} devices for {k} streams")
    devices = [resolve_device(d) for d in (names * k if len(names) == 1 else names)]
    if devices[0].type == "cuda":
        torch.cuda.set_device(devices[0].index or 0)  # NCCL gathers on the current card
    else:
        torch.set_num_threads(1)  # one pinned core a process

    cfg, camera, lefts, rights = fleet(args.frames)  # the same bytes on every process

    multihost.init(f"localhost:{args.port}", args.nprocs, args.rank, args.backend)
    try:
        vo = MultiStereoVO(cfg, camera, n_streams=STREAMS, devices=devices, device=devices[0])

        def sync():
            for d in set(devices):
                if d.type == "cuda":
                    torch.cuda.synchronize(d)

        vo.start(lefts[0], rights[0])
        for i in range(1, WARM):
            vo.process(lefts[i], rights[i])
        sync()
        t0 = time.perf_counter()
        for i in range(WARM, args.frames):
            vo.process(lefts[i], rights[i])
        sync()
        wall = time.perf_counter() - t0
        n_steps = args.frames - WARM
        trajs = vo.trajectories(args.frames)
        out = {
            "rank": args.rank,
            "nprocs": args.nprocs,
            "wall_s": wall,
            "frames_per_s_aggregate": STREAMS * n_steps / wall,
            "steps": n_steps,
            "streams": STREAMS,
            "health_finite": bool(np.isfinite(vo.fleet_health).all()),
            "frames": args.frames,
            "backend": args.backend,
            "devices": [str(d) for d in devices],
            "keyframes": [int(s.state.kf_flags[:args.frames].sum()) for s in vo.streams],
            "launches": {
                "klt_patches": extract_klt_patches.launches,
                "lk_level": lk_track_level.launches + lk_track_pyramid.launches,
                "threefry": split_gumbel.launches,
            },
        }
        if args.arrays:
            np.savez(args.arrays, trajectories=trajs)
        with open(args.out, "w") as f:
            json.dump(out, f)
        print(f"rank {args.rank}/{args.nprocs} on {out['devices']}: "
              f"{out['frames_per_s_aggregate']:.2f} frames/s aggregate", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
