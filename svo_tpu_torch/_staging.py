"""The frames of the chunk tools (bench_batched, time_chunk, profile_chunk).

S streams on one synthetic sequence (io/synthetic.py, corridor world, seed
7, fx 718.856 or, with --small, 184x320 at fx 200): stream s runs it
forward when s is even and reversed when s is odd (bench.py:185). The
first frame of each stream is kept as float32 for BatchedStereoVO.start;
every later frame is clipped to [0, 255] and cast to uint8, and the
chunks are staged on the device as (chunk, S, H, W) frame-major tensors,
as process_chunk takes them. Frames are rendered in threads (numpy frees
the GIL), and only those the staged chunks need.
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch


def add_args(p: argparse.ArgumentParser, frames: int, frames_help: str = "") -> None:
    """The arguments the three tools share (svo_tpu's scripts' own, plus
    --small and --device)."""
    p.add_argument("--streams", type=int, default=8)
    p.add_argument("--chunk", type=int, default=12)
    p.add_argument("--cadence", type=int, default=6)
    p.add_argument("--frames", type=int, default=frames, help=frames_help or None)
    p.add_argument("--small", action="store_true", help="184x320 images (the CPU tests' size)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


class Staged(NamedTuple):
    cfg: object            # Config(use_orb=False) at the frames' size
    camera: object
    l0: torch.Tensor       # (S, H, W) float32 first frames, on the device
    r0: torch.Tensor
    chunks: list           # [(lefts, rights)], each (chunk, S, H, W) uint8 on the device
    gts: list              # S ground-truth trajectories, (n_frames, 4, 4), in each stream's order
    n_frames: int          # 1 + the staged chunks' frames


def stage(args: argparse.Namespace, shape: tuple[int, int], fx: float,
          n_chunks: int | None = None, seq=None, frames=None) -> Staged:
    """Render and stage args.frames frames of args.streams streams in
    chunks of args.chunk (all whole chunks unless n_chunks is given).
    Given a sequence and its rendered frames (a list of (i, left, right)),
    the streams run that sequence instead, cut to their first args.frames
    frames (the reversed ones start at its last frame). Raises before
    rendering when args.device is the card and there is none."""
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.geometry import camera as cam_mod
    from svo_tpu_torch.io.synthetic import SyntheticSequence
    from svo_tpu_torch.pipeline.odometry import resolve_device

    device = resolve_device(args.device)
    S, CH = args.streams, args.chunk
    if seq is None:
        seq = SyntheticSequence(n_frames=args.frames, shape=shape, fx=fx)
    N = seq.n_frames
    if n_chunks is None:
        n_chunks = (min(args.frames, N) - 1) // CH
    if n_chunks < 1 or 1 + n_chunks * CH > min(args.frames, N):
        raise ValueError(f"{args.frames} frames do not hold {max(n_chunks, 1)} chunk(s) of {CH} "
                         f"after the first")
    n = 1 + n_chunks * CH

    def index(s: int, t: int) -> int:
        return t if s % 2 == 0 else N - 1 - t

    need = sorted({index(s, t) for s in range(min(S, 2)) for t in range(n)})
    if frames is not None:
        rendered = {i: (left, right) for i, left, right in frames if i in need}
    else:
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            rendered = dict(zip(need, pool.map(seq.frame, need)))
    u8 = {i: tuple(np.clip(x, 0, 255).astype(np.uint8) for x in lr) for i, lr in rendered.items()}

    def first(k):
        return torch.from_numpy(np.stack([rendered[index(s, 0)][k] for s in range(S)])).to(device)

    chunks = [
        tuple(
            torch.from_numpy(np.stack([
                np.stack([u8[index(s, t)][k] for s in range(S)])
                for t in range(1 + c * CH, 1 + (c + 1) * CH)
            ])).to(device)
            for k in (0, 1)
        )
        for c in range(n_chunks)
    ]
    gt = seq.gt_poses
    gts = [(gt if s % 2 == 0 else gt[::-1])[:n] for s in range(S)]
    cfg = Config(use_orb=False, image_height=seq.shape[0], image_width=seq.shape[1])
    camera = cam_mod.from_intrinsics(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2],
                                     seq.baseline)
    return Staged(cfg, camera, first(0), first(1), chunks, gts, n)


def shape_and_fx(args: argparse.Namespace) -> tuple[tuple[int, int], float]:
    """376x1241 at fx 718.856, svo_tpu's scripts' size; --small 184x320 at
    fx 200 (soak.py's)."""
    return ((184, 320), 200.0) if args.small else ((376, 1241), 718.856)


def stream_ates(trajs: np.ndarray, gts: list) -> list[float]:
    """ATE RMSE of each stream's (n, 4, 4) trajectory against its ground truth."""
    from svo_tpu_torch.eval.trajectory import ate_rmse

    return [float(ate_rmse(trajs[s], gts[s][: trajs.shape[1]])) for s in range(len(trajs))]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)

