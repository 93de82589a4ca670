"""Data-parallel multi-sequence VO: independent VO streams over the ranks
of a process group, one or several streams a rank.

Port of svo_tpu/parallel/multi_seq.py. svo_tpu places one stream on each
device of a mesh, any number of them in one process, and steps them in one
shard_map; here each rank of a torch.distributed process group holds
n_streams / world consecutive streams, each a StereoVO on a device of its
own list, steps them in turn, and the ranks meet once per step: the
fleet's health, every stream's metrics row ([n_tracked, inlier_ratio,
n_features, is_kf, n_map_points]) summed in global stream order
(parallel/collective.py; svo_tpu's psum). No other data crosses between
streams.

All streams share one Config and one camera. Stream s is seeded with
seed + s, as svo_tpu keys it, so stream s of a fleet is StereoVO(seed=seed+s)
on the same frames, bit for bit, however the streams are split over the
ranks, and equal to stream s of BatchedStereoVO(seed=seed) on one card
(within its batched-against-single bounds: the same keys, other op order).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from svo_tpu_torch.config import Config
from svo_tpu_torch.geometry.camera import Camera
from svo_tpu_torch.parallel.collective import fold, gather_rows
from svo_tpu_torch.pipeline.odometry import StereoVO, resolve_device


class MultiStereoVO:
    """n_streams streams over the ranks of `group` (None: the default
    world); every rank constructs it and calls each method in the same
    order. n_streams=None is one stream a rank; otherwise it must be a
    multiple of the world size, and rank r holds the k = n_streams / world
    streams r*k ... r*k + k - 1, stream r*k + j on devices[j] (devices=None:
    all on `device`). device: this rank's device, where the ranks' rows
    meet; the card unless "cpu" is passed. graph goes to every stream's
    StereoVO: by default its frame steps are captured on the card and
    replayed, False runs the eager step (the reference), True raises on
    the CPU."""

    def __init__(self, cfg: Config, camera: Camera, n_streams: int | None = None, devices=None,
                 group=None, device: str | torch.device = "cuda", lk_engine: str = "patches",
                 graph: bool | None = None):
        self.group = dist.group.WORLD if group is None else group
        world = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.n = world if n_streams is None else n_streams
        if self.n < 1 or self.n % world:
            raise ValueError(f"{self.n} streams do not split evenly over {world} ranks")
        k = self.n // world
        self.device = resolve_device(device)
        devices = [self.device] * k if devices is None else list(devices)
        if len(devices) < k:
            raise ValueError(f"{k} streams a rank need {k} devices, got {len(devices)}")
        self.first = self.rank * k  # global index of this rank's first stream
        self.streams = [StereoVO(cfg, camera, device=d, lk_engine=lk_engine, graph=graph)
                        for d in devices[:k]]
        self.fleet_health: np.ndarray | None = None

    def _mine(self, frames) -> np.ndarray:
        frames = np.asarray(frames)
        if frames.shape[0] != self.n:
            raise ValueError(f"expected one frame per stream ({self.n}), got {frames.shape[0]}")
        return frames[self.first:self.first + len(self.streams)]

    def _gather(self, rows) -> torch.Tensor:
        """Every stream's row, in global stream order, on this rank's device."""
        mine = torch.stack([r.to(self.device) for r in rows])
        return gather_rows(mine, self.group)

    def start(self, lefts, rights, seed: int = 0) -> None:
        """lefts/rights: (S, H, W) first frames of every stream; this rank
        takes its own, stream s with the PnP seed seed + s."""
        for j, (vo, left, right) in enumerate(zip(self.streams, self._mine(lefts),
                                                  self._mine(rights))):
            vo.seed = seed + self.first + j
            vo.start(left, right)

    def process(self, lefts, rights) -> None:
        """(S, H, W) frames, one per stream. Updates `fleet_health`, the
        step's metrics rows summed over the streams (divide by S for
        means)."""
        for vo, left, right in zip(self.streams, self._mine(lefts), self._mine(rights)):
            vo.process(left, right)
        rows = [vo.state.metrics[vo.state.frame_id.long()] for vo in self.streams]
        self.fleet_health = fold(self._gather(rows)).cpu().numpy()

    def trajectories(self, n_frames: int) -> np.ndarray:
        """(S, n_frames, 4, 4) camera-to-world trajectories of every stream."""
        return self._gather([vo.state.poses[:n_frames] for vo in self.streams]).cpu().numpy()
