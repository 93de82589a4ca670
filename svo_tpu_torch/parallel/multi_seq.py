"""Data-parallel multi-sequence VO: one independent VO stream per rank.

Port of svo_tpu/parallel/multi_seq.py. svo_tpu places one stream on each
device of a mesh and steps them in one shard_map; here each rank of a
torch.distributed process group runs one stream's StereoVO on its own
device, and the ranks meet once per step: the fleet's health, each
stream's metrics row ([n_tracked, inlier_ratio, n_features, is_kf,
n_map_points]) summed over the ranks in rank order (parallel/collective.py;
svo_tpu's psum). No other data crosses between streams.

All streams share one Config and one camera. Stream s is seeded with
seed + s, as svo_tpu keys it, so stream s of a fleet is StereoVO(seed=seed+s)
on the same frames, bit for bit. (BatchedStereoVO, which steps S streams on
one card, draws every stream's noise from one generator and does not have
this property.)
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from svo_tpu_torch.config import Config
from svo_tpu_torch.geometry.camera import Camera
from svo_tpu_torch.parallel.collective import fold, gather_rows
from svo_tpu_torch.pipeline.odometry import StereoVO


class MultiStereoVO:
    """One stream per rank of `group` (None: the default world); every rank
    constructs it and calls each method in the same order. device: this
    rank's device, the card unless "cpu" is passed."""

    def __init__(self, cfg: Config, camera: Camera, group=None,
                 device: str | torch.device = "cuda", lk_engine: str = "patches"):
        self.group = dist.group.WORLD if group is None else group
        self.n = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.vo = StereoVO(cfg, camera, device=device, lk_engine=lk_engine)
        self.fleet_health: np.ndarray | None = None

    def _mine(self, frames) -> np.ndarray:
        frames = np.asarray(frames)
        if frames.shape[0] != self.n:
            raise ValueError(f"expected one frame per stream ({self.n}), got {frames.shape[0]}")
        return frames[self.rank]

    def start(self, lefts, rights, seed: int = 0) -> None:
        """lefts/rights: (S, H, W) first frames of every stream; this rank
        takes its own, with the PnP seed seed + rank."""
        self.vo.seed = seed + self.rank
        self.vo.start(self._mine(lefts), self._mine(rights))

    def process(self, lefts, rights) -> None:
        """(S, H, W) frames, one per stream. Updates `fleet_health`, the
        step's metrics rows summed over the streams (divide by S for
        means)."""
        self.vo.process(self._mine(lefts), self._mine(rights))
        st = self.vo.state
        row = st.metrics[st.frame_id.long()][None]
        self.fleet_health = fold(gather_rows(row, self.group)).cpu().numpy()

    def trajectories(self, n_frames: int) -> np.ndarray:
        """(S, n_frames, 4, 4) camera-to-world trajectories of every stream."""
        return gather_rows(self.vo.state.poses[None, :n_frames], self.group).cpu().numpy()
