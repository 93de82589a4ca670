"""Running the reference over a checked stretch of a cell.

A stretch is what the output check compares: the bootstrap of a stream
set from its first frames and seeds followed by its first frame or chunk,
a frame or a chunk (or several) from the program's state before it, or a
refine sweep from the program's state before the sweep. The reference
works every frame of the stretch out again in plain PyTorch, eagerly, in
float32 with TF32 off, or for the control one precision step below
(`precision`).
"""

from __future__ import annotations

import contextlib

import torch

from vobench.reference.config import Config
from vobench.reference.geometry.camera import from_intrinsics
from vobench.reference.ops.index import take_rows
from vobench.reference.parallel.global_opt import refine_global
from vobench.reference.pipeline import frontend
from vobench.reference.pipeline.state import FeatureSet, MapState, VoState


PRECISIONS = ("float32", "tf32", "bf16")


@contextlib.contextmanager
def precision(mode: str, device):
    """The reference's arithmetic: "float32" (matmuls and convolutions in
    full float32, TF32 off: the configurations' precision), or a control
    one step below it: "tf32" (TF32 allowed), "bf16" (matmuls and
    convolutions in bfloat16 under autocast). The flags are put back
    afterwards."""
    if mode not in PRECISIONS:
        raise ValueError(f"precision {mode!r} is not one of {PRECISIONS}")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    cast = (torch.autocast(torch.device(device).type, dtype=torch.bfloat16)
            if mode == "bf16" else contextlib.nullcontext())
    try:
        with cast:
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def adopt(state) -> VoState:
    """A state of the program (the same fields in the same order) as the
    reference's own structure. Its tensors are read, never written: every
    reference step makes new ones."""
    return VoState(FeatureSet(*state.features), MapState(*state.map), state.prev_pyramid,
                   *state[3:])


class Reference:
    """The reference pipeline of one configuration on `device`.

    cfg: the reference's Config; camera: (fx, fy, cx, cy, baseline);
    lk_engine: the KLT engine whose plain version to run ("patches" or
    "fused"); chunk/cadence: the cadenced chunk (0: the dynamic keyframe
    rule frame by frame)."""

    def __init__(self, cfg: Config, camera: tuple, device, lk_engine: str = "patches",
                 chunk: int = 0, cadence: int = 0):
        self.cfg = cfg
        self.device = torch.device(device)
        self.camera = from_intrinsics(*camera, device=self.device)
        self.lk_engine = lk_engine
        self._boot = frontend.make_bootstrap(self.camera, cfg, lk_engine)
        self._step = frontend.make_step(self.camera, cfg, lk_engine)
        self._chunk = (frontend.make_cadenced_chunk_step(self.camera, cfg, chunk, cadence,
                                                         lk_engine) if chunk else None)

    def bootstrap(self, left_u8: torch.Tensor, right_u8: torch.Tensor, seeds) -> VoState:
        """([S,] H, W) uint8 first frames; seeds: one a stream (a list for a
        stack, an int for one stream)."""
        return self._boot(left_u8.to(self.device, torch.float32),
                          right_u8.to(self.device, torch.float32), seeds)

    def frames(self, state: VoState, lefts_u8: torch.Tensor, rights_u8: torch.Tensor) -> VoState:
        """Frame by frame with the dynamic keyframe rule: (K, [S,] H, W) uint8."""
        for left, right in zip(lefts_u8, rights_u8):
            state = self._step(state, left.to(self.device), right.to(self.device))
        return state

    def chunk(self, state: VoState, lefts_u8: torch.Tensor, rights_u8: torch.Tensor) -> VoState:
        """One cadenced chunk, (chunk, [S,] H, W) uint8."""
        return self._chunk(state, lefts_u8.to(self.device), rights_u8.to(self.device))

    def refine(self, state: VoState) -> VoState:
        """One global refinement sweep over every stream's trailing span at
        make_refiner's sizes, written back as BatchedStereoVO.refine writes
        it: map points, poses and the current pose."""
        K = self.camera.K
        res = refine_global(state.map, state.poses, state.frame_id, K,
                            K[0, 0] * self.camera.baseline)
        pose = take_rows(res.poses, state.frame_id[..., None])[..., 0, :, :]
        return state._replace(map=state.map._replace(points=res.map.points), poses=res.poses,
                              pose=pose)
