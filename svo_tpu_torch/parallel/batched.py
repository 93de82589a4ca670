"""Single-card multi-stream VO: S independent streams stepped in lockstep.

Port of svo_tpu/parallel/batched.py::BatchedStereoVO. svo_tpu batches the
whole frame step over S streams with jax.vmap; the port's frame step
(pipeline/frontend.py) takes the stream axis written out, so the state is
the single-stream VoState with a leading (S,) on every leaf, every
per-feature op becomes an (S*N)-row op, and each kernel launch (patch
extraction, the fused LK level) serves all S streams. One stream's step is
bound by its launches, not by the card, so S streams cost about the
launches of one.

Keyframing in the chunked path is statically cadenced
(frontend.make_cadenced_chunk_step): no step branches on data. The
per-frame `process` path keeps the reference's dynamic rule: each stream
decides for itself, replenishment is computed for all streams and selected
per stream (what jax.vmap makes of svo_tpu's lax.cond), and is skipped on
frames where no stream keyframes.
"""

from __future__ import annotations

import numpy as np
import torch

from svo_tpu_torch.config import Config
from svo_tpu_torch.geometry.camera import Camera
from svo_tpu_torch.ops.index import take_rows
from svo_tpu_torch.ops.klt import ENGINES
from svo_tpu_torch.parallel.global_opt import refine_global
from svo_tpu_torch.pipeline import frontend
from svo_tpu_torch.pipeline.odometry import resolve_device
from svo_tpu_torch.pipeline.state import VoState


class BatchedStereoVO:
    """S independent VO streams on ONE device, stepped in lockstep.

    All streams share one static Config and one camera; the state is a
    VoState with a leading (S,) axis on every leaf.

    Args:
        chunk: frames per chunked dispatch (process_chunk input length);
            must be a multiple of kf_cadence. 0 picks 2 cadences.
        kf_cadence: static keyframe period for the chunked path (must divide
            chunk). 0 picks cfg.tracking.kf_max_interval (or 4 if that is 0).
        device: the card unless "cpu" is passed; without a CUDA device the
            default raises.
        lk_engine: the KLT engine of every tracker call, "patches" or
            "fused" (ops/klt.py).
    """

    def __init__(
        self,
        cfg: Config,
        camera: Camera,
        n_streams: int,
        chunk: int = 0,
        kf_cadence: int = 0,
        device: str | torch.device = "cuda",
        lk_engine: str = "patches",
    ):
        if lk_engine not in ENGINES:
            raise ValueError(f"lk_engine {lk_engine!r} is not one of {ENGINES}")
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.camera = camera.to(self.device)
        self.S = n_streams
        if kf_cadence <= 0:
            kf_cadence = cfg.tracking.kf_max_interval or 4
        if chunk <= 0:
            chunk = 2 * kf_cadence
        if chunk % kf_cadence != 0:
            raise ValueError(
                f"chunk ({chunk}) must be a multiple of kf_cadence "
                f"({kf_cadence}) — callers pre-slice frames to the chunk "
                f"size, so silently adjusting it would surface later as a "
                f"confusing shape error in process_chunk"
            )
        self.chunk = chunk
        self.kf_cadence = kf_cadence
        self.lk_engine = lk_engine
        self.state: VoState | None = None
        self._refine = None
        # the RefineResult of the last sweep (its costs say each stream's regime)
        self.last_refine = None
        # one generator, seeded in start(): each step draws the PnP noise of
        # all streams in one (S, hypotheses, N) call, stream s taking row s
        self.generator = torch.Generator(device=self.device)
        self._boot = frontend.make_bootstrap(self.camera, cfg, lk_engine)
        self._chunk_step = frontend.make_cadenced_chunk_step(
            self.camera, cfg, chunk, kf_cadence, lk_engine
        )

    # -- driving --------------------------------------------------------

    def _check_shape(self, arr, name, frame_major: bool):
        H, W = self.cfg.image_height, self.cfg.image_width
        want = (self.chunk, self.S, H, W) if frame_major else (self.S, H, W)
        if tuple(arr.shape) != want:
            raise ValueError(
                f"{name}: expected shape {want} "
                f"({'(K,S,H,W) frame-major' if frame_major else '(S,H,W)'}), "
                f"got {tuple(arr.shape)}"
            )

    def _f32(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr).to(self.device, torch.float32)

    def start(self, lefts, rights, seed: int = 0):
        """lefts/rights: (S, H, W) first frame of each stream (numpy arrays
        or tensors). svo_tpu splits one key per stream from seed + s; here
        `seed` seeds the one generator whose (S, hypotheses, N) draws give
        every stream its own noise."""
        self._check_shape(lefts, "lefts", False)
        self._check_shape(rights, "rights", False)
        self.generator.manual_seed(seed)
        self.state = self._boot(self._f32(lefts), self._f32(rights))

    def process(self, lefts, rights):
        """One frame for every stream: (S, H, W). Dynamic keyframe rule."""
        if self.state is None:
            raise RuntimeError("call start() first")
        self._check_shape(lefts, "lefts", False)
        self._check_shape(rights, "rights", False)
        self.state = frontend.step_body(
            self.state, self._f32(lefts), self._f32(rights), self.camera, self.cfg,
            generator=self.generator, lk_engine=self.lk_engine,
        )

    def process_chunk(self, lefts_u8, rights_u8):
        """A chunk of frames for every stream: (chunk, S, H, W) uint8 arrays
        or tensors (on the device already, or on the host; uint8 keeps the
        host->device traffic 4x down). Keyframes on the static cadence."""
        if self.state is None:
            raise RuntimeError("call start() first")
        self._check_shape(lefts_u8, "lefts_u8", True)
        self._check_shape(rights_u8, "rights_u8", True)
        self.state = self._chunk_step(
            self.state,
            torch.as_tensor(lefts_u8).to(self.device),
            torch.as_tensor(rights_u8).to(self.device),
            self.generator,
        )

    def trajectories(self, n_frames: int) -> np.ndarray:
        """(S, n_frames, 4, 4) camera-to-world trajectories."""
        return self.state.poses[:, :n_frames].cpu().numpy()

    # -- global refinement, run between chunks --------------------------

    def make_refiner(
        self,
        n_blocks: int = 4,
        cams_per_block: int = 7,
        n_points: int = 512,
        n_obs: int = 2048,
        ba_iterations: int = 12,
        pg_iterations: int = 10,
    ):
        """Build the global refiner: keyframe-block BA + pose-graph consensus
        (parallel/global_opt.refine_global) over the S streams at once,
        updating poses, map points AND the recursive current pose, so that
        the correction feeds back into subsequent tracking. Call refine()
        every few chunks; the span covered is
        (n_blocks-1)*(cams_per_block-2)+cams_per_block frames. The defaults
        are refine_global's (span 22, 8 alternation rounds). Returns
        state -> (state, per-stream accepted)."""
        K_mat = self.camera.K
        bfx = self.camera.K[0, 0] * self.camera.baseline

        def _refine(state: VoState):
            res = refine_global(
                state.map, state.poses, state.frame_id, K_mat, bfx,
                n_blocks=n_blocks, cams_per_block=cams_per_block,
                n_points=n_points, n_obs=n_obs,
                ba_iterations=ba_iterations, pg_iterations=pg_iterations,
            )
            pose = take_rows(res.poses, state.frame_id[..., None])[..., 0, :, :]
            new_state = state._replace(
                map=state.map._replace(points=res.map.points), poses=res.poses, pose=pose,
            )
            self.last_refine = res
            return new_state, res.accepted

        self._refine = _refine
        return _refine

    def refine(self) -> np.ndarray:
        """Run one global-refinement sweep on every stream's trailing span.
        Returns the per-stream acceptance verdicts (the span-cost gate)."""
        if self.state is None:
            raise RuntimeError("call start() first")
        if self._refine is None:
            self.make_refiner()
        self.state, accepted = self._refine(self.state)
        return accepted.cpu().numpy()
