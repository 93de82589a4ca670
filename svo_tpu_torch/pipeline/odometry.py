"""Host-side odometry driver: the sequential frame loop.

Port of svo_tpu/pipeline/odometry.py::StereoVO. The host streams images to
the device and calls the frame step, which reads one branch key a frame
(the data-dependent rule) or a chunk (the window BA's schedule); nothing
else is read back until finish().
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Iterable

import numpy as np
import torch

from svo_tpu_torch.config import Config
from svo_tpu_torch.geometry.camera import Camera
from svo_tpu_torch.ops.klt import ENGINES
from svo_tpu_torch.pipeline import frontend
from svo_tpu_torch.pipeline.state import VoState, host


@dataclass
class RunResult:
    poses: np.ndarray       # (F, 4, 4) camera-to-world trajectory
    kf_flags: np.ndarray    # (F,) bool
    metrics: np.ndarray     # (F, 5)
    n_frames: int
    total_time_s: float
    fps: float
    map_points: np.ndarray | None = None
    per_frame_ms: list = field(default_factory=list)


def resolve_device(device) -> torch.device:
    """The device an engine runs on. The card is the default; the CPU is
    used only when the caller asks for it, never as a fallback."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for (the default) but "
            f"torch.cuda.is_available() is False; pass device=\"cpu\" to run "
            f"on the CPU"
        )
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StereoVO:
    """Stereo visual odometry engine on one device."""

    def __init__(
        self,
        config: Config,
        camera: Camera,
        seed: int = 0,
        chunk: int = 0,
        kf_cadence: int = 0,
        device: str | torch.device = "cuda",
        lk_engine: str = "patches",
        graph: bool | None = None,
    ):
        """Runs on the card unless device="cpu" is passed; without a CUDA
        device the default raises. chunk > 0 enables run_chunked: with
        kf_cadence > 0 it replenishes every `kf_cadence` frames
        (frontend.make_cadenced_chunk_step; chunk must be a multiple of
        kf_cadence), with kf_cadence=0 it keeps the reference's
        data-dependent keyframe rule inside the chunk
        (frontend.make_chunked_step, through process()'s step). process() and
        run() use the data-dependent rule (frontend.make_step).
        graph goes to every step: by default each is captured on the card
        as CUDA graphs, one per branch key, and replayed with the state
        donated (self.state is then the step's own buffers until the next
        process or chunk; clone what you keep), False runs the eager loop,
        True raises on the CPU. The state carries svo_tpu's PnP key, PRNGKey(seed) at start(), so
        the run draws svo_tpu's noise for the same seed. lk_engine picks
        the KLT engine of every tracker call: "patches" (svo_tpu's default)
        or "fused" (ops/klt.py)."""
        if lk_engine not in ENGINES:
            raise ValueError(f"lk_engine {lk_engine!r} is not one of {ENGINES}")
        self.cfg = config
        self.device = resolve_device(device)
        self.camera = camera.to(self.device)
        self.seed = seed
        self.chunk = chunk
        self.kf_cadence = kf_cadence
        self.lk_engine = lk_engine
        self.graph = graph  # the dispatch of every step, and of a refiner built for this engine
        self._bootstrap = frontend.make_bootstrap(self.camera, config, lk_engine)
        self._step = frontend.make_step(self.camera, config, lk_engine, graph=graph)
        self._chunk_step = None
        if chunk and kf_cadence:
            if chunk % kf_cadence:
                raise ValueError(
                    f"chunk ({chunk}) must be a multiple of kf_cadence ({kf_cadence})"
                )
            self._chunk_step = frontend.make_cadenced_chunk_step(
                self.camera, config, chunk, kf_cadence, lk_engine, graph=graph
            )
        elif chunk:
            self._chunk_step = frontend.make_chunked_step(self.camera, config, chunk, lk_engine,
                                                          step=self._step)
        self.state: VoState | None = None

    def _prep(self, img: np.ndarray, dtype=np.float32) -> np.ndarray:
        """Pad/crop to the configured static shape."""
        H, W = self.cfg.image_height, self.cfg.image_width
        h, w = img.shape
        if (h, w) != (H, W):
            out = np.zeros((H, W), dtype)
            out[: min(h, H), : min(w, W)] = img[:H, :W]
            return out
        return np.asarray(img, dtype)

    def _to_device(self, img: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(self._prep(img), dtype=torch.float32).to(self.device)

    def start(self, left: np.ndarray, right: np.ndarray) -> None:
        self.state = self._bootstrap(self._to_device(left), self._to_device(right), self.seed)

    def process(self, left: np.ndarray, right: np.ndarray) -> None:
        if self.state is None:
            raise RuntimeError("call start() first")
        self.state = self._step(self.state, self._to_device(left), self._to_device(right))

    def run(
        self,
        frames: Iterable[tuple[int, np.ndarray, np.ndarray]],
        verbose: bool = False,
        time_per_frame: bool = False,
    ) -> RunResult:
        """Drive a whole sequence frame by frame; `frames` yields
        (idx, left, right). verbose prints the reference's per-frame log
        line, which waits for the device every frame."""
        it = iter(frames)
        try:
            _, left, right = next(it)
        except StopIteration:
            raise ValueError("empty sequence") from None
        self.start(left, right)
        n = 1
        per_frame_ms = []
        _sync(self.device)
        t0 = time.perf_counter()
        for _, left, right in it:
            ts = time.perf_counter()
            self.process(left, right)
            if verbose or time_per_frame:
                _sync(self.device)
            if time_per_frame:
                per_frame_ms.append((time.perf_counter() - ts) * 1e3)
            if verbose:
                m = self.state.metrics[n].cpu().numpy()
                print(
                    f"{n:4d} | MPs: {int(m[4]):6d} | Features: {int(m[2]):4d} "
                    f"| IR: {m[1] * 100:.2f}% |{' KF' if m[3] else ''}"
                )
            n += 1
        _sync(self.device)
        return self.finish(n, time.perf_counter() - t0, per_frame_ms)

    def run_chunked(
        self,
        frames: list[tuple[int, np.ndarray, np.ndarray]],
        preload: bool = False,
    ) -> RunResult:
        """Drive a sequence in chunks of `chunk` frames shipped as uint8.
        preload=True moves every chunk to the device before the timed loop.
        Frames past the last whole chunk go through the single-frame step."""
        if self._chunk_step is None:
            raise RuntimeError("construct with chunk > 0")
        K = self.chunk

        def to_u8(img):
            return self._prep(np.clip(img, 0, 255).astype(np.uint8), np.uint8)

        _, l0, r0 = frames[0]
        rest = frames[1:]
        n_chunks = len(rest) // K
        chunks = []
        for c0 in range(0, n_chunks * K, K):
            chunk = rest[c0 : c0 + K]
            pair = [
                torch.from_numpy(np.stack([to_u8(f[k]) for f in chunk]))
                for k in (1, 2)
            ]
            chunks.append([p.to(self.device) for p in pair] if preload else pair)

        self.start(l0, r0)
        _sync(self.device)
        t0 = time.perf_counter()
        for lefts, rights in chunks:
            self.state = self._chunk_step(self.state, lefts.to(self.device), rights.to(self.device))
        tail = rest[n_chunks * K:]
        if tail:
            print(
                f"[svo_tpu_torch] run_chunked: {len(tail)} tail frame(s) go "
                f"through the single-frame step",
                file=sys.stderr,
            )
        for _, left, right in tail:
            self.process(left, right)
        _sync(self.device)
        return self.finish(len(frames), time.perf_counter() - t0)

    def finish(self, n: int, total_s: float, per_frame_ms=None) -> RunResult:
        st = self.state
        n_pts = int(st.map.n_points)
        return RunResult(
            poses=host(st.poses[:n]),
            kf_flags=host(st.kf_flags[:n]),
            metrics=host(st.metrics[:n]),
            n_frames=n,
            total_time_s=total_s,
            fps=(n - 1) / total_s if total_s > 0 else 0.0,
            map_points=host(st.map.points[:n_pts]),
            per_frame_ms=per_frame_ms or [],
        )
