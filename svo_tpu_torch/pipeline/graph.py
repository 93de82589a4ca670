"""The compiled chunk dispatch: one chunk step captured once as a CUDA graph
and replayed with its state donated.

svo_tpu's make_cadenced_chunk_step returns jax.jit(run_chunk,
donate_argnums=(0,)) (svo_tpu/pipeline/frontend.py:606): the host hands the
device a whole chunk of frames as one program, and the state is updated in
place. PyTorch's counterpart is a torch.cuda.CUDAGraph replayed over static
buffers, which is what ChunkGraph holds:

- static buffers: every leaf of a VoState (one stream or S) and the
  (K, [S,] H, W) uint8 left and right frames;
- the first call copies the caller's state and frames into them and runs
  the chunk eagerly on them, on the step's own side stream, then copies the
  result back into the state leaves. That run is the warm-up that
  torch.cuda.graphs asks for (it builds and loads the kernels, fills what
  is built lazily, such as the ORB resize matrices, and sets up cuBLAS), and
  its result is the chunk's, so every kernel launch of the run is one of the
  run's frames. Then it captures the chunk once, on the same stream, with
  capture_error_mode="thread_local" (the harnesses render frames in
  threads): run_chunk on the static leaves and frames, then the copy of its
  output leaves into the static leaves, which is the donation;
- each later call copies the caller's state into the static leaves (every
  leaf that already is the static buffer is skipped, as when the caller
  hands back what the last call returned), the frames into the static
  frames, replays the graph and returns the static state.

The donated contract, svo_tpu's: the returned state's leaves are the step's
static buffers, valid until the next call of the same step. A caller that
keeps a state across a call clones it (pipeline/state.clone). The caller's
own tensors are only read. Each step holds its own buffers and its graph's
private memory pool (about the eager run's peak); both go with the step.

Launch counts: a kernel wrapper counts its launches when it runs, which a
replay does not do. So the capture records each wrapper's count before and
after, puts the count back (a capture launches nothing), and each replay
adds what the capture recorded: a captured run counts what the eager loop
counts.

On the CPU there is nothing to capture: every call runs the same
static-buffer code eagerly, which is how the CPU tests hold it to the eager
loop. A capture or a replay that fails raises; nothing falls back to the
eager loop.
"""

from __future__ import annotations

import time

import torch

from svo_tpu_torch.ops.klt_patches import extract_klt_patches
from svo_tpu_torch.ops.lk_fused import lk_track_level, lk_track_pyramid
from svo_tpu_torch.ops.random import split_gumbel
from svo_tpu_torch.pipeline.state import VoState, leaves, unflatten

# the kernel wrappers that count their launches (`.launches`)
COUNTED = (extract_klt_patches, lk_track_level, lk_track_pyramid, split_gumbel)


def _copy_into(dst: list, src: list) -> None:
    """dst[i] <- src[i] for every pair that is not one tensor already. A
    source that shares memory with any destination is cloned first, so that
    no copy reads what an earlier one wrote (an output leaf that is a view
    of another leaf's buffer)."""
    pairs = [(d, s) for d, s in zip(dst, src) if s is not d]
    if not pairs:
        return
    for d, s in pairs:
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(
                f"state leaf {tuple(s.shape)} {s.dtype} does not match the step's "
                f"{tuple(d.shape)} {d.dtype}"
            )
    owned = {d.untyped_storage().data_ptr() for d in dst}
    srcs = [s.clone() if s.untyped_storage().data_ptr() in owned else s for _, s in pairs]
    torch._foreach_copy_([d for d, _ in pairs], srcs)


class ChunkGraph:
    """run_chunk (state, lefts_u8, rights_u8) -> state, captured on a CUDA
    device and replayed over static buffers with the state donated; run
    eagerly over the same buffers on the CPU. check(state, lefts, rights)
    validates a call's inputs before anything is copied.

    After the first call on the card: capture_s, the host seconds of the
    capture and the graph's instantiation; launches_per_replay, each counted
    wrapper's launches in one replay."""

    def __init__(self, run_chunk, check, device, capture: bool | None = None):
        device = torch.device(device)
        if capture is None:
            capture = device.type == "cuda"
        if capture and device.type != "cuda":
            raise ValueError(f"graph=True needs a CUDA device; the step is on {device}")
        self._run = run_chunk
        self._check = check
        self.device = device
        self.capture = capture
        self.state: VoState | None = None  # the static state, once the first call made it
        self._leaves: list = []
        self._frames: tuple = ()
        self._graph = None
        self.capture_s = None
        self.launches_per_replay = None

    def _chunk_into_static(self) -> None:
        """The chunk on the static buffers, its output copied into them."""
        out = self._run(self.state, *self._frames)
        _copy_into(self._leaves, leaves(out))

    def _first(self, state: VoState, lefts, rights) -> None:
        """Static buffers from the caller's state and frames."""
        self._leaves = [x.clone(memory_format=torch.contiguous_format) for x in leaves(state)]
        self.state = unflatten(self._leaves, state)
        self._frames = tuple(x.to(self.device, copy=True).contiguous() for x in (lefts, rights))

    def _capture(self) -> None:
        """Warm up on the static buffers (the first chunk, run eagerly on
        the side stream), then capture one chunk on that stream."""
        stream = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            self._chunk_into_static()
        main.wait_stream(stream)
        before = [f.launches for f in COUNTED]
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                self._chunk_into_static()
        finally:
            recorded = {f.__name__: f.launches - b for f, b in zip(COUNTED, before)}
            for f, b in zip(COUNTED, before):
                f.launches = b
        self.capture_s = time.perf_counter() - t0
        self.launches_per_replay = recorded
        self._graph = graph

    def __call__(self, state: VoState, lefts_u8, rights_u8) -> VoState:
        self._check(state, lefts_u8, rights_u8)
        if self.state is None:
            self._first(state, lefts_u8, rights_u8)
            try:
                if self.capture:
                    self._capture()
                else:
                    self._chunk_into_static()
            except BaseException:
                self.state, self._leaves, self._frames = None, [], ()
                raise
            return self.state
        _copy_into(self._leaves, leaves(state))
        for buf, x in zip(self._frames, (lefts_u8, rights_u8)):
            if x is not buf:
                if x.shape != buf.shape or x.dtype != buf.dtype:
                    raise ValueError(f"frames {tuple(x.shape)} {x.dtype}: the step holds "
                                     f"{tuple(buf.shape)} {buf.dtype}")
                buf.copy_(x)
        if not self.capture:
            self._chunk_into_static()
        else:
            self._graph.replay()
            for f in COUNTED:
                f.launches += self.launches_per_replay[f.__name__]
        return self.state
