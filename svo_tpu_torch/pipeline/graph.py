"""The compiled dispatch: a step captured as CUDA graphs, one per value of
its branch key, and replayed with its state donated.

svo_tpu jits its frame loop and its back-end with the state donated: the
per-frame step of the dynamic keyframe rule, jax.jit(step,
donate_argnums=(0,)) (svo_tpu/pipeline/frontend.py:513), its vmapped form
(svo_tpu/parallel/batched.py:93), the cadenced chunk, jax.jit(run_chunk,
donate_argnums=(0,)) (frontend.py:606), and the global refiner,
jax.jit(_refine, donate_argnums=(0,)) (parallel/batched.py:195). The host
hands the device a frame, a chunk or a sweep as one program, the
data-dependent branches (the keyframe rule's, the window BA's and the
refiner's regime, each a lax.cond) inside it, and the state is updated in
place. PyTorch's counterpart is a torch.cuda.CUDAGraph replayed over
static buffers. A graph holds no branch, so the step is split by its
branch key: a small value that says which branches the step takes (the
frame step: whether any stream keyframes, whether any runs the window BA;
the cadenced chunk with the window BA: which of its keyframe steps solve;
the refiner: whether any stream's span is in the aggressive regime). The
key is read on the host once a call, as the eager step reads it, and each
key value has its own graph. That is what StepGraph holds:

- static buffers: every leaf of the step's state (a VoState of one stream
  or S, or any nested tuple of tensors, such as the refiner's map,
  trajectory and frame index, or a BA problem) and the step's frames, if
  it takes any (a frame ([S,] H, W) float32, or a chunk (K, [S,] H, W)
  uint8);
- each call copies the caller's state into the static leaves (every leaf
  that already is the static buffer is skipped, as when the caller hands
  back what the last call returned) and the frames into the static frames
  (uint8 into float32 is exact, as .to(torch.float32)), then reads the key;
- a step may be split in two stages around that read (`pre`): the first
  stage is a graph of its own, the same at every call, whose outputs are
  copied into static buffers of their own; the key is read from them, and
  the second stage, one graph per key, reads them (the refiner: the
  conservative candidate, then the regime's tail). A key computed outside
  a graph (the frame step's) is computed eagerly on the static state;
- at a key's first occurrence the step runs eagerly on the static buffers,
  on the device's side stream for captures, and its output is copied into
  the static leaves. That run is the warm-up torch.cuda.graphs asks for
  (it builds and loads the kernels, fills what is built lazily, such as
  the ORB resize matrices or the solver's cuBLAS and cuSOLVER handles),
  and its result is the call's, so every kernel launch of it is one of the
  run's. Then the step is captured for that key, on the same stream, with
  capture_error_mode="thread_local" (the harnesses render frames in
  threads): the step on the static leaves and frames, then the copy of its
  output leaves into the static leaves, which is the donation. A step may
  name every value its key takes (`keys`): all of them are then captured
  at the first call, the key read last (the static state put back after
  each other one's warm-up), so that no capture lands mid-run, as XLA
  compiles both branches of a lax.cond at the first call;
- at every later occurrence of the key its graph is replayed.

A step's output may carry more than the next state (`extra`): a result
beside it, such as the refiner's costs and verdicts or a BA solve's
cameras and points. Those leaves are copied into static buffers of their
own, made from the first warm-up's output and returned with the state.

Memory: everything that lives from one call to the next is a static buffer,
allocated outside every capture (the state's and the frames' at the first
call, a stage's outputs and the extra result in the first warm-up). So
nothing in a graph's private pool is live between replays, and one step's
graphs share one pool (about the peak of the largest), which is safe in
any replay order; a tensor that one stage writes and the next reads
crosses in a static buffer, never in pool memory.

The donated contract, svo_tpu's: the returned state's leaves (and the
extra result's) are the step's static buffers, valid until the next call
of the same step. A caller that keeps a state across a call clones it
(pipeline/state.clone). The caller's own tensors are only read. Each step
holds its own buffers and pool; both go with the step.

Launch counts: a kernel wrapper counts its launches when it runs, which a
replay does not do. So a capture records each wrapper's count before and
after, puts the count back (a capture launches nothing), and each replay
adds what its key's capture recorded: a captured run counts what the eager
loop counts.

On the CPU there is nothing to capture: every call runs the same
static-buffer code eagerly, key read included, which is how the CPU tests
hold it to the eager loop. A capture or a replay that fails raises; nothing
falls back to the eager loop.
"""

from __future__ import annotations

import gc
import time

import torch

from svo_tpu_torch.ops.klt_patches import extract_klt_patches
from svo_tpu_torch.ops.lk_fused import lk_track_level, lk_track_pyramid
from svo_tpu_torch.ops.random import split_gumbel
from svo_tpu_torch.pipeline.state import leaves, unflatten

# the kernel wrappers that count their launches (`.launches`)
COUNTED = (extract_klt_patches, lk_track_level, lk_track_pyramid, split_gumbel)

# the first stage's graph, beside the keys of the second
PRE = "pre"

# One side stream a device for every step's warm-ups and captures: cuBLAS
# keeps a workspace for each stream it has run on until the process ends,
# so a stream of each step's own would hold one more workspace a step.
_SIDE_STREAMS: dict = {}


def _side_stream(device: torch.device):
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


def _is(s: torch.Tensor, d: torch.Tensor) -> bool:
    """s is d, or a view of exactly d's elements (as x[None] of a buffer)."""
    return s is d or (s.data_ptr() == d.data_ptr() and s.device == d.device
                      and s.dtype == d.dtype and s.shape == d.shape and s.stride() == d.stride())


def _copy_into(dst: list, src: list) -> None:
    """dst[i] <- src[i] for every pair that is not one tensor already. A
    source that shares memory with any destination is cloned first, so that
    no copy reads what an earlier one wrote (an output leaf that is a view
    of another leaf's buffer)."""
    pairs = [(d, s) for d, s in zip(dst, src) if not _is(s, d)]
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


def _into(static, tree):
    """tree copied into `static` (its buffers, made here when None: the
    first warm-up's output, outside every capture); returns the buffers."""
    if static is None:
        static = unflatten([torch.empty_like(x, memory_format=torch.contiguous_format)
                            for x in leaves(tree)], tree)
    _copy_into(leaves(static), leaves(tree))
    return static


class StepGraph:
    """run(state, *frames, key[, pre]) -> state (or (state, extra) with
    extra=True), captured on a CUDA device as one graph per key value and
    replayed over static buffers with the state donated; run eagerly over
    the same buffers on the CPU.

    check(state, *frames) validates a call's inputs before anything is
    copied (None: no check). frame_dtype: the static frames' dtype (a step
    without frames takes none). key: a function of the static state (and
    of the first stage's outputs, with pre) to a hashable host value (it
    makes the call's one host read), or None for a step that never branches
    (one graph, no read). pre(state) -> a nested tuple of tensors: the first
    stage, its outputs copied into static buffers (`pre_out`) and handed to
    key and run. keys: every value the key takes, all captured at the first
    call (empty: each at its first occurrence).

    After a graph's capture on the card: capture_s[k], the host seconds of
    its capture and instantiation (k a key, or PRE for the first stage);
    launches_per_replay[k], each counted wrapper's launches in one replay.
    graphs: the graphs captured so far, by the same names."""

    def __init__(self, run, check, device, frame_dtype: torch.dtype | None = None,
                 capture: bool | None = None, key=None, pre=None, extra: bool = False,
                 keys: tuple = ()):
        device = torch.device(device)
        if capture is None:
            capture = device.type == "cuda"
        if capture and device.type != "cuda":
            raise ValueError(f"graph=True needs a CUDA device; the step is on {device}")
        self._run = run
        self._check = check
        self._key = key
        self._pre = pre
        self._has_extra = extra
        self._keys = tuple(keys)
        self._frame_dtype = frame_dtype
        self.device = device
        self.capture = capture
        self.state = None    # the static state, once the first call made it
        self.pre_out = None  # the first stage's static outputs
        self.extra = None    # the static extra result
        self._leaves: list = []
        self._frames: tuple = ()
        self._pool = None
        self.graphs: dict = {}
        self.capture_s: dict = {}
        self.launches_per_replay: dict = {}

    def _stage(self) -> tuple:
        return () if self._pre is None else (self.pre_out,)

    def _pre_into_static(self) -> None:
        self.pre_out = _into(self.pre_out, self._pre(self.state))

    def _step_into_static(self, key) -> None:
        """The step on the static buffers, its output copied into them."""
        out = self._run(self.state, *self._frames, key, *self._stage())
        if self._has_extra:
            out, extra = out
            self.extra = _into(self.extra, extra)
        _copy_into(self._leaves, leaves(out))

    def _first(self, state, frames) -> None:
        """Static buffers shaped as the caller's state and frames (_load
        fills them)."""
        self._leaves = [torch.empty_like(x, memory_format=torch.contiguous_format)
                        for x in leaves(state)]
        self.state = unflatten(self._leaves, state)
        self._frames = tuple(
            torch.empty(x.shape, dtype=self._frame_dtype, device=self.device) for x in frames
        )

    def _load(self, state, frames) -> None:
        _copy_into(self._leaves, leaves(state))
        for buf, x in zip(self._frames, frames):
            if x is buf:
                continue
            if x.shape != buf.shape or not (
                    x.dtype == buf.dtype or (x.dtype == torch.uint8 and buf.dtype.is_floating_point)):
                raise ValueError(f"frames {tuple(x.shape)} {x.dtype}: the step holds "
                                 f"{tuple(buf.shape)} {buf.dtype}")
            buf.copy_(x)

    def _launch(self, name, body) -> None:
        """body() on the static buffers: eagerly without capture; else the
        graph `name` replayed, or at its first occurrence captured."""
        if not self.capture:
            body()
        elif name in self.graphs:
            self.graphs[name].replay()
            for f in COUNTED:
                f.launches += self.launches_per_replay[name][f.__name__]
        else:
            self._capture(name, body)

    def _capture(self, name, body) -> None:
        """Warm up on the static buffers (body run eagerly on the side
        stream), then capture body as graph `name` on that stream, into the
        pool the step's other graphs use."""
        stream = _side_stream(self.device)
        main = torch.cuda.current_stream(self.device)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            body()
        main.wait_stream(stream)
        before = [f.launches for f in COUNTED]
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # no cyclic garbage collection inside the capture: a dead engine's
        # graph destroyed by the collector there (cudaGraphExecDestroy, not
        # permitted while this thread captures) invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=stream,
                                  capture_error_mode="thread_local"):
                body()
        finally:
            if collecting:
                gc.enable()
            recorded = {f.__name__: f.launches - b for f, b in zip(COUNTED, before)}
            for f, b in zip(COUNTED, before):
                f.launches = b
        self.capture_s[name] = time.perf_counter() - t0
        self.launches_per_replay[name] = recorded
        self.graphs[name] = graph
        if self._pool is None:
            self._pool = graph.pool()

    def _capture_others(self, key) -> None:
        """Every other named key's graph, each warmed up from the call's
        static state, which is put back after it."""
        for other in self._keys:
            if other != key and other not in self.graphs:
                saved = [x.clone() for x in self._leaves]
                self._launch(other, lambda other=other: self._step_into_static(other))
                torch._foreach_copy_(self._leaves, saved)

    def __call__(self, state, *frames):
        if self._check is not None:
            self._check(state, *frames)
        fresh = self.state is None
        if fresh:
            self._first(state, frames)
        try:
            self._load(state, frames)
            if self._pre is not None:
                self._launch(PRE, self._pre_into_static)
            key = () if self._key is None else self._key(self.state, *self._stage())
            if self.capture and key not in self.graphs:
                self._capture_others(key)
            self._launch(key, lambda: self._step_into_static(key))
        except BaseException:
            if fresh:
                # the first call captures several graphs (PRE, the other
                # keys, the key read): one recorded before the failure
                # would replay over the buffers dropped here
                self.state, self._leaves, self._frames = None, [], ()
                self.pre_out = self.extra = None
                self.graphs, self.capture_s, self.launches_per_replay = {}, {}, {}
                self._pool = None
            raise
        return (self.state, self.extra) if self._has_extra else self.state


class ChunkGraph(StepGraph):
    """The cadenced chunk step (frontend.make_cadenced_chunk_step):
    run_chunk(state, lefts_u8, rights_u8, key) over (K, [S,] H, W) uint8
    frames; key: the chunk's window-BA schedule, or None with the BA off."""

    def __init__(self, run_chunk, check, device, capture: bool | None = None, key=None):
        super().__init__(run_chunk, check, device, torch.uint8, capture, key)


class FrameGraph(StepGraph):
    """The per-frame step of the dynamic keyframe rule (frontend.make_step):
    step(state, left, right, key) over ([S,] H, W) frames, float32 in the
    static buffers (uint8 frames are copied in exactly); key: (any stream
    keyframes, any stream runs the window BA)."""

    def __init__(self, step, check, device, capture: bool | None = None, key=None):
        super().__init__(step, check, device, torch.float32, capture, key)
