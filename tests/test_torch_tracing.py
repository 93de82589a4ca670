"""The port's tracer (svo_tpu_torch/utils/tracing.py).

On the CPU: off, every hook is the shared no-op and touches neither the
profiler nor CUDA; on, StereoVO.process, BatchedStereoVO.process_chunk
and refine() record their spans nested as the layers nest, one request a
frame, chunk or sweep, one device interval a call, and every stage mark
once a frame step, in order; the card's path (events read only once
completed, a replay whose marks are not ready skipped and counted, every
event put on the host's clock through the anchor) with fake events. On
the card (marker `chip`; skips without one): a replayed FrameGraph and
ChunkGraph captured with marks are bit-equal to ones captured without.
This file imports no jax, so it runs on the card:

    python3 -m pytest tests/test_torch_tracing.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from svo_tpu_torch import _build
from svo_tpu_torch.config import Config
from svo_tpu_torch.geometry.camera import from_intrinsics
from svo_tpu_torch.io.synthetic import SyntheticSequence
from svo_tpu_torch.parallel.batched import BatchedStereoVO
from svo_tpu_torch.pipeline.odometry import StereoVO
from svo_tpu_torch.pipeline.state import leaves
from svo_tpu_torch.utils import tracing

torch.set_num_threads(2)

H, W = 96, 256
ORDER = list(tracing.STAGES) + [tracing.END]


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and empty (it is one
    switch for the whole process)."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def frames():
    seq = SyntheticSequence(n_frames=13, shape=(H, W), fx=120.0, speed=0.12, seed=3)
    return seq, [(left, right) for _, left, right in seq]


def _engine_args(seq):
    cam = from_intrinsics(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline)
    return Config(use_orb=False, image_height=H, image_width=W), cam


def _u8_chunk(fr, S: int, c: int):
    """(6, S, H, W) uint8 lefts and rights of chunk c (frames 1 + 6c ..),
    every stream alike."""
    return tuple(np.stack([np.stack([np.clip(f[k], 0, 255).astype(np.uint8)] * S)
                           for f in fr[1 + 6 * c: 7 + 6 * c]]) for k in (0, 1))


def _calls(spans):
    """(top-level name, request) -> [(name, parent), ...] of its spans in
    order of start; each span lies inside one of its parent's name and
    request."""
    for name, parent, request, t0, t1 in spans:
        assert t0 <= t1
        if parent is not None:
            assert any(n == parent and r == request and a <= t0 and t1 <= b
                       for n, _, r, a, b in spans), (name, parent, request)
    tops = [s for s in spans if s[1] is None]
    out: dict = {}
    for name, parent, request, t0, t1 in spans:
        top = next(s for s in tops if s[3] <= t0 and t1 <= s[4])
        out.setdefault((top[0], top[2]), []).append((name, parent))
    return out


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def test_off_is_the_shared_noop_and_touches_nothing(frames, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the tracer is off")

    monkeypatch.setattr(tracing, "_record", refuse)
    monkeypatch.setattr(tracing, "_sync", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tracing.span("process") is tracing.span("key") is tracing._NOOP
    assert tracing.call("process", "cuda:0", 3) is tracing._NOOP
    assert tracing.eager("k", "cuda:0") is tracing.capturing("k", "cuda:0") is tracing._NOOP
    tracing.mark("pyramid")
    tracing.replayed(None)
    seq, fr = frames
    cfg, cam = _engine_args(seq)
    vo = StereoVO(cfg, cam, device="cpu")
    vo.start(*fr[0])
    vo.process(*fr[1])
    assert tracing.drain() == {"spans": [], "intervals": [], "marks": [], "marks_skipped": 0}


def test_stereo_vo_process_traced(frames):
    seq, fr = frames
    cfg, cam = _engine_args(seq)
    vo = StereoVO(cfg, cam, device="cpu")
    tracing.enable()
    vo.start(*fr[0])
    for left, right in fr[1:5]:
        vo.process(left, right)
    rec = tracing.drain()
    spans = rec["spans"]
    # one request a frame: the frame's index since start()
    assert _calls(spans) == {
        ("bootstrap", 0): [("bootstrap", None), ("upload", "bootstrap")],
        **{("process", f): [("process", None), ("upload", "process"), ("load", "process"),
                            ("key", "process"), ("replay", "process")] for f in (1, 2, 3, 4)}}
    assert [i[:2] for i in rec["intervals"]] == [["bootstrap", 0]] + [["process", f]
                                                                     for f in (1, 2, 3, 4)]
    for (name, request, a, b), s in zip(rec["intervals"], [s for s in spans if s[1] is None]):
        assert [name, request, a, b] == [s[0], s[2], s[3], s[4]]  # the CPU's: the span's bounds
    # one sample a frame step, its key the graph's, its stages in order
    assert [(m[0], m[1]) for m in rec["marks"]] == [("process", f) for f in (1, 2, 3, 4)]
    assert [m[2] for m in rec["marks"]] == [(k, False) for k in vo.state.kf_flags[1:5].tolist()]
    for m in rec["marks"]:
        (frame,) = m[3]
        assert [st for st, _ in frame] == ORDER
        t = [ns for _, ns in frame]
        assert t == sorted(t)
        proc = next(s for s in spans if s[0] == "replay" and s[2] == m[1])
        assert proc[3] <= t[0] and t[-1] <= proc[4]
    assert rec["marks_skipped"] == 0
    assert tracing.drain() == {"spans": [], "intervals": [], "marks": [], "marks_skipped": 0}


def test_spans_are_profiler_ranges_only_inside_a_profile(frames, monkeypatch):
    """Under torch.profiler each span is also a record_function range named
    "svo.<name>" (kineto's clock); outside a profile no range is entered."""
    from torch.profiler import ProfilerActivity, profile

    seq, fr = frames
    cfg, cam = _engine_args(seq)
    vo = StereoVO(cfg, cam, device="cpu")
    vo.start(*fr[0])
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        vo.process(*fr[1])
    names = {e.name for e in prof.events() if e.name.startswith(tracing.PREFIX)}
    assert names == {"svo.process", "svo.upload", "svo.load", "svo.key", "svo.replay"}

    def refuse(*a, **k):
        raise AssertionError("a range entered outside a profile")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    vo.process(*fr[2])
    assert [s[2] for s in tracing.drain()["spans"] if s[0] == "process"] == [1, 2]


def test_batched_chunk_and_refine_traced(frames):
    seq, fr = frames
    cfg, cam = _engine_args(seq)
    bvo = BatchedStereoVO(cfg, cam, 2, chunk=6, kf_cadence=3, device="cpu")
    bvo.make_refiner(n_blocks=2, cams_per_block=3)
    tracing.enable()
    bvo.start(np.stack([fr[0][0]] * 2), np.stack([fr[0][1]] * 2))
    for c in range(2):
        bvo.process_chunk(*_u8_chunk(fr, 2, c))
    bvo.refine()
    rec = tracing.drain()
    by_call = _calls(rec["spans"])
    assert sorted(by_call) == [("bootstrap", 0), ("chunk", 0), ("chunk", 1), ("refine", 0)]
    # a cadenced chunk without the BA has no key to read
    assert by_call["chunk", 0] == by_call["chunk", 1] == [
        ("chunk", None), ("upload", "chunk"), ("load", "chunk"), ("replay", "chunk")]
    assert by_call["refine", 0] == [
        ("refine", None), ("load", "refine"), ("pre", "refine"), ("replay", "pre"),
        ("key", "refine"), ("replay", "refine"), ("verdict_read", "refine")]
    assert [i[:2] for i in rec["intervals"]] == [["bootstrap", 0], ["chunk", 0], ["chunk", 1],
                                                 ["refine", 0]]
    # a chunk's sample keeps its frames apart: six frame steps, every stage once each
    chunks = [m for m in rec["marks"] if m[0] == "chunk"]
    assert [(m[1], m[2]) for m in chunks] == [(0, ()), (1, ())]
    for m in chunks:
        assert len(m[3]) == 6
        assert all([st for st, _ in f] == ORDER for f in m[3])
        t = [ns for f in m[3] for _, ns in f]
        assert t == sorted(t)
    # the refiner's graphs hold no marks: no sample for the sweep
    assert [m for m in rec["marks"] if m[0] == "refine"] == []


class _FakeEvent:
    """A CUDA event as the tracer uses it, on a settable device clock (ms)."""

    clock_ms = 0.0
    done_ms = 0.0  # the device has run everything recorded up to here

    def __init__(self):
        self.t = _FakeEvent.clock_ms

    def query(self):
        return self.t <= _FakeEvent.done_ms

    def synchronize(self):
        _FakeEvent.done_ms = max(_FakeEvent.done_ms, self.t)

    def elapsed_time(self, other):
        assert self.query() and other.query(), "read before it completed"
        return other.t - self.t


def test_events_are_read_only_once_completed(monkeypatch):
    """The card's path with fake events: a replay's marks are read at the
    graph's next replay only if its last mark has completed, else skipped
    and counted; drain() reads the last; every event lands on the host's
    clock by the anchor's offset."""
    made = []

    def record(device, external=False):
        assert device == torch.device("cuda:0")
        made.append(external)
        return _FakeEvent()

    def sync(device):
        _FakeEvent.done_ms = _FakeEvent.clock_ms

    monkeypatch.setattr(tracing, "_record", record)
    monkeypatch.setattr(tracing, "_sync", sync)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _FakeEvent.clock_ms = _FakeEvent.done_ms = 100.0
    tracing.enable()
    with tracing.call("chunk", "cuda:0"):  # the first call anchors the device
        ((_, anchor_ns),) = tracing._anchors.values()
        with tracing.capturing("k", "cuda:0") as marks:
            for stage in ORDER:
                tracing.mark(stage)
                _FakeEvent.clock_ms += 1.0
    assert made == [False, False] + [True] * len(ORDER) + [False]
    replays = []
    for c, ready in enumerate((None, False, True, False)):
        if ready is not None:
            _FakeEvent.done_ms = _FakeEvent.clock_ms if ready else 0.0
        with tracing.call("chunk", "cuda:0"):
            tracing.replayed(marks)
            for ev in [e for _, e in marks.stamps]:  # the replay re-records the graph's events
                ev.t = _FakeEvent.clock_ms = _FakeEvent.clock_ms + 1.0
            replays.append([e.t for _, e in marks.stamps])
    rec = tracing.drain()
    # replay 1 found replay 0 still running (skipped), replay 2 read replay 1,
    # replay 3 found replay 2 running, drain() read replay 3
    assert rec["marks_skipped"] == 2
    assert [(m[0], m[1], m[2]) for m in rec["marks"]] == [("chunk", 2, "k"), ("chunk", 4, "k")]
    for m, r in zip(rec["marks"], (replays[1], replays[3])):
        (frame,) = m[3]
        assert [st for st, _ in frame] == ORDER
        assert [ns for _, ns in frame] == [anchor_ns + round((t - 100.0) * 1e6) for t in r]
    assert [i[:2] for i in rec["intervals"]] == [["chunk", c] for c in range(5)]
    assert all(a <= b for _, _, a, b in rec["intervals"])


@pytest.mark.chip
@pytest.mark.parametrize("kind", ["frame", "chunk"])
def test_marks_leave_a_replayed_graph_bit_equal(frames, kind):
    """A replayed FrameGraph (StereoVO.process) and ChunkGraph
    (BatchedStereoVO.process_chunk) captured with the tracer on, its stage
    marks event-record nodes of the graph, against the same captured with
    it off: every state leaf bit-equal after each call; every replay's
    marks read, in order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: "
                    "python3 -m pytest tests/test_torch_tracing.py --noconftest -q)")
    seq, fr = frames
    cfg, cam = _engine_args(seq)
    n_calls = len(fr) - 1 if kind == "frame" else 2
    runs = []
    for on in (False, True):
        if on:
            tracing.enable()
        states = []
        if kind == "frame":
            vo = StereoVO(cfg, cam, device="cuda")
            vo.start(*fr[0])
            for left, right in fr[1:]:
                vo.process(left, right)
                states.append([_bits(x) for x in leaves(vo.state)])
        else:
            vo = BatchedStereoVO(cfg, cam, 2, chunk=6, kf_cadence=3, device="cuda")
            vo.start(np.stack([fr[0][0]] * 2), np.stack([fr[0][1]] * 2))
            for c in range(n_calls):
                vo.process_chunk(*_u8_chunk(fr, 2, c))
                states.append([_bits(x) for x in leaves(vo.state)])
        torch.cuda.synchronize()
        runs.append((states, vo))
    rec = tracing.drain()
    assert len(runs[0][0]) == len(runs[1][0]) == n_calls
    for a, b in zip(runs[0][0], runs[1][0]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    # a sample a call (a key's first call: its warm-up's, read in drain()),
    # none skipped: each call's state was read before the next
    assert len(rec["marks"]) == n_calls and rec["marks_skipped"] == 0
    per = 1 if kind == "frame" else 6
    for m in rec["marks"]:
        assert len(m[3]) == per and all([st for st, _ in f] == ORDER for f in m[3])
        t = [ns for f in m[3] for _, ns in f]
        assert t == sorted(t)
    # the graphs captured off hold no marks; on, one event a mark
    step = runs[0][1]._step if kind == "frame" else runs[0][1]._chunk_step
    assert all(v is None for v in step._marks.values())
    step = runs[1][1]._step if kind == "frame" else runs[1][1]._chunk_step
    assert {len(v.stamps) for v in step._marks.values()} == {len(ORDER) * per}


def test_counters_are_drained_with_the_tracer_on():
    """drain() gives what each of the kernels' counters (_build.counters())
    added since the last reset or drain, with the tracer on and only where
    one moved; off, no counters."""
    _build.count("ransac_pnp.slots", 5)
    tracing.enable()
    _build.count("ransac_pnp.launches", 2)
    _build.count("ransac_pnp.slots", 8 * 2048)
    assert tracing.drain()["counters"] == {"ransac_pnp.launches": 2,
                                           "ransac_pnp.slots": 8 * 2048}
    assert "counters" not in tracing.drain()
    tracing.disable()
    _build.count("ransac_pnp.slots", 7)
    assert "counters" not in tracing.drain()


def test_a_replay_adds_what_its_capture_counted(monkeypatch):
    """A captured step's replay adds to every counter (each kernel's
    launches and ransac_pnp.slots) what its capture recorded, so a traced
    run reads the size the PnP kernel ran at from drain()'s counters."""
    from svo_tpu_torch.pipeline import graph as tgraph

    class Fake:
        def replay(self):
            pass

    def capture(self, name, body):
        body()
        self.graphs[name] = Fake()
        self.capture_s[name] = 0.0
        self.launches_per_replay[name] = {"ransac_pnp.launches": 2, "threefry.launches": 1,
                                          "ransac_pnp.slots": 2 * 1024}

    monkeypatch.setattr(tgraph.StepGraph, "_capture", capture)
    step = tgraph.StepGraph(lambda s, key: (s[0] + 1.0,), None, "cpu")
    step.capture = True
    tracing.enable()
    for _ in range(3):  # a capture, then two replays
        step((torch.zeros(3),))
    assert tracing.drain()["counters"] == {"ransac_pnp.launches": 4, "threefry.launches": 2,
                                           "ransac_pnp.slots": 4 * 1024}


@pytest.mark.chip
def test_counters_record_the_pnp_kernels_size(frames):
    """On the card, captured chunks of 2 streams at 256 feature slots (the
    PnP kernel's wide path) with the tracer on: drain()'s counters give two
    launches and 2 x 256 slots a frame step, and every frame step's marks
    include pnp_kernel in order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: "
                    "python3 -m pytest tests/test_torch_tracing.py --noconftest -q)")
    import dataclasses

    from svo_tpu_torch.config import Capacity

    seq, fr = frames
    cfg, cam = _engine_args(seq)
    cfg = dataclasses.replace(cfg, capacity=Capacity(max_features=256, max_detections=256))
    tracing.enable()
    vo = BatchedStereoVO(cfg, cam, 2, chunk=6, kf_cadence=3, device="cuda")
    vo.start(np.stack([fr[0][0]] * 2), np.stack([fr[0][1]] * 2))
    tracing.drain()
    for c in range(2):
        vo.process_chunk(*_u8_chunk(fr, 2, c))
    torch.cuda.synchronize()
    rec = tracing.drain()
    assert rec["counters"]["ransac_pnp.launches"] == 2 * 12
    assert rec["counters"]["ransac_pnp.slots"] == 12 * 2 * 256
    assert all([st for st, _ in f] == ORDER for m in rec["marks"] for f in m[3])
    assert "pnp_kernel" in ORDER
