"""The port's tracer: host spans at its layer boundaries, the device
interval of each top-level call, and stage marks inside the frame step.
Off by default; one module-level switch.

    from svo_tpu_torch.utils import tracing

    tracing.enable()           # before the engine's first call
    ...                        # start / process / process_chunk / refine
    torch.cuda.synchronize()
    rec = tracing.drain()      # every record so far, on the host's clock

Off, span() and call() return one shared no-op context, mark() and
replayed() return at once, and eager() and capturing() return the no-op
context: nothing is allocated, recorded or synchronised, and a graph
captured while the tracer is off holds exactly the nodes it would hold
without this module. Turn the tracer on before a step's first call: a
graph captured while it was off has no marks (its spans and intervals are
still recorded).

On:

- span(name) records (name, parent, request, start_ns, end_ns) on
  time.perf_counter_ns, for the whole run and not only a profiled slice,
  and while a profiler runs it also enters
  torch.profiler.record_function("svo." + name), so that inside a profiled
  slice it shares kineto's clock with the device's activities (outside
  one that range has no reader and would cost ~10 us a span).
  parent is the name of the innermost span open around it (None at the
  top); request is the top-level call's.
- call(name, device, request=None) is a top-level span (bootstrap,
  process, chunk, refine): its request, which every span inside it
  shares, is the caller's (process: the frame's index since start()) or
  else a count of the calls of that name. It also takes the call's device
  interval: a timing CUDA event recorded on the device's current stream
  as the call starts, before its first device work, and one as it ends,
  after its last. On the CPU the interval is the span's own bounds.
- mark(stage) sits at a boundary of the frame step (STAGES, then END; a
  stage runs from its mark to the next). It counts only inside a
  StepGraph launch. Captured, a mark is a timing event created with
  external=True, so the graph holds an event-record node that fires at
  every replay. A replay's marks are read at the graph's next replay if
  its last mark has already completed (query(), never a wait), else that
  sample is skipped and counted; drain() reads the last one. An eager
  launch on the card records fresh events, read in drain(). On the CPU a
  mark is a host timestamp of the eager run.

The hot path never waits on an event. Events are read in replayed() (only
completed ones) and in drain(), which synchronises each device it has
events on (the caller has usually just done so). Each event is put on the
host's perf_counter_ns clock through one anchor event a device, recorded
right after a synchronize: at enable() and reset() for the current device
once CUDA is initialised, else at the first call on a device (its one
extra synchronize). An anchor's host time is the middle of its record and
its completion, a few microseconds wide.

drain() returns and clears the records (JSON-ready; times in host ns):

    spans:         [[name, parent, request, start_ns, end_ns], ...] in order of start
    intervals:     [[name, request, start_ns, end_ns], ...] the calls' device intervals
    marks:         [[call, request, key, frames], ...] one sample a launch, its call's
                   name and request and the graph's key; frames: [[[stage, t_ns], ...],
                   ...], one list a frame step (a cadenced chunk has one a frame)
    marks_skipped: replays whose marks had not completed when the graph replayed again
    counters:      with the tracer on and only where one moved: {"<kernel>.launches":
                   n, "ransac_pnp.slots": n, "fast_nms.pixels": n}, what each of the
                   kernels' counters (_build.counters(): each kernel's launches, the
                   correspondence slots handed to the PnP kernel, the pixels the FAST
                   kernel scored) added since the tracer's last reset or drain,
                   replays included; slots over half the launches is S x N, the size
                   the PnP kernel ran at

Drain a long run now and then: every interval and eager mark holds its
events until it is read. The records are one process's, written by the
thread that drives the engines.
"""

from __future__ import annotations

import contextlib
import time

import torch

from svo_tpu_torch import _build

PREFIX = "svo."
# the frame step's stages in order (pipeline/frontend.step_body), and the
# mark that closes the step; "pnp" is the caller's ops before ransac_pnp,
# "pnp_kernel" the PnP kernel's launches and what follows them up to
# "replenish"
STAGES = ("pyramid", "klt", "pnp", "pnp_kernel", "replenish", "window_ba", "write")
END = "end"

_NOOP = contextlib.nullcontext()

_on = False
_open: list = []       # the open spans, innermost last
_spans: list = []
_intervals: list = []  # [name, request, device or None, start, end]: events, or host ns on the CPU
_samples: list = []    # the marks read so far
_pending: list = []    # _Marks with a run not yet read
_skipped = 0
_counts: dict = {}     # calls so far, by name (the default request)
_anchors: dict = {}    # device -> (event, host ns)
_sink = None           # the _Marks that mark() appends to
_base: dict = {}       # the counters' values at the last reset or drain


def _device(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _record(device: torch.device, external: bool = False):
    """A timing event recorded on the device's current stream."""
    ev = torch.cuda.Event(enable_timing=True, external=external)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _sync(device: torch.device) -> None:
    torch.cuda.synchronize(device)


def _anchor(device: torch.device) -> None:
    if device in _anchors:
        return
    _sync(device)
    t0 = time.perf_counter_ns()
    ev = _record(device)
    ev.synchronize()
    _anchors[device] = (ev, (t0 + time.perf_counter_ns()) // 2)


def _host_ns(device, t) -> int:
    """An event's time (or a host timestamp, device None) in host ns."""
    if device is None:
        return t
    ev, ns = _anchors[device]
    return ns + round(ev.elapsed_time(t) * 1e6)


def enable() -> None:
    """Turn the tracer on, with no records."""
    global _on
    _on = True
    reset()


def disable() -> None:
    """Turn the tracer off; what it recorded stays for drain()."""
    global _on
    _on = False


def reset() -> None:
    """Drop every record and unread mark, and (on) anchor the devices again."""
    global _skipped, _base
    for m in _pending:
        m.owner = None
    for lst in (_spans, _intervals, _samples, _pending):
        lst.clear()
    _skipped = 0
    _counts.clear()
    _base = _build.counters() if _on else {}
    devices = set(_anchors)
    _anchors.clear()
    if not _on:
        return
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        devices.add(_device("cuda"))
    for d in devices:
        _anchor(d)


class _Span:
    __slots__ = ("name", "call", "request", "parent", "rf", "t0", "t1")

    def __init__(self, name, call=None, request=None):
        self.name, self.call, self.request = name, call, request

    def __enter__(self):
        up = _open[-1] if _open else None
        self.parent = up.name if up else None
        if self.call is None and up is not None:
            self.call, self.request = up.call, up.request
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        _open.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        _open.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _spans.append([self.name, self.parent, self.request, self.t0, self.t1])
        return False


def span(name: str):
    """The host span `name` (the shared no-op while the tracer is off)."""
    return _Span(name) if _on else _NOOP


class _Call:
    __slots__ = ("span", "device", "ev0")

    def __init__(self, name, device, request):
        if request is None:
            request = _counts.get(name, 0)
            _counts[name] = request + 1
        self.span = _Span(name, name, request)
        self.device = _device(device)

    def __enter__(self):
        self.span.__enter__()
        if self.device.type == "cuda":
            _anchor(self.device)
            self.ev0 = _record(self.device)
        return self

    def __exit__(self, *exc):
        s = self.span
        if self.device.type == "cuda":
            _intervals.append([s.name, s.request, self.device, self.ev0, _record(self.device)])
        s.__exit__(*exc)
        if self.device.type != "cuda":
            _intervals.append([s.name, s.request, None, s.t0, s.t1])
        return False


def call(name: str, device, request=None):
    """A top-level call on `device`: its span and its device interval (the
    shared no-op while the tracer is off)."""
    return _Call(name, device, request) if _on else _NOOP


class _Marks:
    """The marks of one graph (its events, recorded at every replay) or of
    one eager launch; owner: (call, request) of its run not yet read."""

    __slots__ = ("key", "device", "stamps", "owner")

    def __init__(self, key, device):
        self.key, self.device, self.stamps, self.owner = key, _device(device), [], None


def mark(stage: str) -> None:
    """The frame step reached `stage` (a no-op outside a StepGraph launch)."""
    if not _on or _sink is None:
        return
    if _sink.device.type == "cuda":
        _sink.stamps.append((stage, _record(_sink.device, external=True)))
    else:
        _sink.stamps.append((stage, time.perf_counter_ns()))


def _owner() -> tuple:
    s = _open[-1] if _open else None
    return (s.call, s.request) if s is not None else (None, None)


def _read(m: _Marks) -> None:
    """A completed run's marks into the samples."""
    dev = m.device if m.device.type == "cuda" else None
    frames: list = []
    for stage, t in m.stamps:
        if stage == STAGES[0] or not frames:
            frames.append([])
        frames[-1].append([stage, _host_ns(dev, t)])
    call_name, request = m.owner
    _samples.append([call_name, request, m.key, frames])
    m.owner = None


class _Sink:
    __slots__ = ("marks", "run", "prev")

    def __init__(self, marks: _Marks, run: bool):
        self.marks, self.run = marks, run

    def __enter__(self):
        global _sink
        self.prev, _sink = _sink, self.marks
        return self.marks

    def __exit__(self, exc_type, *exc):
        global _sink
        _sink = self.prev
        m = self.marks
        if self.run and exc_type is None and m.stamps:
            m.owner = _owner()
            if m.device.type == "cuda":
                _pending.append(m)
            else:
                _read(m)
        return False


def eager(key, device):
    """The marks of an eager launch of the step `key` (the no-op while the
    tracer is off)."""
    if not _on:
        return _NOOP
    device = _device(device)
    if device.type == "cuda":
        _anchor(device)
    return _Sink(_Marks(key, device), run=True)


def capturing(key, device):
    """Collects the marks of a graph being captured; enter it before the
    capture begins. Its value (None while the tracer is off) goes to
    replayed() at each replay of the graph."""
    return _Sink(_Marks(key, device), run=False) if _on else _NOOP


def replayed(marks) -> None:
    """Before a replay of the graph whose marks are `marks`: its last
    replay's marks are read if the last of them has completed, else counted
    as skipped; this replay's belong to the call now open."""
    global _skipped
    if not _on or marks is None or not marks.stamps:
        return
    if marks.owner is None:
        _anchor(marks.device)
        _pending.append(marks)
    elif marks.stamps[-1][1].query():
        _read(marks)
    else:
        _skipped += 1
    marks.owner = _owner()


def drain() -> dict:
    """Every record so far (module docstring), read and cleared."""
    global _skipped, _base
    for d in _anchors:
        _sync(d)
    for m in _pending:
        if m.owner is not None:
            _read(m)
    out = {
        "spans": sorted(_spans, key=lambda s: s[3]),
        "intervals": [[name, request, _host_ns(d, a), _host_ns(d, b)]
                      for name, request, d, a, b in _intervals],
        "marks": list(_samples),
        "marks_skipped": _skipped,
    }
    if _on:
        now = _build.counters()
        moved = {k: v - _base.get(k, 0) for k, v in now.items() if v != _base.get(k, 0)}
        if moved:
            out["counters"] = moved
        _base = now
    for lst in (_spans, _intervals, _samples, _pending):
        lst.clear()
    _skipped = 0
    return out
