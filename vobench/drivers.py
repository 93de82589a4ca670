"""The two driver kinds a traffic file names: `fleet_chunk` (S streams in
lockstep through BatchedStereoVO.process_chunk, optionally refine()) and
`live_frames` (one stream frame by frame through StereoVO.process, each
pose read to the host).

Each driver builds the program's engine, warms up every branch key and
regime its window will meet, and runs the timed window: streams restart
at the end of the sequence (a new pass, a new PnP seed), as a new drive
does. The window is closed: the next chunk or frame is handed in only as
the program keeps up (a fleet keeps `in_flight` chunks queued on the card;
a live stream waits for each pose).

For the output check the window keeps a sample of its units (a chunk, or
the chunks between two sweeps with the sweep; `check_frames` frames of a
live stream), drawn from the seed by reservoir sampling over every unit it
runs, plus the first unit of the first pass, which starts from the
bootstrap. Each kept unit holds the program's state before it (a device
copy) and after it; check.py works the unit out again with the reference.
A cell with the window BA, live or fleet, also keeps `check_ba_units`
units in which a frame ran the BA (which frames run it follows from the
BA rule on the host: ba_runs, chunk_schedules).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from vobench.trace import span

PASS_SEED_STRIDE = 1_000_003


def pass_seed(seed: int, p: int) -> int:
    """The PnP seed of pass p (stream s of a fleet adds s), 32 bits."""
    return (seed + PASS_SEED_STRIDE * p) & 0xFFFFFFFF


class Reservoir:
    """k items drawn uniformly from a stream of unknown length."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.n = k, rng, 0
        self.items: list = []

    def offer(self) -> int | None:
        """The slot the next item takes, or None if it is not kept."""
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = int(self.rng.integers(self.n))
        return j if j < self.k else None


@dataclass
class Unit:
    pass_index: int
    frame0: int            # the pass's first frame in the unit (frame ids frame0 ..)
    n_frames: int
    seed: int              # the pass's PnP seed
    before: object         # the program's state before the unit; None: the bootstrap
    after: object = None   # and after it
    mid: object = None     # fleet with refine(): the state before the unit's sweep
    chunks: tuple = ()     # fleet: the pass's chunk indices
    refine: bool = False   # fleet: a sweep closes the unit
    has_ba: bool = False   # a frame of the unit ran the window BA


@dataclass
class Window:
    frames: int = 0                    # every stream's frames stepped
    seconds: float = 0.0
    passes: int = 0
    pass_end_s: list = field(default_factory=list)     # seconds into the window each pass ended
    nonfinite: int = 0                 # frames whose pose came back non-finite
    latencies_ms: list = field(default_factory=list)   # live: every frame
    host_ms: list = field(default_factory=list)        # live: process() until it returned
    frame_class: list = field(default_factory=list)    # live: (is_kf, is_ba) a frame
    in_slice: list = field(default_factory=list)       # live: frame inside the profiled slice
    slice_s: float = 0.0               # live: the slice's seconds, its opening sync to the profiler's stop
    sweep_ms: list = field(default_factory=list)
    chunk_ms: list = field(default_factory=list)       # fleet with the BA: [ms, ran_ba] a chunk
    first_pass_poses: np.ndarray | None = None
    prof: object = None
    slice_steps: int = 0
    slice_metrics: np.ndarray | None = None   # fleet: (S, steps + 1, 5) rows from the frame before


class Slots:
    """Device copies of the program's state, allocated once after the
    warm-up, so that keeping a unit for the check allocates nothing in the
    window and adds a constant to the memory peak."""

    def __init__(self, state, n: int):
        from svo_tpu_torch.pipeline.state import clone, leaves

        self._leaves = leaves
        self.bufs = [clone(state) for _ in range(n)]

    def copy(self, i: int, state):
        """Buffer i <- state (one multi-tensor copy); returns buffer i."""
        torch._foreach_copy_(self._leaves(self.bufs[i]), self._leaves(state))
        return self.bufs[i]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    return profile(activities=acts)


def warm_profiler(device) -> None:
    """Start and stop the profiler once in set-up, so the traced slice does
    not pay its first start."""
    prof = _profiler(device)
    prof.start()
    torch.ones(8, device=device).sum()
    _sync(device)
    prof.stop()


def _drop_open_slice(win: Window, slice_span, device) -> None:
    """A window that closed inside its profiled slice: the profiler is
    stopped and the slice dropped (its metrics then have nothing to read)."""
    if slice_span is None:
        return
    _sync(device)
    slice_span.__exit__(None, None, None)
    win.prof.stop()
    win.prof = None


def captures(*steps) -> int:
    """Graphs captured so far by the program's captured steps (StepGraph's
    `graphs`), 0 for an eager step."""
    return sum(len(getattr(s, "graphs", {})) for s in steps if s is not None)


def _nonfinite_frames(poses: np.ndarray) -> int:
    """Frames of a (..., F, 4, 4) trajectory with a non-finite pose."""
    return int((~np.isfinite(poses).all(axis=(-1, -2))).sum())


def ba_runs(ba, kf: np.ndarray, kf_count: int) -> tuple[np.ndarray, int]:
    """Which of these frames run the window BA by its rule (a keyframe
    whose keyframe count has reached ba.window and is a multiple of
    ba.interval), from their keyframe flags and the pass's count before
    them; and the count after them."""
    counts = kf_count + np.cumsum(kf)
    run = kf & (counts >= ba.window) & (counts % ba.interval == 0) if ba.enabled else kf & False
    return run, int(counts[-1]) if len(counts) else kf_count


def chunk_schedules(ba, n_chunks: int, chunk: int, cadence: int) -> list[tuple]:
    """The BA schedule of each cadenced chunk of a pass from the bootstrap,
    worked out on the host: for each keyframe step of the chunk (the first
    of every `cadence` frames), whether it runs the window BA. It is the key
    frontend._ba_schedule reads on the device a chunk, so the set of these is
    the set of chunk graphs a pass captures."""
    kf = np.arange(n_chunks * chunk) % cadence == 0
    run, _ = ba_runs(ba, kf, 1)  # the bootstrap frame is a keyframe
    return [tuple(bool(x) for x in run[c * chunk: (c + 1) * chunk][kf[:chunk]])
            for c in range(n_chunks)]


class Fleet:
    """`fleet_chunk`: S streams in lockstep, cadenced chunks staged on the
    card as uint8, stream s forward when even (or always, reverse_odd
    false), reversed when odd. With the window BA the chunks that run it
    follow from the BA rule (chunk_schedules), and each chunk's device
    interval is timed."""

    def __init__(self, traffic: dict, seq, seed: int, cfg, camera, device, lk_engine):
        from svo_tpu_torch.parallel.batched import BatchedStereoVO

        t = traffic
        self.t, self.seq, self.seed, self.device = t, seq, seed, device
        self.S, self.K, self.cad = t["streams"], t["chunk"], t["cadence"]
        self.N = seq.left.shape[0]
        self.n_chunks = (self.N - 1) // self.K
        self.per = t["refine_every"] or 1
        if self.n_chunks % self.per:
            raise ValueError(f"{self.n_chunks} chunks a pass are not whole units of {self.per}")
        self.n_units = self.n_chunks // self.per
        self.idx = self.index()
        self.l0, self.r0 = seq.left[self.idx[0]], seq.right[self.idx[0]]
        self.chunks = [self.chunk_frames(c) for c in range(self.n_chunks)]
        self.ba = cfg.ba.enabled
        self.schedules = chunk_schedules(cfg.ba, self.n_chunks, self.K, self.cad)
        self.n_ba = t.get("check_ba_units", 0) if self.ba else 0
        kw = {} if lk_engine is None else {"lk_engine": lk_engine}
        self.vo = BatchedStereoVO(cfg, camera, self.S, chunk=self.K, kf_cadence=self.cad,
                                  device=device, **kw)
        self.lk_engine = self.vo.lk_engine
        if t["refine_every"]:
            self.vo.make_refiner()

    def index(self) -> torch.Tensor:
        """(frames a pass, S) sequence frame of pass frame t for stream s."""
        t = torch.arange(1 + self.n_chunks * self.K, device=self.seq.left.device)
        cols = [self.N - 1 - t if (s % 2 and self.t["reverse_odd"]) else t for s in range(self.S)]
        return torch.stack(cols, dim=1)

    def chunk_frames(self, c: int) -> tuple[torch.Tensor, torch.Tensor]:
        ids = self.idx[1 + c * self.K: 1 + (c + 1) * self.K]
        return self.seq.left[ids], self.seq.right[ids]

    def seeds(self, ps: int) -> list[int]:
        return [(ps + s) & 0xFFFFFFFF for s in range(self.S)]

    def steps(self):
        return (self.vo._chunk_step, getattr(self.vo.refiner, "graph", None))

    def warm(self) -> None:
        """The bootstrap, the chunk graph (with the window BA: the first
        pass's chunks until every BA schedule a pass meets was captured)
        and, where the cell refines, both regimes of the refiner (captured
        at its first call)."""
        self.vo.start(self.l0, self.r0, seed=pass_seed(self.seed ^ 0x5EED, 0))
        step = self.vo._chunk_step
        graphs = step.graphs if getattr(step, "capture", False) else None  # None: eager (CPU)
        need = set(self.schedules) if self.ba and graphs is not None else set()
        c = 0
        while c < self.per or not need <= set(graphs or ()):
            if c == self.n_chunks:
                raise RuntimeError(f"warm-up met schedules {sorted(graphs)}, not all of "
                                   f"{sorted(need)}")
            self.vo.process_chunk(*self.chunks[c])
            c += 1
        if self.t["refine_every"]:
            self.vo.refine()
        # the bootstrap unit's after-state (and state before its sweep), and
        # each sampled unit's two (three)
        self.per_unit = 3 if self.t["refine_every"] else 2
        self.slots = Slots(self.vo.state,
                           self.per_unit * (1 + self.t["check_units"] + self.n_ba))
        _sync(self.device)

    def window(self, seconds: float, trace: bool) -> Window:
        t, S, K, vo = self.t, self.S, self.K, self.vo
        rng = np.random.default_rng([self.seed, 1])
        res = Reservoir(t["check_units"], rng)
        res_ba = Reservoir(self.n_ba, rng)
        timed = self.ba and self.device.type == "cuda"
        chunk_events = []
        self.boot: Unit | None = None
        win = Window()
        lo, hi = t["trace_skip"], t["trace_skip"] + t["trace_units"]
        in_flight: deque = deque()
        sweeps = []
        slice_span = None
        t0 = time.perf_counter()
        deadline = t0 + seconds
        stop, p = False, 0
        while not stop:
            ps = pass_seed(self.seed, p)
            with span("bootstrap"):
                vo.start(self.l0, self.r0, seed=ps)
            for u in range(self.n_units):
                if time.perf_counter() >= deadline:
                    stop = True
                    break
                tracing = trace and p == 0 and lo <= u < hi
                if tracing and u == lo:
                    _sync(self.device)
                    win.prof = _profiler(self.device)
                    win.prof.start()
                    slice_span = span("slice")
                    slice_span.__enter__()
                boot = p == 0 and u == 0
                chunks = tuple(range(u * self.per, (u + 1) * self.per))
                has_ba = any(any(self.schedules[c]) for c in chunks)
                # a unit that runs the BA goes to the BA sample first
                slot, pool, first = None, res, 1
                if not boot and has_ba:
                    slot, pool, first = res_ba.offer(), res_ba, 1 + t["check_units"]
                if not boot and slot is None:
                    slot, pool, first = res.offer(), res, 1
                keep = boot or slot is not None
                base = self.per_unit * (0 if boot else first + slot) if keep else 0
                unit = None
                if keep:
                    with span("snapshot"):
                        unit = Unit(p, 1 + chunks[0] * K, len(chunks) * K, ps,
                                    None if boot else self.slots.copy(base, vo.state),
                                    chunks=chunks, refine=bool(t["refine_every"]),
                                    has_ba=has_ba)
                for c in chunks:
                    if len(in_flight) >= t["in_flight"]:
                        with span("in_flight_wait"):
                            in_flight.popleft().synchronize()
                    start = torch.cuda.Event(enable_timing=True) if timed else None
                    if start is not None:
                        start.record()
                    with span("step"):
                        vo.process_chunk(*self.chunks[c])
                    ev = torch.cuda.Event(enable_timing=timed) if self.device.type == "cuda" else None
                    if ev is not None:
                        ev.record()
                        in_flight.append(ev)
                    if start is not None:
                        chunk_events.append((start, ev, any(self.schedules[c])))
                    win.frames += S * K
                if t["refine_every"]:
                    if unit is not None:
                        with span("snapshot"):
                            unit.mid = self.slots.copy(base + 2, vo.state)
                    if tracing:
                        _sync(self.device)  # the sweep's activities start inside its span
                    with span("refine"):
                        if self.device.type == "cuda":
                            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                            a.record()
                            vo.refine()
                            b.record()
                            sweeps.append((a, b))
                        else:
                            vo.refine()
                if unit is not None:
                    with span("snapshot"):
                        unit.after = self.slots.copy(base + 1, vo.state)
                    if boot:
                        self.boot = unit
                    else:
                        pool.items[slot] = unit
                if tracing and u == hi - 1:
                    _sync(self.device)
                    slice_span.__exit__(None, None, None)
                    slice_span = None
                    ts = time.perf_counter()
                    win.prof.stop()
                    deadline += time.perf_counter() - ts  # the trace's processing
                    f0, f1 = 1 + lo * self.per * K, (u + 1) * self.per * K
                    win.slice_steps = f1 - f0 + 1
                    win.slice_metrics = vo.state.metrics[:, f0 - 1: f1 + 1].cpu().numpy()
            else:
                poses = vo.state.poses[:, : 1 + self.n_chunks * K]
                host = poses.cpu().numpy()
                win.nonfinite += _nonfinite_frames(host[:, 1:])
                if p == 0:
                    win.first_pass_poses = host
                win.pass_end_s.append(time.perf_counter() - t0)
                p += 1
        _drop_open_slice(win, slice_span, self.device)
        _sync(self.device)
        win.seconds = time.perf_counter() - t0
        win.passes = p
        done = (win.frames // S) - p * self.n_chunks * K
        if done:
            win.nonfinite += _nonfinite_frames(vo.state.poses[:, 1: 1 + done].cpu().numpy())
        win.sweep_ms = [a.elapsed_time(b) for a, b in sweeps]
        win.chunk_ms = [[a.elapsed_time(b), ran_ba] for a, b, ran_ba in chunk_events]
        kept = ([self.boot] if self.boot else []) + res.items + res_ba.items
        self.units = [u for u in kept if u is not None]
        return win

    def free(self) -> None:
        del self.vo, self.chunks


class Live:
    """`live_frames`: one stream handed host uint8 frame pairs one at a time
    through StereoVO.process (the dynamic keyframe rule, as run_kitti runs
    it), each pose read to the host before the next frame."""

    def __init__(self, traffic: dict, seq, seed: int, cfg, camera, device, lk_engine):
        from svo_tpu_torch.pipeline.odometry import StereoVO

        t = traffic
        if t["streams"] != 1:
            raise ValueError(f"live_frames runs one stream, not {t['streams']}")
        self.t, self.seed, self.device, self.cfg = t, seed, device, cfg
        self.left = seq.left.cpu().numpy()    # what a reader hands the engine
        self.right = seq.right.cpu().numpy()
        self.seq_device = seq.left.device  # where the reference gets them again
        self.N = self.left.shape[0]
        self.L = t["check_frames"]
        self.n_units = (self.N - 1) // self.L
        kw = {} if lk_engine is None else {"lk_engine": lk_engine}
        self.vo = StereoVO(cfg, camera, seed=0, device=device, **kw)
        self.lk_engine = self.vo.lk_engine
        ba = cfg.ba.enabled
        self.keys = {(False, False), (True, False)} | ({(True, True)} if ba else set())

    def steps(self):
        return (self.vo._step,)

    def _frame(self, f: int) -> tuple[np.ndarray, float]:
        """The frame's pose, and the seconds process() took to return (host
        prep, H2D, the key read, the replay's launch; the pose read waits
        for the replay)."""
        with span("frame"):
            with span("step"):
                t0 = time.perf_counter()
                self.vo.process(self.left[f], self.right[f])
                host_s = time.perf_counter() - t0
            with span("pose_read"):
                return self.vo.state.pose.cpu().numpy(), host_s

    def warm(self) -> None:
        """Frames of a pass until every branch key the window meets (no
        keyframe; keyframe; keyframe with the window BA) was captured."""
        self.vo.seed = pass_seed(self.seed ^ 0x5EED, 0)
        self.vo.start(self.left[0], self.right[0])
        step = self.vo._step
        graphs = step.graphs if getattr(step, "capture", False) else None  # None: eager (CPU)
        for f in range(1, self.N):
            self._frame(f)
            if graphs is None or self.keys <= set(graphs):
                break
        else:
            raise RuntimeError(f"warm-up met keys {sorted(graphs)}, not all of {sorted(self.keys)}")
        # the unit in progress's before-state, the bootstrap unit's after-state,
        # and each sampled unit's two
        n_ba = self.t["check_ba_units"] if self.cfg.ba.enabled else 0
        self.slots = Slots(self.vo.state, 2 + 2 * (self.t["check_units"] + n_ba))
        _sync(self.device)

    def window(self, seconds: float, trace: bool) -> Window:
        t, vo, L = self.t, self.vo, self.L
        rng = np.random.default_rng([self.seed, 1])
        res = Reservoir(t["check_units"], rng)
        res_ba = Reservoir(t["check_ba_units"] if self.cfg.ba.enabled else 0, rng)
        self.boot = None
        win = Window()
        lo, hi = t["trace_skip"], t["trace_skip"] + t["trace_frames"]
        slice_span = None
        t0 = time.perf_counter()
        deadline = t0 + seconds
        stop, p = False, 0
        while not stop:
            ps = pass_seed(self.seed, p)
            vo.seed = ps
            with span("bootstrap"):
                vo.start(self.left[0], self.right[0])
            kf_count = 1  # the bootstrap frame is a keyframe
            for u in range(self.n_units):
                f0 = 1 + u * L
                boot = p == 0 and u == 0
                if not boot:
                    with span("snapshot"):
                        self.slots.copy(0, vo.state)
                done = 0
                for f in range(f0, f0 + L):
                    if time.perf_counter() >= deadline:
                        stop = True
                        break
                    tracing = trace and p == 0 and lo <= f < hi
                    if tracing and f == lo:
                        t_slice = time.perf_counter()
                        _sync(self.device)
                        win.prof = _profiler(self.device)
                        win.prof.start()
                        slice_span = span("slice")
                        slice_span.__enter__()
                    ts = time.perf_counter()
                    pose, host_s = self._frame(f)
                    win.latencies_ms.append((time.perf_counter() - ts) * 1e3)
                    win.host_ms.append(host_s * 1e3)
                    win.in_slice.append(tracing)
                    win.nonfinite += int(not np.isfinite(pose).all())
                    win.frames += 1
                    done += 1
                    if tracing and f == hi - 1:
                        _sync(self.device)
                        slice_span.__exit__(None, None, None)
                        slice_span = None
                        ts = time.perf_counter()
                        win.prof.stop()
                        deadline += time.perf_counter() - ts  # the trace's processing
                        win.slice_s = time.perf_counter() - t_slice
                if not done:
                    break
                with span("snapshot"):
                    kf = vo.state.kf_flags[f0: f0 + done].cpu().numpy()
                run_ba, kf_count = ba_runs(self.cfg.ba, kf, kf_count)
                win.frame_class.extend(zip(kf.tolist(), run_ba.tolist()))
                if stop:
                    break
                has_ba = bool(run_ba.any())
                if boot:
                    with span("snapshot"):
                        self.boot = Unit(p, f0, L, ps, None, self.slots.copy(1, vo.state),
                                         has_ba=has_ba)
                    continue
                # a unit that ran the BA goes to the BA sample first
                slot, base = (res_ba.offer(), 2 + 2 * t["check_units"]) if has_ba else (None, 0)
                pool = res_ba
                if slot is None:
                    slot, base, pool = res.offer(), 2, res
                if slot is not None:
                    with span("snapshot"):
                        unit = Unit(p, f0, L, ps, None, has_ba=has_ba)
                        unit.before = self.slots.copy(base + 2 * slot, self.slots.bufs[0])
                        unit.after = self.slots.copy(base + 2 * slot + 1, vo.state)
                    pool.items[slot] = unit
            else:
                if p == 0:
                    win.first_pass_poses = vo.state.poses[: self.N].cpu().numpy()
                win.pass_end_s.append(time.perf_counter() - t0)
                p += 1
        _drop_open_slice(win, slice_span, self.device)
        _sync(self.device)
        win.seconds = time.perf_counter() - t0
        win.passes = p
        kept = ([self.boot] if self.boot else []) + res.items + res_ba.items
        self.units = [u for u in kept if u is not None]
        return win

    def free(self) -> None:
        del self.vo


DRIVERS = {"fleet_chunk": Fleet, "live_frames": Live}
