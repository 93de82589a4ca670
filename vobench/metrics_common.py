"""Arithmetic that several per-layer metrics (metrics/*.py) share. A live
cell's metrics come in two names, `.live` for kitti00-fast.live1 (they move
frame_latency_p95_ms) and `.orb` for kitti00-orb-ba.live1 (they move
frames_per_s, its p95 being too unsteady to bound); each pair reads alike."""

from __future__ import annotations

import statistics

import numpy as np

from vobench.trace import busy_ns


def median_latency(rec: dict, keep) -> float | None:
    """Median latency (ms) of the window's frames outside the profiled
    slice for which keep(is_kf, is_ba) holds; None if there are none."""
    got = [f[0] for f in rec["frames"] if not f[3] and keep(f[1], f[2])]
    return statistics.median(got) if got else None


def median_host_ms(rec: dict) -> float | None:
    """Median over the traced window's frames (outside the profiled slice)
    of the host's part of a frame: the time process() takes to return, which
    is host prep, the frame's H2D copy, the branch key's computation and
    read, and the replay's launch (the replay runs after it returns; the
    pose read waits for it), ms."""
    got = [f[4] for f in rec["frames"] if not f[3]]
    return statistics.median(got) if got else None


def idle_share(rec: dict) -> float | None:
    """Share of the profiled slice's wall in which no device activity ran, %."""
    sl = rec["slice"]
    if not sl or sl["t1"] <= sl["t0"]:
        return None
    busy = busy_ns(sl["activities"], sl["t0"], sl["t1"])
    return 100.0 * (1.0 - busy / (sl["t1"] - sl["t0"]))


def latency_p95(rec: dict) -> float | None:
    """95th percentile of the latency of the traced window's frames outside
    the profiled slice, ms."""
    got = [f[0] for f in rec["frames"] if not f[3]]
    return float(np.percentile(got, 95)) if got else None


def live_rate(rec: dict) -> float | None:
    """Frames a second of the traced window with its profiled slice left
    out: the frames outside the slice over the window's seconds less the
    slice's (from its opening synchronize until the profiler has stopped)."""
    w = rec.get("window")
    n = sum(1 for f in rec["frames"] if not f[3])
    if not w or not n or w["seconds"] <= w["slice_s"]:
        return None
    return n / (w["seconds"] - w["slice_s"])


def median_chunk_ms(rec: dict, ran_ba: bool) -> float | None:
    """Median of a fleet window's chunk intervals (rec["chunk_ms"]: [ms,
    ran_ba] a chunk, recorded in cells with the window BA) over the chunks
    that ran the BA (ran_ba true) or did not, ms; None if there are none."""
    got = [ms for ms, ba in rec["chunk_ms"] if ba == ran_ba]
    return statistics.median(got) if got else None
