"""The traced slice: device activities and the benchmark's own host spans
from torch.profiler, and the arithmetic every per-layer metric shares.

A traced run profiles a short fixed slice of its window (traffic files:
trace_skip, trace_units / trace_frames). What the profiler recorded is kept
as plain lists, so a recorded slice can be saved and read again (the
tests' fixture):

    activities: [name, start_ns, end_ns] of every device activity
                (kernels, copies, fills)
    spans:      [name, start_ns, end_ns] of the benchmark's record_function
                ranges, named "vobench.<what>" (bootstrap, step, refine,
                frame, pose_read, snapshot, in_flight_wait)

Device busy time is the length of the union of the activity intervals, so
overlapping activities are not counted twice. The slice's wall runs from
its first device activity to the close of its span: the slice opens on a
synchronize, and the time the host then takes to issue the first launch
is the harness's own, not the program's (a fleet keeps chunks in flight,
so in the untimed window that launch overlaps the chunk before it).
"""

from __future__ import annotations

import re

import torch

SPAN_PREFIX = "vobench."


def span(what: str):
    """The benchmark's host range `what` (a profiler annotation; nearly
    free while no profiler runs)."""
    return torch.profiler.record_function(SPAN_PREFIX + what)


def collect(prof) -> tuple[list, list]:
    """(activities, spans) of a finished torch.profiler.profile."""
    from torch.autograd import DeviceType

    acts, spans = [], []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(SPAN_PREFIX):
            # the profiler mirrors each host range onto the device's
            # timeline as an annotation: not an activity of the device
            if e.device_type() == DeviceType.CUDA:
                continue
            spans.append([e.name()[len(SPAN_PREFIX):], e.start_ns(), e.end_ns()])
        elif e.device_type() == DeviceType.CUDA:
            acts.append([e.name(), e.start_ns(), e.end_ns()])
    acts.sort(key=lambda a: a[1])
    spans.sort(key=lambda s: s[1])
    return acts, spans


def slice_bounds(acts: list, span: list) -> tuple[int, int]:
    """(t0, t1) of the slice whose host span is `span` ([name, start,
    end]): t0 the first device activity that starts inside it (the span's
    start if none does), t1 the span's end."""
    starts = [a[1] for a in acts if span[1] <= a[1] <= span[2]]
    return (min(starts) if starts else span[1]), span[2]


def union(intervals) -> list[list[int]]:
    """The union of [start, end] intervals, sorted and merged."""
    out: list[list[int]] = []
    for s, e in sorted((a[-2], a[-1]) for a in intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_ns(intervals, lo: int, hi: int) -> int:
    """ns inside [lo, hi] in which some interval is open."""
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e in union(intervals))


def spans_named(rec: dict, name: str) -> list:
    return [s for s in rec["slice"]["spans"] if s[0] == name]


def step_activities(rec: dict) -> list:
    """The slice's activities of the frame steps: all of them, less those
    of refine sweeps (a traced slice waits for the device before each
    sweep, so a sweep's activities start inside its span)."""
    sweeps = spans_named(rec, "refine")
    return [a for a in rec["slice"]["activities"]
            if not any(s <= a[1] <= e for _, s, e in sweeps)]


def short_name(name: str) -> str:
    """A kernel's name without return type, template arguments and
    parameter list, at most 120 characters."""
    name = re.sub(r"^void ", "", name)
    prev = None
    while prev != name:
        prev, name = name, re.sub(r"<[^<>]*>", "", name)
    name = re.sub(r"\(.*\)$", "", name).replace("(anonymous namespace)::", "")
    return name[:120]


def breakdown(rec: dict, top: int = 10) -> dict:
    """The slice's device operations that took most time, and its longest
    idle gaps labelled by the innermost benchmark span open on the host
    when each began."""
    sl = rec["slice"]
    t0, t1 = sl["t0"], sl["t1"]
    by_name: dict = {}
    for name, s, e in sl["activities"]:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, cur = [], t0
    for s, e in union(sl["activities"]) + [[t1, t1]]:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    labelled = []
    for s, e in gaps:
        open_spans = [sp for sp in sl["spans"] if sp[1] <= s < sp[2]]
        # the innermost: the latest to open, of those the first to close
        label = max(open_spans, key=lambda sp: (sp[1], -sp[2]))[0] if open_spans else "none"
        labelled.append([label, (e - s) / 1e9])
    labelled.sort(key=lambda g: -g[1])
    return {"device_ops": [[k, v / 1e9] for k, v in ops], "idle_gaps": labelled[:top]}
