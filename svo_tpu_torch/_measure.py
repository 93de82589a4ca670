"""Measuring on the card: three timers, one profiler reading, the card's name.

Shared by chip_smoke.py, track_times.py, multihost_ba_worker.py and the
timing tools. Imports nothing of the package, so track_times.py can load
this file beside a package from another tree.
"""

from __future__ import annotations

import subprocess
import time
from types import SimpleNamespace

import numpy as np
import torch


def median_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Median over `reps` samples of the mean time of `inner` back-to-back
    calls, from CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return float(np.median(samples))


def mean_ms(fn, device, reps: int = 10) -> float:
    """Mean ms per call of `reps` back-to-back calls after one warm-up call:
    between CUDA events on the card, on the host clock on the CPU."""
    fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def per_second(fn, work: int, reps: int = 10, device="cuda") -> float:
    """`work` units per call of fn, per second of wall over `reps` calls
    after one warm-up, the device synchronised at both ends."""
    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return work * reps / (time.perf_counter() - t0)


def device_events(fn) -> list:
    """The profiler's records of every device activity (kernels, fills and
    copies) of one call of fn, by name: each has .key, .count,
    .self_device_time_total (microseconds) and .first_ns / .last_ns, where
    the name's first activity began and its last ended (the span of the
    call's device work is from the least first_ns to the largest last_ns).
    Read from the trace's raw
    records: key_averages() would first build the tree of every host op,
    which takes tens of seconds for one frame step's ~7,700 activities and
    their ops, and gives the same counts and times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        rec = by_name.get(e.name())
        if rec is None:
            rec = by_name[e.name()] = SimpleNamespace(key=e.name(), count=0,
                                                      self_device_time_total=0.0,
                                                      first_ns=e.start_ns(), last_ns=e.end_ns())
        rec.count += 1
        rec.first_ns, rec.last_ns = min(rec.first_ns, e.start_ns()), max(rec.last_ns, e.end_ns())
        if not (e.is_async() or e.start_thread_id() != e.end_thread_id()):
            rec.self_device_time_total += e.duration_ns() / 1e3  # as key_averages()
    return list(by_name.values())


def device_name(device) -> str:
    """What a result names its device by: the card's smi_line(), or the
    torch device (`cpu`)."""
    device = torch.device(device)
    return smi_line() if device.type == "cuda" else str(device)


def smi_line() -> str:
    """The card's name and power limit, exactly as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
