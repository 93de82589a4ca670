"""Measuring on the card: one timer, one profiler reading, the card's name.

Shared by chip_smoke.py and track_times.py. Imports nothing of the package,
so track_times.py can load this file beside a package from another tree.
"""

from __future__ import annotations

import subprocess

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


def device_events(fn) -> list:
    """The profiler's records of every device activity (kernels, fills and
    copies) of one call of fn, by name: each has .key, .count and
    .self_device_time_total (microseconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def smi_line() -> str:
    """The card's name and power limit, exactly as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
