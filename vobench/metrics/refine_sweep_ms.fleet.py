"""Median of the refine() sweeps of the traced window, each between CUDA
events recorded on the stream around it, ms."""

import statistics


def read(rec):
    return statistics.median(rec["sweep_ms"]) if rec["sweep_ms"] else None
