"""Median latency of the traced window's frames that neither keyframed nor
ran the window BA (outside the profiled slice), ms."""

from vobench.metrics_common import median_latency


def read(rec):
    return median_latency(rec, lambda kf, ba: not kf)
