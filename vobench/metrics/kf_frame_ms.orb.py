"""Median latency of the traced window's keyframe frames that did not run
the window BA (outside the profiled slice), ms."""

from vobench.metrics_common import median_latency


def read(rec):
    return median_latency(rec, lambda kf, ba: kf and not ba)
