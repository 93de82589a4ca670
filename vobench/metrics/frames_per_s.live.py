"""Frames a second of the traced window, its profiled slice left out
(metrics_common.live_rate): kitti00-fast.live1's rate, too unsteady from
run to run to bound end to end."""

from vobench.metrics_common import live_rate as read  # noqa: F401
