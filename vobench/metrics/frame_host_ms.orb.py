"""Median host part of a frame, ms (metrics_common.median_host_ms)."""

from vobench.metrics_common import median_host_ms as read  # noqa: F401
