"""95th percentile of the traced window's frame latency, its profiled
slice left out, ms (metrics_common.latency_p95): the ORB cell's tail, too
unsteady from run to run to bound end to end."""

from vobench.metrics_common import latency_p95 as read  # noqa: F401
