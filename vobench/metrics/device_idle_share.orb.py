"""Share of the profiled slice's wall in which no device activity ran, %
(metrics_common.idle_share)."""

from vobench.metrics_common import idle_share as read  # noqa: F401
