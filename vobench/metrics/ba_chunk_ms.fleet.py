"""Median device interval of the window's chunks that ran the window BA,
each between CUDA events recorded on the stream around process_chunk, ms
(metrics_common.median_chunk_ms)."""

from vobench.metrics_common import median_chunk_ms


def read(rec):
    return median_chunk_ms(rec, True)
