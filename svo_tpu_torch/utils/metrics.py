"""Structured metrics and run summaries.

A copy of svo_tpu/utils/metrics.py (tests/test_torch_io.py holds the two
equal). The reference's observability is printf in the hot loop
(src/tracking.cpp:261-266) plus an unused printSummary helper
(src/utils.cpp:51-75, max/min/avg frame time + peak RAM, Windows-only).
Here: per-frame records as JSONL (the same observables: feature count,
inlier ratio, map points, KF flag) plus a run summary with timing
percentiles and peak RSS (portable, not Windows-only).
"""

from __future__ import annotations

import json
import resource
import time


def peak_rss_mb() -> float:
    """Peak resident set size of this process in MB (the portable analogue of
    the reference's Windows-only getCurrentlyUsedRAM, src/utils.cpp:30-49)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def write_frame_records(path: str, result) -> None:
    """Dump per-frame metrics of a RunResult as JSONL."""
    with open(path, "w") as f:
        for i in range(result.n_frames):
            m = result.metrics[i]
            f.write(
                json.dumps(
                    {
                        "frame": i,
                        "n_tracked": int(m[0]),
                        "inlier_ratio": round(float(m[1]), 4),
                        "n_features": int(m[2]),
                        "is_keyframe": bool(m[3]),
                        "map_points": int(m[4]),
                    }
                )
                + "\n"
            )


def summarize(result, per_frame_ms=None) -> dict:
    """Run summary (the reference's printSummary, realized)."""
    out = {
        "frames": result.n_frames,
        "total_time_s": round(result.total_time_s, 3),
        "fps": round(result.fps, 2),
        "keyframes": int(result.kf_flags.sum()),
        "map_points": int(result.metrics[-1, 4]),
        "mean_features": round(float(result.metrics[1:, 2].mean()), 1),
        "mean_inlier_ratio": round(float(result.metrics[1:, 1].mean()), 4),
        "peak_rss_mb": round(peak_rss_mb(), 1),
    }
    pf = per_frame_ms if per_frame_ms is not None else result.per_frame_ms
    if pf:
        import numpy as np

        arr = np.asarray(pf)
        out.update(
            frame_ms_mean=round(float(arr.mean()), 2),
            frame_ms_p50=round(float(np.percentile(arr, 50)), 2),
            frame_ms_p99=round(float(np.percentile(arr, 99)), 2),
            frame_ms_max=round(float(arr.max()), 2),
        )
    return out


class StageTimer:
    """Named wall-clock stage timer (the reference's Timer, utils.h:13-42).
    It reads the host clock only: a stage that ends in device work must
    synchronise inside the block to be timed."""

    def __init__(self):
        self.records: dict[str, list[float]] = {}

    def time(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *a):
                timer.records.setdefault(name, []).append(
                    (time.perf_counter() - self.t0) * 1e3
                )

        return _Ctx()

    def summary(self) -> dict:
        return {
            k: {
                "n": len(v),
                "mean_ms": round(sum(v) / len(v), 3),
                "max_ms": round(max(v), 3),
            }
            for k, v in self.records.items()
        }
