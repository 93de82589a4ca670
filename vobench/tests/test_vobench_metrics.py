"""Every per-layer metric of BENCHMARK.json reproduces its value from a
small recorded slice (fixtures/slice_records.json), worked out by hand
below; the idle share from the union of the activity intervals."""

import json
import os

import pytest

from vobench import spec, trace

FIX = json.load(open(os.path.join(os.path.dirname(__file__), "fixtures", "slice_records.json")))

# fleet: activities [100, 300], [200, 400] (the steps'), [600, 700] and
# [650, 680] (inside the sweep's span [550, 900]); union 300 + 100 ns of
# the slice's 1000; 2 steps; chunk intervals 30, 34, 31 ms without the
# window BA and 50, 58 ms with it
LK_BYTES = 100 * (3 * 24 * 24 + 34 * 34) * 4 + 128 * 49     # one level, bytes bind
LK_BOUND_MS = 4 * LK_BYTES / 3.35e12 * 1e3                  # 4 levels
EXPECTED = {
    ("fleet", "step_device_ms.fleet"): 300 / 1e6 / 2,
    ("fleet", "kernels_per_step.fleet"): 2 / 2,
    ("fleet", "refine_sweep_ms.fleet"): 16.0,
    ("fleet", "lk_level_roofline.fleet"): 100.0 * LK_BOUND_MS / (200 / 1e6),
    ("fleet", "ba_chunk_ms.fleet"): 54.0,
    ("fleet", "plain_chunk_ms.fleet"): 31.0,
    # live: frames 10, 12 (track), 30 (keyframe), 50 (BA), 99 (in the slice:
    # left out), process() returning after 4, 5, 6, 9 (and 50) ms
    ("live", "device_idle_share.live"): 100.0 * (1 - 400 / 1000),
    ("live", "track_frame_ms.live"): 11.0,
    ("live", "kf_frame_ms.live"): 30.0,
    ("live", "ba_frame_ms"): 50.0,
    ("live", "frame_host_ms.live"): 5.5,
    # the .orb names read as the .live ones do; the p95 of 10, 12, 30, 50
    # lies 0.85 of the way from 30 to 50; 4 frames outside the slice in the
    # window's 1.5 s less the slice's 0.5 s
    ("live", "device_idle_share.orb"): 100.0 * (1 - 400 / 1000),
    ("live", "track_frame_ms.orb"): 11.0,
    ("live", "kf_frame_ms.orb"): 30.0,
    ("live", "frame_host_ms.orb"): 5.5,
    ("live", "frame_latency_p95_ms.orb"): 30.0 + 0.85 * 20.0,
    ("live", "frames_per_s.live"): 4 / 1.0,
}


def test_every_metric_has_an_expected_value():
    bench = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
    assert {m["name"] for m in bench["per_layer"]} == {name for _, name in EXPECTED}


@pytest.mark.parametrize("kind,name", sorted(EXPECTED))
def test_metric_reproduces_its_value(kind, name):
    assert spec.metric_reader(name)(FIX[kind]) == pytest.approx(EXPECTED[kind, name], rel=1e-12)


def test_a_metric_with_nothing_to_read_returns_none():
    empty = dict(FIX["fleet"], slice=None, sweep_ms=[], chunk_ms=[], lk_launches=[], frames=[])
    for _, name in EXPECTED:
        assert spec.metric_reader(name)(empty) is None


def test_the_slice_starts_at_its_first_device_activity():
    acts = [["k", 130, 150], ["k", 90, 95], ["k", 200, 260]]
    assert trace.slice_bounds(acts, ["slice", 100, 300]) == (130, 300)
    assert trace.slice_bounds([], ["slice", 100, 300]) == (100, 300)


def test_union_and_breakdown():
    acts = FIX["fleet"]["slice"]["activities"]
    assert trace.union(acts) == [[100, 400], [600, 700]]
    assert trace.busy_ns(acts, 250, 650) == 150 + 50
    b = trace.breakdown(FIX["fleet"])
    assert dict(b["device_ops"])["lk_level_kernel"] == 200 / 1e9
    assert b["idle_gaps"] == [["refine", 300 / 1e9], ["step", 200 / 1e9], ["step", 100 / 1e9]]
