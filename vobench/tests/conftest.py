"""Shared helpers of vobench's CPU tests: a cell of BENCHMARK.json cut to a
size the CPU runs in seconds (96x320 frames, 49 a pass, 2 streams, live
units of 4 frames, a window BA of 2 keyframes at every keyframe), and
the `chip` marker of the tests that need the card (they skip inside the
test on a machine without one)."""

from __future__ import annotations

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL_SHAPE = (96, 320)
SMALL_CAMERA = {"fx": 200.0, "fy": 200.0, "cx": 160.0, "cy": 48.0}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


def small_cell(name: str):
    """BENCHMARK.json's cell `name` at the CPU tests' size; its limits are
    the cell's own."""
    from vobench import spec

    cell = spec.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["pipeline"].update(image_height=SMALL_SHAPE[0], image_width=SMALL_SHAPE[1], end_frame=48)
    if cfg["pipeline"].get("ba", {}).get("enabled"):
        # a window BA at every keyframe after the first
        cfg["pipeline"]["ba"] = dict(cfg["pipeline"]["ba"], window=2, interval=1)
    cfg["camera"].update(SMALL_CAMERA)
    t = dict(cell.traffic)
    if t["kind"] == "fleet_chunk":
        t.update(streams=2, check_units=1, trace_skip=0, trace_units=1)
    else:
        t.update(check_frames=4, check_units=1, trace_skip=3, trace_frames=6)
    return cell._replace(config=cfg, traffic=t)


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip: python3 -m pytest vobench/tests -m chip)")
