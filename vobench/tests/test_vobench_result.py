"""The whole run on the CPU at a small size (the harness's look for a card
skipped): the result line has exactly the keys the benchmark's contract
names, `checks` last; a sound run is correct; and with the timed path
broken underneath (a step that returns its state unchanged, half of the
streams left out, the poses a call writes altered where it produces them;
in a live cell also the detector's positions moved by half a pixel, or the
window BA skipped) `correct` comes out false. A cell on one card has no
exchange between chips to leave out."""

import json

import pytest
import torch

from conftest import small_cell

from vobench import harness, spec
from vobench.run import render

FLEET, REFINE, LIVE = "kitti00-fast.fleet8", "kitti00-fast.fleet8-refine", "kitti00-orb-ba.live1"
FAST_LIVE = "kitti00-fast.live1"


def _run(name, trace=False):
    """A small run: long enough on the CPU for a live cell to keep a unit
    in which the window BA ran."""
    seconds = 1.5 if spec.load_cell(name).traffic["kind"] == "fleet_chunk" else 6.0
    return harness.run(small_cell(name), 12345, seconds, trace, "cpu")


@pytest.mark.parametrize("name", [FLEET, LIVE])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(name, trace):
    r = _run(name, trace)
    line, checks = render(r)
    out = json.loads(line)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    cell = spec.load_cell(name)
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(out["metrics"]) <= want
    if not trace:
        assert set(out["metrics"]) == want
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["checks"]) == set(cell.limits) and len(checks) == len(cell.limits)


def _unchanged(orig):
    def step(self, *frames):
        pass
    return step


def _half_batch(orig):
    from svo_tpu_torch.pipeline.state import clone, leaves

    def step(self, *frames):
        before = clone(self.state)
        orig(self, *frames)
        half = self.S // 2
        for new, old in zip(leaves(self.state), leaves(before)):
            new[half:] = old[half:]
    return step


def _altered(orig):
    """The answer of the call, every pose it writes, moved by 1 m where the
    step produces it: a chunk's frames of every stream, or the frame's."""
    def step(self, *frames):
        orig(self, *frames)
        fid = int(self.state.frame_id.reshape(-1)[0])
        n = frames[0].shape[0] if frames[0].ndim == 4 else 1
        self.state.poses[..., fid - n + 1: fid + 1, 0, 3] += 1.0
        self.state.pose[..., 0, 3] += 1.0
    return step


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "altered": _altered}


def _detector_moved(monkeypatch, armed):
    """Every detection of a frame step half a pixel off in x and y."""
    from svo_tpu_torch.ops import detect as detect_mod

    orig = detect_mod.detect

    def detect(*args):
        pos, score, valid = orig(*args)
        return (pos + 0.5 if armed["on"] else pos), score, valid

    monkeypatch.setattr(detect_mod, "detect", detect)


def _no_ba(monkeypatch, armed):
    """The window BA returns the map's points and the poses it was given."""
    from svo_tpu_torch.pipeline import frontend

    orig = frontend._window_ba

    def window_ba(mp, poses, *args):
        return (mp.points, poses) if armed["on"] else orig(mp, poses, *args)

    monkeypatch.setattr(frontend, "_window_ba", window_ba)


# faults planted inside the frame step, armed only in the window's
# process() calls (the bootstrap stays sound)
STEP_FAULTS = {"detector": _detector_moved, "no_ba": _no_ba}


def _arm_in_window(monkeypatch, driver: str, cls, meth: str, broken):
    """cls.meth runs `broken` in the window and the original before it;
    returns the flag that is on while a broken call runs."""
    orig = getattr(cls, meth)
    armed = {"window": False, "on": False}

    def step(self, *frames):
        if not armed["window"]:
            return orig(self, *frames)
        armed["on"] = True
        try:
            return broken(self, *frames)
        finally:
            armed["on"] = False

    monkeypatch.setattr(cls, meth, step)
    from vobench import drivers

    win = getattr(drivers, driver).window

    def window(self, *a, **k):
        armed["window"] = True
        return win(self, *a, **k)

    monkeypatch.setattr(getattr(drivers, driver), "window", window)
    return armed


@pytest.mark.parametrize("name,fault", [(FLEET, f) for f in FAULTS]
                         + [(REFINE, f) for f in FAULTS]
                         + [(LIVE, f) for f in ("unchanged", "altered")])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    from svo_tpu_torch.parallel.batched import BatchedStereoVO
    from svo_tpu_torch.pipeline.odometry import StereoVO

    cls, meth = (StereoVO, "process") if name == LIVE else (BatchedStereoVO, "process_chunk")
    _arm_in_window(monkeypatch, "Live" if name == LIVE else "Fleet", cls, meth,
                   FAULTS[fault](getattr(cls, meth)))
    r = _run(name)
    assert r["correct"] is False, r["_readings"]


@pytest.mark.parametrize("name,fault", [(LIVE, "detector"), (LIVE, "no_ba"),
                                        (FAST_LIVE, "detector")])
def test_a_broken_frame_step_is_not_correct(monkeypatch, name, fault):
    """A fault inside the live frame step (the detector of a keyframe's
    replenish, the window BA), with the bootstrap sound, is seen by the
    check of the units after it."""
    from svo_tpu_torch.pipeline.odometry import StereoVO

    armed = _arm_in_window(monkeypatch, "Live", StereoVO, "process", StereoVO.process)
    STEP_FAULTS[fault](monkeypatch, armed)
    r = _run(name)
    assert r["correct"] is False, r["_readings"]


def test_no_card_no_result(monkeypatch, capsys):
    from vobench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", FLEET, "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
