"""The whole run on the CPU at a small size (the harness's look for a card
skipped): the result line has exactly the keys the benchmark's contract
names, `checks` last; a sound run is correct; and with the timed path
broken underneath (a step that returns its state unchanged, half of the
streams left out, the poses a call writes altered where it produces them;
in a live cell also the detector's positions moved by half a pixel; in a
cell with the window BA, live or fleet, the BA skipped) `correct` comes
out false. A cell on one card has no exchange between chips to leave out.
The fleet driver's BA schedules, worked out on the host, are the ones the
program reads, and its warm-up meets each of them once."""

import json

import numpy as np
import pytest
import torch

from conftest import small_cell

from vobench import drivers, frames, harness, spec
from vobench.run import render

FLEET, REFINE, LIVE = "kitti00-fast.fleet8", "kitti00-fast.fleet8-refine", "kitti00-orb-ba.live1"
FAST_LIVE, FLEET_BA = "kitti00-fast.live1", "kitti00-orb-ba.fleet8-ba"


def _run(name, trace=False):
    """A small run: long enough on the CPU for a live cell to keep a unit
    in which the window BA ran."""
    seconds = 1.5 if spec.load_cell(name).traffic["kind"] == "fleet_chunk" else 6.0
    return harness.run(small_cell(name), 12345, seconds, trace, "cpu")


@pytest.mark.parametrize("name", [FLEET, LIVE, FLEET_BA])
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
                                        (FAST_LIVE, "detector"), (FLEET_BA, "no_ba")])
def test_a_broken_frame_step_is_not_correct(monkeypatch, name, fault):
    """A fault inside the frame step (the detector of a keyframe's
    replenish, the window BA; a live frame or a fleet's chunk), with the
    bootstrap sound, is seen by the check of the units it ran in."""
    from svo_tpu_torch.parallel.batched import BatchedStereoVO
    from svo_tpu_torch.pipeline.odometry import StereoVO

    fleet = spec.load_cell(name).traffic["kind"] == "fleet_chunk"
    cls, meth = (BatchedStereoVO, "process_chunk") if fleet else (StereoVO, "process")
    armed = _arm_in_window(monkeypatch, "Fleet" if fleet else "Live", cls, meth,
                           getattr(cls, meth))
    STEP_FAULTS[fault](monkeypatch, armed)
    r = _run(name)
    assert r["correct"] is False, r["_readings"]


def _fleet(cell, seed=7):
    """The fleet driver of a small cell on the CPU, its sequence rendered."""
    cfg, make_camera = harness._port_config(cell.config)
    cam = cell.config["camera"]
    K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1.0]])
    cpu = torch.device("cpu")
    seq = frames.make_sequence(seed, spec.n_frames(cell.config),
                               (cfg.image_height, cfg.image_width), K, cam["baseline"], cpu)
    return drivers.Fleet(cell.traffic, seq, seed, cfg, make_camera(cpu), cpu,
                         cell.config["lk_engine"])


def _mixed_ba(name=FLEET_BA):
    """The small BA fleet cell with the BA at keyframe counts 6, 9, 12, ..:
    over its 4 chunks the schedules (F, F), (F, F), (T, F), (F, T)."""
    cell = small_cell(name)
    cell.config["pipeline"]["ba"].update(window=4, interval=3)
    return cell


def test_the_cells_ba_schedules():
    """At the cell's own size the BA is due at keyframe counts 16, 24, ..,
    80: the first keyframe step of chunks 7, 11, .., 39 of a pass's 40; the
    profiled slice holds the first of them and the chunk before it."""
    cell = spec.load_cell(FLEET_BA)
    cfg, _ = harness._port_config(cell.config)
    t = cell.traffic
    n = (spec.n_frames(cell.config) - 1) // t["chunk"]
    sched = drivers.chunk_schedules(cfg.ba, n, t["chunk"], t["cadence"])
    due = [c for c, s in enumerate(sched) if any(s)]
    assert n == 40 and due == list(range(7, 40, 4))
    assert set(sched) == {(False, False), (True, False)}
    assert list(range(t["trace_skip"], t["trace_skip"] + t["trace_units"])) == [due[0] - 1, due[0]]


def test_host_schedules_are_what_the_step_reads(monkeypatch):
    """Over a whole small pass the schedule the chunk step reads on the
    device (frontend._ba_schedule, its graph key) is, chunk by chunk, the
    one chunk_schedules works out on the host."""
    from svo_tpu_torch.pipeline import frontend

    read = []
    orig = frontend._ba_schedule

    def schedule(*args):
        read.append(orig(*args))
        return read[-1]

    monkeypatch.setattr(frontend, "_ba_schedule", schedule)
    drv = _fleet(_mixed_ba())
    drv.vo.start(drv.l0, drv.r0, seed=7)
    for c in range(drv.n_chunks):
        drv.vo.process_chunk(*drv.chunks[c])
    assert read == drv.schedules
    assert len(set(read)) == 3


class _Capturing:
    """A chunk step that captures: a graph per schedule met."""
    capture = True

    def __init__(self):
        self.graphs = {}


def _warm_chunks(monkeypatch, cell, expect=None) -> tuple[list, object]:
    """The chunks Fleet.warm() steps when the chunk step captures (as on
    the card), each call recording the graph its schedule captures;
    `expect`: the schedules the driver is made to expect in their place."""
    from svo_tpu_torch.parallel.batched import BatchedStereoVO

    drv = _fleet(cell)
    drv.vo._chunk_step = step = _Capturing()
    met = list(drv.schedules)
    if expect is not None:
        drv.schedules = expect
    ran = []

    def process_chunk(self, lefts, rights):
        c = next(i for i, (l, _) in enumerate(drv.chunks) if l is lefts)
        ran.append(c)
        step.graphs[met[c] if drv.ba else ()] = None

    monkeypatch.setattr(BatchedStereoVO, "process_chunk", process_chunk)
    monkeypatch.setattr(BatchedStereoVO, "refine", lambda self: None)
    drv.warm()
    return ran, drv


@pytest.mark.parametrize("name,chunks", [(FLEET, [0]), (REFINE, [0, 1])])
def test_a_warm_up_without_the_ba_steps_todays_chunks(monkeypatch, name, chunks):
    ran, _ = _warm_chunks(monkeypatch, small_cell(name))
    assert ran == chunks


def test_a_warm_up_with_the_ba_meets_every_schedule(monkeypatch):
    ran, drv = _warm_chunks(monkeypatch, _mixed_ba())
    assert ran == [0, 1, 2, 3] and set(drv.vo._chunk_step.graphs) == set(drv.schedules)


def test_a_warm_up_that_misses_a_schedule_raises(monkeypatch):
    with pytest.raises(RuntimeError, match="warm-up met"):
        _warm_chunks(monkeypatch, _mixed_ba(), expect=[(False, False)] * 3 + [(True, True)])


def test_no_card_no_result(monkeypatch, capsys):
    from vobench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", FLEET, "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
