"""The port's readers, parsers and outputs against svo_tpu's.

On the checked-in fixtures (tests/fixtures/kitti_mini: 12 stereo pairs at
96x320, calib.txt, poses.txt; tests/fixtures/euroc_mini: 40 unrectified
pairs at 192x320, both sensor.yaml, ground truth): the KITTI calibration,
ground truth and frames, the EuRoC calibration, rectification maps,
rectified frames and ground truth are BIT-EQUAL to svo_tpu's (the same
numpy arithmetic in the same order). The camera's projections agree to
1e-6 (float32 products through torch against XLA). The metrics records,
the summary, the trajectory and PLY files and the feature overlay are
byte-equal to what svo_tpu's copies write from the same run result; the
plot is a PNG. The native prefetcher is held to the Python reader where
g++ and the libpng headers exist, and skips otherwise.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_tpu.geometry import camera as jcam
from svo_tpu.io import euroc as jeuroc
from svo_tpu.io import kitti as jkitti
from svo_tpu.pipeline.odometry import RunResult as JRunResult
from svo_tpu.utils import metrics as jmetrics
from svo_tpu.viz import dump as jdump
from svo_tpu_torch.geometry import camera as tcam
from svo_tpu_torch.io import euroc as teuroc
from svo_tpu_torch.io import kitti as tkitti
from svo_tpu_torch.pipeline.odometry import RunResult as TRunResult
from svo_tpu_torch.runtime import loader as tloader
from svo_tpu_torch.utils import metrics as tmetrics
from svo_tpu_torch.viz import dump as tdump

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI = os.path.join(REPO, "tests", "fixtures", "kitti_mini")
EUROC = os.path.join(REPO, "tests", "fixtures", "euroc_mini")


def test_kitti_calib_and_camera():
    path = os.path.join(KITTI, "calib.txt")
    cj, ct = jcam.parse_kitti_calib(path), tcam.parse_kitti_calib(path)
    for a, b in zip(cj, ct):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert float(ct.baseline) == pytest.approx(float(cj.baseline), rel=1e-7)
    P2 = np.arange(12, dtype=np.float32).reshape(3, 4) + 1.0
    for a, b in zip(jcam.from_projections(P2, P2 * 2), tcam.from_projections(P2, P2 * 2)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))

    rng = np.random.default_rng(0)
    X = np.concatenate([rng.uniform(-5, 5, (50, 2)), rng.uniform(2, 40, (50, 1))], -1)
    X = X.astype(np.float32)
    for P in ("P_left", "P_right"):
        want = jcam.project_P(jnp.asarray(getattr(cj, P)), jnp.asarray(X))
        got = tcam.project_P(getattr(ct, P), torch.from_numpy(X))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-4)
    uv = rng.uniform(0, 320, (50, 2)).astype(np.float32)
    depth = rng.uniform(1, 30, 50).astype(np.float32)
    want = jcam.backproject(jnp.asarray(cj.K), jnp.asarray(uv), jnp.asarray(depth))
    got = tcam.backproject(ct.K, torch.from_numpy(uv), torch.from_numpy(depth))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # backproject inverts project
    back = tcam.project(ct.K, got)
    np.testing.assert_allclose(back.numpy(), uv, atol=2e-4)


def test_kitti_reader_and_ground_truth():
    gt_path = os.path.join(KITTI, "poses.txt")
    np.testing.assert_array_equal(tkitti.parse_ground_truth(gt_path),
                                  jkitti.parse_ground_truth(gt_path))
    assert tkitti.parse_ground_truth(gt_path + ".missing").shape == (0, 4, 4)
    assert tkitti.frame_paths(KITTI, 7) == jkitti.frame_paths(KITTI, 7)
    rt, rj = tkitti.SequenceReader(KITTI), jkitti.SequenceReader(KITTI)
    assert len(rt) == len(rj) == 12
    got, want = list(rt), list(rj)
    assert len(got) == 12
    for (i, l, r), (j, lj, rj_) in zip(got, want):
        assert i == j and l.dtype == np.float32 and l.shape == (96, 320)
        np.testing.assert_array_equal(l, lj)
        np.testing.assert_array_equal(r, rj_)
    # a range past the last pair stops there, as the reference's loop does
    assert [i for i, _, _ in tkitti.SequenceReader(KITTI, 10, 15)] == [10, 11]


def test_native_loader_matches_reader():
    if not tloader.available():
        pytest.skip(f"native loader cannot be built here: {tloader.unavailable_reason()}")
    frames = list(tloader.AsyncStereoLoader(KITTI, 0, 12, height=96, width=320, threads=3,
                                            capacity=4))
    assert [i for i, _, _ in frames] == list(range(12))
    for (_, l, r), (_, lp, rp) in zip(frames, tkitti.SequenceReader(KITTI)):
        assert l.dtype == np.uint8
        np.testing.assert_allclose(l, lp, atol=1.0)
        np.testing.assert_allclose(r, rp, atol=1.0)
    # padded to a larger canvas: the image in the corner, zeros elsewhere
    big = next(iter(tloader.AsyncStereoLoader(KITTI, 0, 1, height=100, width=330)))[1]
    np.testing.assert_array_equal(big[:96, :320], frames[0][1])
    assert not big[96:].any() and not big[:, 320:].any()


def test_euroc_calibration_and_rectifier():
    for cam in ("cam0", "cam1"):
        path = os.path.join(EUROC, "mav0", cam, "sensor.yaml")
        a, b = jeuroc.load_sensor_yaml(path), teuroc.load_sensor_yaml(path)
        for f in ("K", "D", "T_BS"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
        assert b.size == a.size
    t = np.array([0.11, -0.002, 0.001])
    np.testing.assert_array_equal(teuroc._rot_align_baseline(t), jeuroc._rot_align_baseline(t))
    seq_j, seq_t = jeuroc.EurocSequence(EUROC), teuroc.EurocSequence(EUROC)
    rj, rt = seq_j.rectifier, seq_t.rectifier
    for f in ("R_rect0", "R_rect1", "K_new", "map0", "map1", "T_rect0_body"):
        np.testing.assert_array_equal(getattr(rt, f), getattr(rj, f))
    assert rt.size == rj.size == (192, 320) and rt.baseline == rj.baseline
    for a, b in zip(seq_j.camera, seq_t.camera):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_euroc_sequence():
    seq_j, seq_t = jeuroc.EurocSequence(EUROC, 3, 9), teuroc.EurocSequence(EUROC, 3, 9)
    assert seq_t.pairs == seq_j.pairs and len(seq_t.pairs) == 6
    np.testing.assert_array_equal(seq_t.timestamps, seq_j.timestamps)
    for a, b in zip(teuroc.parse_groundtruth(EUROC), jeuroc.parse_groundtruth(EUROC)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(seq_t.gt_cam_poses(), seq_j.gt_cam_poses())
    for (i, l, r), (j, lj, rj) in zip(seq_t, seq_j):
        assert i == j and l.shape == (192, 320) and l.dtype == np.float32
        np.testing.assert_array_equal(l, lj)
        np.testing.assert_array_equal(r, rj)


def _run_result(cls, n=9, seed=0):
    """A RunResult as a run of n frames would leave it, from a seed."""
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, 3] = np.cumsum(rng.normal(0, 0.3, (n, 3)), 0)
    metrics = np.stack([rng.integers(50, 120, n), rng.uniform(0.8, 1, n),
                        rng.integers(60, 150, n), rng.random(n) < 0.3,
                        np.cumsum(rng.integers(0, 40, n))], -1).astype(np.float32)
    metrics[0, 3] = 1.0
    return cls(poses=poses, kf_flags=metrics[:, 3] > 0, metrics=metrics, n_frames=n,
               total_time_s=1.2345, fps=(n - 1) / 1.2345,
               map_points=rng.normal(0, 5, (40, 3)).astype(np.float32),
               per_frame_ms=list(rng.uniform(5, 30, n - 1)))


def test_metrics(tmp_path):
    rj, rt = _run_result(JRunResult), _run_result(TRunResult)
    pj, pt = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    jmetrics.write_frame_records(str(pj), rj)
    tmetrics.write_frame_records(str(pt), rt)
    assert pt.read_bytes() == pj.read_bytes()
    rows = [json.loads(ln) for ln in pt.read_text().splitlines()]
    assert len(rows) == rt.n_frames and rows[0]["is_keyframe"] is True
    sj, st = jmetrics.summarize(rj), tmetrics.summarize(rt)
    assert st.pop("peak_rss_mb") > 10
    sj.pop("peak_rss_mb")
    assert st == sj and "frame_ms_p99" in st
    timer = tmetrics.StageTimer()
    for _ in range(2):
        with timer.time("a"):
            pass
    with timer.time("b"):
        pass
    s = timer.summary()
    assert s["a"]["n"] == 2 and s["b"]["n"] == 1 and s["a"]["max_ms"] >= 0


def test_dump_artifacts(tmp_path):
    res = _run_result(TRunResult)
    for name, fn, args in (
        ("traj.txt", "save_trajectory_kitti", (res.poses,)),
        ("map.ply", "save_ply", (res.map_points,)),
        ("map_rgb.ply", "save_ply", (res.map_points, np.full((40, 3), 200))),
        ("overlay.png", "save_feature_overlay",
         (np.linspace(0, 255, 96 * 128, dtype=np.float32).reshape(96, 128),
          np.array([[10.0, 20.0], [64.5, 48.0], [120.0, 90.0]]), np.array([True, False, True]))),
    ):
        getattr(jdump, fn)(str(tmp_path / f"j_{name}"), *args)
        getattr(tdump, fn)(str(tmp_path / f"t_{name}"), *args)
        assert (tmp_path / f"t_{name}").read_bytes() == (tmp_path / f"j_{name}").read_bytes(), name
    loaded = np.loadtxt(tmp_path / "t_traj.txt")
    assert loaded.shape == (res.n_frames, 12)
    np.testing.assert_allclose(loaded[0].reshape(3, 4), res.poses[0][:3], rtol=1e-6)
    text = (tmp_path / "t_map.ply").read_text().splitlines()
    assert text[0] == "ply" and int(text[2].split()[-1]) == len(res.map_points)
    png = tmp_path / "t_plot.png"
    tdump.plot_trajectory(str(png), res.poses, res.poses[::-1])
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and png.stat().st_size > 1000
