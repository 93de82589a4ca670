"""The fleet table of the port, svo_tpu_torch/eval_fleet.py, against
svo_tpu's StereoVO on the same frames, on the CPU (the EuRoC harness is in
test_torch_eval_euroc.py).

Both packages run the same sequence with svo_tpu's PnP noise (the split
chain of jax.random from seed 0, handed to the port's frame steps by frame,
tests/recovery_reference.py's replay_noise) and the patches engine (svo_tpu's
CPU path): on a KITTI root built in tmp_path from kitti_mini (sequences/00,
poses/00.txt; --chunk 6 --cadence 6, 7 frames at 96x320), and on 2
synthetic --small sequences of 25 frames (seeds 0 and 1, speeds 0.25 and
0.28). Rows have scripts/eval_fleet.py's keys. On kitti_mini the ATE and
RPE are held within 1e-4 m of svo_tpu's. On the synthetic sequences they
are held to 1e-3 m: one frame of sequence 0 (frame 8) lands 3.4 mm from
svo_tpu's, every other frame within 7e-6 m, and the ATE 1.25e-4 m. A
one-frame outlier that the next frame does not inherit fits ROADMAP C's
raw-DLT pick, whose rounding the standing traps hold to mm.
"""

import json
import os
import shutil
import sys

import jax  # noqa: F401  (before torch)
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from recovery_reference import replay_noise, svo_tpu_noise  # noqa: E402

from svo_tpu.config import Config as JConfig  # noqa: E402
from svo_tpu.eval.trajectory import ate_rmse as jate  # noqa: E402
from svo_tpu.eval.trajectory import rpe as jrpe  # noqa: E402
from svo_tpu.geometry import camera as jcam  # noqa: E402
from svo_tpu.geometry.camera import parse_kitti_calib as jparse_calib  # noqa: E402
from svo_tpu.io import kitti as jkitti  # noqa: E402
from svo_tpu.pipeline.odometry import StereoVO as JStereoVO  # noqa: E402
from svo_tpu_torch import eval_fleet  # noqa: E402
from svo_tpu_torch.io.synthetic import SyntheticSequence  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI = os.path.join(REPO, "tests", "fixtures", "kitti_mini")
ROW_KEYS = {"seq", "frames", "ate_m", "ate_pct", "rpe_t_m", "rpe_r_deg", "traveled_m",
            "fps_incl_compile"}


def _svo_chunked(frames, camera, shape, chunk, cadence):
    """scripts/eval_fleet.py's run_sequence on svo_tpu: the poses."""
    cfg = JConfig(use_orb=False, image_height=shape[0], image_width=shape[1])
    frames = frames[:1 + ((len(frames) - 1) // chunk) * chunk]
    return JStereoVO(cfg, camera, chunk=chunk, kf_cadence=cadence).run_chunked(frames).poses


def _held(row, poses, gt, tol):
    gt = gt[:len(poses)]
    t_err, r_err = jrpe(poses, gt)
    assert abs(row["ate_m"] - jate(poses, gt)) <= tol, (row, jate(poses, gt))
    assert abs(row["rpe_t_m"] - t_err) <= tol and abs(row["rpe_r_deg"] - r_err) <= tol, row


@pytest.fixture(scope="module")
def noise():
    return svo_tpu_noise(48)


def test_fleet_on_a_kitti_root(tmp_path, noise):
    seq_dir = tmp_path / "sequences" / "00"
    for d in ("image_2", "image_3"):
        shutil.copytree(os.path.join(KITTI, d), seq_dir / d)
    shutil.copy(os.path.join(KITTI, "calib.txt"), seq_dir)
    (tmp_path / "poses").mkdir()
    shutil.copy(os.path.join(KITTI, "poses.txt"), tmp_path / "poses" / "00.txt")
    out = tmp_path / "fleet.json"
    with replay_noise(noise):
        assert eval_fleet.main(["--kitti", str(tmp_path), "--seqs", "00,01", "--chunk", "6",
                                "--cadence", "6", "--lk-engine", "patches", "--device", "cpu",
                                "--out", str(out)]) == 0
    r = json.loads(out.read_text())
    assert r["source"] == "kitti" and r["device"] == "cpu"
    (row,) = r["rows"]  # sequence 01 is missing: reported, skipped
    assert ROW_KEYS <= set(row) and row["seq"] == "00" and row["frames"] == 7 and row["finite"]
    frames = list(jkitti.SequenceReader(str(seq_dir), 0, None))
    poses = _svo_chunked(frames, jparse_calib(str(seq_dir / "calib.txt")), frames[0][1].shape, 6, 6)
    assert len(poses) == 7
    _held(row, poses, jkitti.parse_ground_truth(str(tmp_path / "poses" / "00.txt")), 1e-4)
    assert r["mean_ate_pct"] == row["ate_pct"]


def test_fleet_synthetic(tmp_path, noise):
    out = tmp_path / "fleet.json"
    with replay_noise(noise):
        assert eval_fleet.main(["--small", "--seqs", "00,01", "--frames", "25",
                                "--lk-engine", "patches", "--device", "cpu",
                                "--out", str(out)]) == 0
    r = json.loads(out.read_text())
    assert r["source"] == "synthetic-small" and [row["seq"] for row in r["rows"]] == \
        ["synth-00", "synth-01"]
    for i, row in enumerate(r["rows"]):
        assert ROW_KEYS <= set(row) and row["frames"] == 25 and row["keyframes"] == 5
        seq = SyntheticSequence(n_frames=25, shape=(184, 320), fx=200.0, seed=i,
                                speed=0.25 + 0.03 * i)
        camera = jcam.from_intrinsics(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2],
                                      seq.baseline)
        frames = [(j, np.clip(lr[0], 0, 255).astype(np.uint8),
                   np.clip(lr[1], 0, 255).astype(np.uint8)) for j, lr in
                  enumerate(map(seq.frame, range(25)))]
        _held(row, _svo_chunked(frames, camera, (184, 320), 12, 6), seq.gt_poses, 1e-3)
