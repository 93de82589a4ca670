"""The port's entry points on the fixtures, and its chunked step with the
data-dependent keyframe rule.

The three command lines run in this process (main([...]), --device cpu)
with the shipping detector, ORB, and are held to the bounds svo_tpu's own
end-to-end tests use: on kitti_mini ATE < max(5% of the distance
traveled, 5 cm) (tests/test_kitti_e2e.py), on euroc_mini ATE < 5% of the
distance traveled with a mean inlier ratio > 0.8 (tests/test_euroc_e2e.py);
each writes the files it is asked for. run_kitti also reads
configs/kitti00.yaml (PyYAML is installed here) and runs the dynamic
chunked step with --refine.

StereoVO(chunk=12, kf_cadence=0) runs frontend.make_chunked_step: 13
frames at 96x256 beside svo_tpu's jitted lax.scan of the same rule, with
svo_tpu's PnP noise handed to the port frame by frame (jax.random's split
chain from the same seed): keyframe flags identical, trajectories within
the 10 cm and 1 degree of tests/test_torch_pipeline.py (read:
2.3e-6 m). A chunk that is not a multiple of the cadence raises, as
svo_tpu refuses it.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from svo_tpu.config import Config as JConfig
from svo_tpu.geometry import camera as jcam
from svo_tpu.io.synthetic import SyntheticSequence
from svo_tpu.pipeline.odometry import StereoVO as JStereoVO
from svo_tpu_torch import run_euroc, run_kitti, run_synthetic
from svo_tpu_torch.config import Config as TConfig
from svo_tpu_torch.eval.trajectory import ate_rmse
from svo_tpu_torch.geometry import camera as tcam
from svo_tpu_torch.io import euroc, kitti
from svo_tpu_torch.pipeline import frontend as tfront
from svo_tpu_torch.pipeline.odometry import StereoVO as TStereoVO

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI = os.path.join(REPO, "tests", "fixtures", "kitti_mini")
EUROC = os.path.join(REPO, "tests", "fixtures", "euroc_mini")


def _traveled(gt):
    return float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())


def _kitti_traj(path):
    traj = np.loadtxt(path)
    assert traj.shape == (12, 12)
    poses = np.tile(np.eye(4), (12, 1, 1))
    poses[:, :3, :4] = traj.reshape(12, 3, 4)
    return poses


def _kitti_args():
    return ["--path", KITTI, "--calib", os.path.join(KITTI, "calib.txt"),
            "--gt", os.path.join(KITTI, "poses.txt"), "--device", "cpu"]


def test_run_kitti_cli(tmp_path, capsys):
    out, metrics, ply, png = (tmp_path / n for n in ("traj.txt", "m.jsonl", "map.ply", "t.png"))
    assert run_kitti.main(_kitti_args() + [
        "--out", str(out), "--metrics-out", str(metrics), "--ply", str(ply),
        "--plot", str(png)]) == 0
    gt = kitti.parse_ground_truth(os.path.join(KITTI, "poses.txt"))
    ate = ate_rmse(_kitti_traj(out), gt)
    traveled = _traveled(gt)
    assert ate < max(0.05 * traveled, 0.05), f"ATE {ate:.3f} over {traveled:.2f} m"
    rows = [json.loads(ln) for ln in metrics.read_text().splitlines() if ln.strip()]
    assert len(rows) >= 12 and rows[0]["is_keyframe"] is True
    summary = json.loads((tmp_path / "m.jsonl.summary.json").read_text())
    assert summary["frames"] == 12 and summary["mean_inlier_ratio"] > 0.8
    assert ply.read_text().startswith("ply") and png.stat().st_size > 1000
    assert "ATE RMSE:" in capsys.readouterr().out


def test_run_kitti_cli_config_chunked_refine(tmp_path, capsys):
    """configs/kitti00.yaml (ORB with nfeatures 150, window BA on) with the
    fixture's paths, the dynamic chunked step (chunks of 4, three tail
    frames) and the span-by-span refinement sweep."""
    out = tmp_path / "traj.txt"
    assert run_kitti.main(_kitti_args() + [
        "--config", os.path.join(REPO, "configs", "kitti00.yaml"), "--start", "0", "--end", "12",
        "--chunk", "4", "--refine", "--refine-blocks", "2", "--refine-cams", "5",
        "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "refine ATE:" in text and "refine:       2 sweeps" in text, text
    gt = kitti.parse_ground_truth(os.path.join(KITTI, "poses.txt"))
    ate = ate_rmse(_kitti_traj(out), gt)
    assert ate < max(0.05 * _traveled(gt), 0.05), ate


def test_run_euroc_cli(tmp_path):
    out = tmp_path / "traj.txt"
    assert run_euroc.main(["--root", EUROC, "--device", "cpu", "--out", str(out)]) == 0
    traj = np.loadtxt(out)
    assert traj.shape == (40, 12)
    poses = np.tile(np.eye(4), (40, 1, 1))
    poses[:, :3, :4] = traj.reshape(40, 3, 4)
    gt = euroc.EurocSequence(EUROC).gt_cam_poses()
    ate = ate_rmse(poses, gt)
    assert np.isfinite(poses).all() and ate < 0.05 * _traveled(gt), ate


@pytest.mark.parametrize("extra", [["--chunk", "12", "--cadence", "6"], ["--fast"]])
def test_run_synthetic_cli(tmp_path, extra):
    out = tmp_path / "run.json"
    assert run_synthetic.main(["--small", "--frames", "13", "--device", "cpu", "--seed", "1",
                               "--out-json", str(out)] + extra) == 0
    s = json.loads(out.read_text())
    assert s["frames"] == 13 and s["device"] == "cpu" and s["finite"]
    assert s["detector"] == ("fast" if "--fast" in extra else "orb")
    assert s["fps"] > 0 and s["chunk"] == (12 if "--chunk" in extra else 0)
    assert s["ate_m"] < 0.05 * s["traveled_m"], s
    assert s["mean_inlier_ratio"] > 0.8 and s["mean_features"] > 60, s


def test_entry_points_need_a_card_unless_asked():
    """--device defaults to cuda; without a card the run raises rather than
    falling back to the CPU (the evaluation harnesses before they render or
    read a frame)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from svo_tpu_torch import eval_ba, eval_euroc, eval_fleet, eval_recovery

    for cli, argv in ((run_synthetic, ["--small", "--frames", "2"]), (eval_recovery, []),
                      (eval_ba, []), (eval_fleet, ["--small"]), (eval_euroc, [])):
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(argv)


def test_dynamic_chunked_step_matches_svo_tpu(monkeypatch):
    H, W = 96, 256
    seq = SyntheticSequence(n_frames=13, shape=(H, W), fx=120.0, speed=0.12, seed=3)
    frames = list(seq)
    args = (seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline)
    kw = dict(use_orb=False, image_height=H, image_width=W)
    cfg_j, cfg_t = JConfig(**kw), TConfig(**kw)
    rj = JStereoVO(cfg_j, jcam.from_intrinsics(*args), seed=0, chunk=12).run_chunked(frames)

    # svo_tpu's noise: each step splits the state's key (frontend.py:317)
    key, noises = jax.random.PRNGKey(0), []
    for _ in frames[1:]:
        key, sub = jax.random.split(key)
        noises.append(torch.from_numpy(np.array(jax.random.gumbel(
            sub, (cfg_j.ransac.num_hypotheses, cfg_j.capacity.max_features)))))
    drawn = iter(noises)
    monkeypatch.setattr(tfront, "gumbel_noise", lambda *a, **k: next(drawn))
    vo = TStereoVO(cfg_t, tcam.from_intrinsics(*args), chunk=12, kf_cadence=0, device="cpu")
    rt = vo.run_chunked(frames)
    assert next(drawn, None) is None  # one draw a frame, all used

    np.testing.assert_array_equal(rt.kf_flags, rj.kf_flags)
    assert 1 < rt.kf_flags.sum() < 13  # the rule decided, not a cadence
    assert np.isfinite(rt.poses).all() and rt.metrics[1:, 2].min() > 40
    dt = np.linalg.norm(rj.poses[:, :3, 3] - rt.poses[:, :3, 3], axis=-1)
    assert dt.max() < 0.1, dt
    cos = (np.einsum("nij,nij->n", rj.poses[:, :3, :3], rt.poses[:, :3, :3]) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))).max() < 1.0


def test_chunk_must_be_a_multiple_of_the_cadence():
    cam = tcam.from_intrinsics(120.0, 120.0, 128.0, 48.0, 0.5)
    cfg = TConfig(use_orb=False, image_height=96, image_width=256)
    with pytest.raises(ValueError, match="multiple of kf_cadence"):
        TStereoVO(cfg, cam, chunk=12, kf_cadence=5, device="cpu")
    assert TStereoVO(cfg, cam, chunk=12, kf_cadence=4, device="cpu").chunk == 12
