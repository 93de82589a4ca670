"""The EuRoC harness of the port, svo_tpu_torch/eval_euroc.py, against
svo_tpu's StereoVO.run on the same sequence, on the CPU.

tests/fixtures/euroc_mini (40 frames, rectified to 192x320, the
data-dependent keyframe rule) through eval_euroc.main with the patches
engine (svo_tpu's CPU path) and svo_tpu's PnP noise (the split chain of
jax.random from seed 0, handed to the port's frame steps by frame,
tests/recovery_reference.py's replay_noise). Held: the result has the keys
of EUROC_r05.json (plus the device, the engine, finite and the wall time),
the ATE within 1e-4 m of svo_tpu's and the keyframes identical.
"""

import json
import os
import sys

import jax  # noqa: F401  (before torch)
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from recovery_reference import replay_noise, svo_tpu_noise  # noqa: E402

from svo_tpu.config import Config as JConfig  # noqa: E402
from svo_tpu.eval.trajectory import ate_rmse as jate  # noqa: E402
from svo_tpu.io.euroc import EurocSequence as JEuroc  # noqa: E402
from svo_tpu.pipeline.odometry import StereoVO as JStereoVO  # noqa: E402
from svo_tpu_torch import eval_euroc  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_euroc_on_euroc_mini(tmp_path):
    out = tmp_path / "euroc.json"
    with replay_noise(svo_tpu_noise(39)):
        assert eval_euroc.main(["--lk-engine", "patches", "--device", "cpu",
                                "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    with open(os.path.join(REPO, "EUROC_r05.json")) as f:
        want = json.load(f)
    assert set(got) - set(want) == {"lk_engine", "device", "finite", "wall_s"}
    assert set(want) <= set(got)
    assert got["root"] == "euroc_mini" and got["frames"] == 40 and got["image"] == "192x320"
    assert got["backend"] == "cpu" and got["finite"]
    seq = JEuroc(eval_euroc.EUROC_MINI)
    H, W = seq.rectifier.size
    res = JStereoVO(JConfig(use_orb=False, image_height=H, image_width=W), seq.camera).run(
        list(iter(seq)))
    gt = seq.gt_cam_poses()
    n = min(res.n_frames, len(gt))
    assert abs(got["ate_m"] - jate(res.poses[:n], gt[:n])) <= 1e-4, got["ate_m"]
    assert got["keyframes"] == int(res.kf_flags[:n].sum())
    assert got["ate_m"] < 0.05 * got["traveled_m"]
