"""The port's copy of the reference-equivalent CPU pipeline
(svo_tpu_torch/eval/reference_cpu.py) against svo_tpu's on the same frames:
tests/fixtures/kitti_mini (12 stereo pairs) and 20 synthetic frames at
184x320, with the FAST detector and with ORB. The two run the same numpy
and cv2 calls (cv2's RANSAC seeds itself per call), so their trajectories
must be identical, and so must their map-point counts.
"""

import os

import numpy as np
import pytest

from svo_tpu.config import Config as JConfig
from svo_tpu.eval.reference_cpu import ReferenceCpuPipeline as JReference
from svo_tpu_torch.config import Config as TConfig
from svo_tpu_torch.eval.reference_cpu import ReferenceCpuPipeline as TReference
from svo_tpu_torch.geometry import camera as tcam
from svo_tpu_torch.io import kitti as tkitti
from svo_tpu_torch.io.synthetic import SyntheticSequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI = os.path.join(REPO, "tests", "fixtures", "kitti_mini")


def _inputs(source):
    if source == "kitti_mini":
        cam = tcam.parse_kitti_calib(os.path.join(KITTI, "calib.txt"))
        return list(tkitti.SequenceReader(KITTI)), cam
    seq = SyntheticSequence(n_frames=20, shape=(184, 320), fx=200.0)
    cam = tcam.from_intrinsics(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline)
    return list(seq), cam


@pytest.mark.parametrize("use_orb", [False, True], ids=["fast", "orb"])
@pytest.mark.parametrize("source", ["kitti_mini", "synthetic"])
def test_reference_pipeline_is_svo_tpus(source, use_orb):
    frames, cam = _inputs(source)
    H, W = frames[0][1].shape
    mats = [cam.K.numpy(), cam.P_left.numpy(), cam.P_right.numpy()]
    runs = []
    for cfg_cls, ref_cls in ((JConfig, JReference), (TConfig, TReference)):
        ref = ref_cls(cfg_cls(use_orb=use_orb, image_height=H, image_width=W), *mats)
        poses, _, _ = ref.run(frames)
        runs.append((poses, ref.n_map_points))
    (pj, nj), (pt, nt) = runs
    assert pt.shape == (len(frames), 4, 4) and np.isfinite(pt).all()
    np.testing.assert_array_equal(pt, pj)
    assert nt == nj > 0
    assert np.abs(pt[-1, :3, 3]).max() > 0.1  # the pipeline moved
