"""vobench/frames.py's device renderer against the port's numpy renderer
(svo_tpu_torch/io/synthetic.py) at 96x320: the same uint8 frames, pixel
for pixel, where each pixel may differ by at most 1 level on at most 0.1%
of the pixels (float64 rays cast by other libraries may round a blend
across an integer); the same ground truth."""

import numpy as np
import torch

from vobench.frames import make_sequence
from svo_tpu_torch.io.synthetic import SyntheticSequence

MAX_DIFF_LEVELS = 1
MAX_DIFF_SHARE = 1e-3


def test_frames_match_the_port_renderer():
    H, W = 96, 320
    ref = SyntheticSequence(n_frames=13, shape=(H, W), fx=200.0, cx=150.5, cy=40.25,
                            seed=2**31 + 5)
    seq = make_sequence(2**31 + 5, 13, (H, W), ref.K, ref.baseline, "cpu")
    assert np.allclose(seq.gt, ref.gt_poses)
    for i in (0, 6, 12):
        for got, want in zip((seq.left[i], seq.right[i]), ref.frame(i)):
            want = torch.from_numpy(np.clip(want, 0, 255).astype(np.uint8))
            d = (got.to(torch.int16) - want.to(torch.int16)).abs()
            assert int(d.max()) <= MAX_DIFF_LEVELS
            assert float((d > 0).float().mean()) <= MAX_DIFF_SHARE
