"""The dense configuration, vobench/configs/kitti00-orb2k.json (ORB-SLAM2's
KITTI feature budget: ORB with 2,000 features, 2,048 slots a stream), on
the CPU.

Its pipeline loads into the port's Config and the benchmark reference's;
at a small dense size (256 slots and detections, ORB 250, 96x320) the
port's BatchedStereoVO.process_chunk equals the plain reference
(vobench/reference) bit for bit on a chunk, and a single-stream run stays
within test_torch_pipeline.py's parity bounds of svo_tpu's; the PnP
kernel takes 129 to 2,048 correspondences (the wide path) and refuses
2,049 before anything is built.
"""

import dataclasses
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
from svo_tpu_torch import _build
from svo_tpu_torch.config import Config
from svo_tpu_torch.config import RansacParams
from svo_tpu_torch.geometry import camera as tcam
from svo_tpu_torch.geometry import pnp
from svo_tpu_torch.parallel.batched import BatchedStereoVO
from svo_tpu_torch.pipeline import state as tstate
from svo_tpu_torch.pipeline.odometry import StereoVO
from vobench import frames, spec
from vobench.reference.config import Config as RefConfig
from vobench.reference.drive import Reference

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = json.load(open(os.path.join(ROOT, "vobench", "configs", "kitti00-orb2k.json")))
H, W = 96, 320
SMALL = {"image_height": H, "image_width": W,
         "orb_params": dict(CONFIG["pipeline"]["orb_params"], nfeatures=250),
         "capacity": {"max_features": 256, "max_detections": 256, "max_points": 1 << 14},
         "tracking": {"features_to_track": 140, "y_threshold": 40.0}}
CAMERA = (200.0, 200.0, 160.0, 48.0, 0.5372)


def test_the_configuration_loads_into_both_configs():
    port = spec.with_overrides(Config(), CONFIG["pipeline"])
    ref = spec.with_overrides(RefConfig(), CONFIG["pipeline"])
    for cfg in (port, ref):
        assert (cfg.capacity.max_features, cfg.capacity.max_detections,
                cfg.capacity.max_points) == (2048, 2048, 1 << 20)
        assert (cfg.orb_params.nfeatures, cfg.orb_params.pyr_levels,
                cfg.orb_params.scale_factor, cfg.orb_params.fast_treshold) == (2000, 8, 1.2, 20)
        assert cfg.use_orb and not cfg.ba.enabled and cfg.tracking.features_to_track == 1120
    assert CONFIG["lk_engine"] == "fused" and CONFIG["reduced"] == ["end_frame"]
    assert set(CONFIG["not_mapped"]) == {"minThFAST", "ThDepth"}


def _small(cls):
    cfg = spec.with_overrides(cls(), CONFIG["pipeline"])
    return spec.with_overrides(cfg, SMALL)


def test_batched_chunk_equals_the_reference_at_a_dense_size():
    """Two streams (one reversed) through the bootstrap and a cadenced
    chunk of 12: every leaf of the state bit-equal to the plain reference
    the benchmark's check runs."""
    K = np.array([[CAMERA[0], 0, CAMERA[2]], [0, CAMERA[1], CAMERA[3]], [0, 0, 1.0]])
    seq = frames.make_sequence(21, 13, (H, W), K, CAMERA[4], "cpu")
    bvo = BatchedStereoVO(_small(Config), tcam.from_intrinsics(*CAMERA), 2, chunk=12,
                          kf_cadence=6, device="cpu", lk_engine="fused", graph=False)
    ref = Reference(_small(RefConfig), CAMERA, "cpu", "fused", chunk=12, cadence=6)
    l0 = torch.stack([seq.left[0], seq.left[-1]])
    r0 = torch.stack([seq.right[0], seq.right[-1]])
    bvo.start(l0, r0, seed=2**31 + 7)
    state = ref.bootstrap(l0, r0, [2**31 + 7, 2**31 + 8])
    idx = torch.arange(1, 13)
    lefts = torch.stack([seq.left[idx], seq.left[12 - idx]], dim=1)
    rights = torch.stack([seq.right[idx], seq.right[12 - idx]], dim=1)
    bvo.process_chunk(lefts, rights)
    state = ref.chunk(state, lefts, rights)
    assert int(bvo.state.features.valid.sum(-1).min()) > 128  # past the narrow path's N
    for x, y in zip(tstate.leaves(bvo.state), tstate.leaves(state)):
        assert torch.equal(x, y)


def _angle_deg(a, b):
    c = (np.trace(a[:3, :3].T @ b[:3, :3]) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


def test_single_stream_within_svo_tpus_parity_bounds():
    """test_torch_pipeline.py's run_chunked comparison at the dense size:
    live features >= 40 every frame, the port's mean survival >= 70% of
    svo_tpu's, trajectories within 10 cm and 1 degree, the final PnP keys
    bit-equal, the keyframe flags equal."""
    seq = SyntheticSequence(n_frames=13, shape=(H, W), fx=120.0, speed=0.12, seed=3)
    args = (seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline)
    cfg_t = _small(Config)
    cfg_j = JConfig(
        use_orb=True, image_height=H, image_width=W,
        orb_params=dataclasses.replace(JConfig().orb_params, **dataclasses.asdict(
            cfg_t.orb_params)),
        capacity=dataclasses.replace(JConfig().capacity, **dataclasses.asdict(cfg_t.capacity)),
        tracking=dataclasses.replace(JConfig().tracking, features_to_track=140))
    fr = list(seq)
    jvo = JStereoVO(cfg_j, jcam.from_intrinsics(*args), chunk=12, kf_cadence=6)
    rj = jvo.run_chunked(fr)
    tvo = StereoVO(cfg_t, tcam.from_intrinsics(*args), chunk=12, kf_cadence=6, device="cpu")
    rt = tvo.run_chunked(fr)
    np.testing.assert_array_equal(tstate.to_numpy(tvo.state).rng, np.asarray(jvo.state.rng))
    live_j, live_t = rj.metrics[1:, 2], rt.metrics[1:, 2]
    assert live_j.min() > 40 and live_t.min() > 40
    assert live_t.max() > 128  # the PnP problem past the narrow path's N
    assert live_t.mean() > 0.7 * live_j.mean(), (live_t.mean(), live_j.mean())
    assert np.isfinite(rt.poses).all() and rt.poses.shape == rj.poses.shape
    dt = np.linalg.norm(rj.poses[:, :3, 3] - rt.poses[:, :3, 3], axis=-1)
    assert dt.max() < 0.1, f"trajectories diverge: {dt}"
    for a, b in zip(rj.poses, rt.poses):
        assert _angle_deg(a, b) < 1.0
    np.testing.assert_array_equal(rt.kf_flags, rj.kf_flags)


def _call(n, S=2):
    K = torch.eye(3)
    return (K, torch.zeros(S, n, 3), torch.zeros(S, n, 2), torch.ones(S, n, dtype=torch.bool),
            torch.zeros(S, RansacParams().num_hypotheses, n), RansacParams(), torch.eye(4).expand(
                S, 4, 4).contiguous())


@pytest.mark.parametrize("n", [129, 192, 256, 1000, 1024, 1120, 2047, 2048])
def test_the_kernel_takes_the_dense_sizes(n):
    args = _call(n)
    assert pnp.kernel_shapes(*args) == (2, n, RansacParams().num_hypotheses, 1)


def test_the_kernel_refuses_2049_before_anything_is_built(monkeypatch):
    def no_build():
        raise AssertionError("the kernel library was loaded before the shape was checked")

    monkeypatch.setattr(_build, "load", no_build)
    with pytest.raises(ValueError, match="N <= 2048"):
        pnp.kernel_shapes(*_call(2049))
