"""The port's pyramidal KLT tracker against svo_tpu's on the same frames.

Cases: temporal (window 21, margin 6, 4 levels, prev -> curr frame),
stereo (window 11, margin_x 16, left -> right) and the forward-backward
re-track (level 0, 8 iterations, seeded with the reverse flow).

Tolerances: positions within 1e-3 px where both status flags are True
(f32 sums over the window in another order, amplified by the 2x2 solve
over a few iterations), status equal on >= 99% of the slots (a feature
whose convergence or border test sits within rounding of its threshold may
flip). svo_tpu's CPU path slices dead slots' patches where the port, like
svo_tpu's TPU kernel, zeroes them, so positions are compared only where
status is True.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_tpu.config import Config as JConfig
from svo_tpu.io.synthetic import SyntheticSequence
from svo_tpu.ops.detect import detect_fast
from svo_tpu.ops.klt import KltTracker as JKlt
from svo_tpu_torch.config import Config as TConfig
from svo_tpu_torch.ops.klt import KltTracker as TKlt

torch.set_num_threads(2)

H, W = 128, 384


@pytest.fixture(scope="module")
def frames():
    seq = SyntheticSequence(n_frames=3, shape=(H, W), fx=160.0, speed=0.25, seed=11)
    return [seq.frame(i) for i in range(3)]


def _features(img, rng):
    cfg = JConfig(use_orb=False, image_height=H, image_width=W)
    pos, _, valid = detect_fast(jnp.asarray(img), 20.0, None, cfg)
    pos, valid = np.array(pos), np.array(valid)
    # a few dead slots and near-border features on top of the detections
    valid[rng.choice(len(valid), 12, replace=False)] = False
    pos[:4] = [[1.0, 1.0], [W - 2.0, H - 2.0], [0.5, H / 2], [W / 2, 0.5]]
    valid[:4] = True
    return pos.astype(np.float32), valid


def _track(prev, curr, pos, valid, params_name, init=None, fb=False):
    cj = getattr(JConfig(), params_name)
    ct = getattr(TConfig(), params_name)
    if fb:
        cj = dataclasses.replace(cj, max_level=0, max_iters=8)
        ct = dataclasses.replace(ct, max_level=0, max_iters=8)
    pj = JKlt.build_pyramid(jnp.asarray(prev), cj.max_level)
    qj = JKlt.build_pyramid(jnp.asarray(curr), cj.max_level)
    rj = JKlt.track(pj, qj, jnp.asarray(pos), jnp.asarray(valid), cj,
                    init_flow=None if init is None else jnp.asarray(init))
    pt = TKlt.build_pyramid(torch.from_numpy(prev), ct.max_level)
    qt = TKlt.build_pyramid(torch.from_numpy(curr), ct.max_level)
    rt = TKlt.track(pt, qt, torch.tensor(pos), torch.tensor(valid), ct,
                    init_flow=None if init is None else torch.tensor(init))
    return (np.asarray(rj.pos), np.asarray(rj.status)), (rt.pos.numpy(), rt.status.numpy())


def _compare(j, t, min_tracked):
    (pj, sj), (pt, st) = j, t
    assert (sj == st).mean() >= 0.99, f"status agrees on {(sj == st).mean():.3f}"
    both = sj & st
    assert both.sum() >= min_tracked
    np.testing.assert_allclose(pt[both], pj[both], rtol=0, atol=1e-3)


@pytest.mark.parametrize("case", ["temporal", "stereo", "fb"])
def test_track_matches_svo_tpu(frames, case):
    rng = np.random.default_rng(7)
    (l0, r0), (l1, _), _ = frames
    pos, valid = _features(l0, rng)
    if case == "temporal":
        j, t = _track(l0, l1, pos, valid, "temporal_klt")
    elif case == "stereo":
        j, t = _track(l0, r0, pos, valid, "stereo_klt")
    else:
        # back from l1 to l0, seeded with the reverse of the forward flow
        (pf, sf), _ = _track(l0, l1, pos, valid, "temporal_klt")
        j, t = _track(l1, l0, pf, valid & sf, "temporal_klt", init=pos - pf, fb=True)
    _compare(j, t, min_tracked=40)
