"""The port's frame step under non-default pipeline options, against
svo_tpu's: two steps from svo_tpu's bootstrap state with svo_tpu's PnP
noise, so the second step runs with a healthy motion prior.

- anchored KLT + flow seeding, dynamic keyframe rule (the host branch);
- no motion prior, no fb check, no motion gate, no age cap, DLT
  triangulation, plain global top-k detection, keyframe every frame.

Tolerances as in test_torch_pipeline.py: pose 1e-4, feature masks and
ids identical, positions 1e-3 px.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_tpu.config import Config as JConfig
from svo_tpu.geometry import camera as jcam
from svo_tpu.io.synthetic import SyntheticSequence
from svo_tpu.pipeline import frontend as jfront
from svo_tpu_torch.config import Config as TConfig
from svo_tpu_torch.geometry import camera as tcam
from svo_tpu_torch.pipeline import frontend as tfront
from svo_tpu_torch.pipeline import state as tstate

torch.set_num_threads(2)

H, W = 96, 256


def _replace(cfg, **groups):
    out = {}
    for name, fields in groups.items():
        sub = getattr(cfg, name)
        out[name] = dataclasses.replace(sub, **fields) if dataclasses.is_dataclass(sub) else fields
    return dataclasses.replace(cfg, **out)


VARIANTS = {
    "anchored_seeded_dynamic": (
        dict(tracking=dict(anchored_klt=True), flow_seeding=True), "dynamic"),
    "plain_options_always": (
        dict(motion_prior=False, triangulator="dlt", bucket=dict(enabled=False),
             tracking=dict(fb_check=False, max_step_rot_deg=0.0, max_track_age=0)),
        "always"),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_two_steps_from_svo_tpu_state(variant):
    overrides, kf_mode = VARIANTS[variant]
    seq = SyntheticSequence(n_frames=3, shape=(H, W), fx=120.0, speed=0.12, seed=3)
    args = (seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline)
    cam_j, cam_t = jcam.from_intrinsics(*args), tcam.from_intrinsics(*args)
    base = dict(use_orb=False, image_height=H, image_width=W)
    cfg_j = _replace(JConfig(**base), **overrides)
    cfg_t = _replace(TConfig(**base), **overrides)
    assert dataclasses.asdict(cfg_j) == dataclasses.asdict(cfg_t)

    frames = [seq.frame(i) for i in range(3)]
    st_j = jfront.make_bootstrap(cam_j, cfg_j)(*map(jnp.asarray, frames[0]), jnp.uint32(0))
    st_t = tstate.from_numpy(jax.tree.map(np.asarray, st_j), "cpu")
    step_j = jax.jit(lambda s, l, r: jfront.step_body(s, l, r, cam_j, cfg_j, kf_mode=kf_mode))
    H_hyp, N = cfg_j.ransac.num_hypotheses, cfg_j.capacity.max_features
    for left, right in frames[1:]:
        _, sub = jax.random.split(st_j.rng)
        noise = torch.tensor(np.asarray(jax.random.gumbel(sub, (H_hyp, N))))
        st_j = step_j(st_j, jnp.asarray(left), jnp.asarray(right))
        st_t = tfront.step_body(
            st_t, torch.from_numpy(left), torch.from_numpy(right), cam_t, cfg_t,
            kf_mode=kf_mode, pnp_noise=noise,
        )
        oj, ot = jax.tree.map(np.asarray, st_j), tstate.to_numpy(st_t)
        np.testing.assert_allclose(ot.pose, oj.pose, rtol=1e-4, atol=1e-4)
        v = oj.features.valid
        assert v.sum() > 40
        np.testing.assert_array_equal(ot.features.valid, v)
        np.testing.assert_allclose(ot.features.pos[v], oj.features.pos[v], rtol=0, atol=1e-3)
        np.testing.assert_allclose(ot.features.anchor[v], oj.features.anchor[v], rtol=0, atol=1e-3)
        np.testing.assert_array_equal(ot.features.point_id[v], oj.features.point_id[v])
        np.testing.assert_array_equal(ot.prev_is_kf, oj.prev_is_kf)
        np.testing.assert_array_equal(ot.prior_ok, oj.prior_ok)
        assert int(ot.map.n_points) == int(oj.map.n_points)
        for a, b in zip(jax.tree.leaves(ot.prev_pyramid), jax.tree.leaves(oj.prev_pyramid)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
