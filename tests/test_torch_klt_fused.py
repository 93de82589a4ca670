"""The port's fused KLT engine against svo_tpu's, tracker and pipeline.

svo_tpu picks its engine when svo_tpu/ops/klt.py is imported and its jit
cache does not key on that choice, so its side runs once, in a fresh
interpreter with SVO_TPU_FUSED_INTERPRET=1 (the fused kernel in Pallas
interpret mode), as tests/test_lk_fused_pipeline.py does, and writes npz
files; the port runs engine="fused" / lk_engine="fused" on the CPU here.

Cases and tolerances:
(a) KltTracker.track at 128x384 (L0-L2 fused in one whole-call run, L3
    through the patches), the temporal, stereo and fb cases of
    test_torch_klt.py, and the temporal case at 96x544, where all four
    levels pass svo_tpu's rule and the port's tracker call is one run:
    status equal on >= 99% of the slots, positions within 1e-3 px where
    both are True.
(b) One keyframe step_body from svo_tpu's fused bootstrap state with
    svo_tpu's PnP noise: pose within 1e-4, masks and ids identical, positions within
    1e-3 px.
(c) The 13-frame 96x256 run_chunked (chunk 12, cadence 6; the PnP noise
    differs): live >= 40 every frame, mean live >= 70% of svo_tpu's,
    trajectories within 10 cm and 1 degree, equal keyframe flags. At this
    size the noise picks one of a few trajectories (ROADMAP C), so the
    same cadenced steps are also driven with svo_tpu's noise of each step:
    poses within 1e-4, the bound of (b).
"""

import dataclasses
import os
import subprocess
import sys
from types import SimpleNamespace

import jax  # noqa: F401  (jax before torch, see tests/conftest.py)
import numpy as np
import pytest
import torch

from svo_tpu_torch.config import Config as TConfig
from svo_tpu_torch.geometry import camera as tcam
from svo_tpu_torch.io.synthetic import SyntheticSequence
from svo_tpu_torch.ops.klt import KltTracker as TKlt
from svo_tpu_torch.pipeline import frontend as tfront
from svo_tpu_torch.pipeline import state as tstate
from svo_tpu_torch.pipeline.odometry import StereoVO as TStereoVO

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KLT_SHAPE = (128, 384)
WIDE_SHAPE = (96, 544)  # L3 is 132 px wide padded: every level is fused
PIPE_SHAPE = (96, 256)

_DRIVER = r"""
import dataclasses, sys
sys.path.insert(0, @REPO@)
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from svo_tpu.config import Config
from svo_tpu.geometry import camera as cam_mod
from svo_tpu.io.synthetic import SyntheticSequence
from svo_tpu.ops import klt
from svo_tpu.ops.detect import detect_fast
from svo_tpu.pipeline import frontend
from svo_tpu.pipeline.odometry import StereoVO
assert klt._FUSED_INTERP
out = sys.argv[1]

def flat(tree, prefix):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {prefix + jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}

# (a) the tracker at 128x384, inputs as tests/test_torch_klt.py makes them
H, W = @KLT@
seq = SyntheticSequence(n_frames=3, shape=(H, W), fx=160.0, speed=0.25, seed=11)
(l0, r0), (l1, _) = seq.frame(0), seq.frame(1)
cfg = Config(use_orb=False, image_height=H, image_width=W)
pos, _, valid = detect_fast(jnp.asarray(l0), 20.0, None, cfg)
pos, valid = np.array(pos), np.array(valid)
rng = np.random.default_rng(7)
valid[rng.choice(len(valid), 12, replace=False)] = False
pos[:4] = [[1.0, 1.0], [W - 2.0, H - 2.0], [0.5, H / 2], [W / 2, 0.5]]
valid[:4] = True
pos = pos.astype(np.float32)

def track(prev, curr, pos, valid, params, init=None):
    r = klt.KltTracker.track(
        klt.KltTracker.build_pyramid(jnp.asarray(prev), params.max_level),
        klt.KltTracker.build_pyramid(jnp.asarray(curr), params.max_level),
        jnp.asarray(pos), jnp.asarray(valid), params,
        init_flow=None if init is None else jnp.asarray(init))
    return np.asarray(r.pos), np.asarray(r.status)

res = dict(l0=l0, r0=r0, l1=l1, pos=pos, valid=valid)
res["temporal_pos"], res["temporal_status"] = track(l0, l1, pos, valid, cfg.temporal_klt)
res["stereo_pos"], res["stereo_status"] = track(l0, r0, pos, valid, cfg.stereo_klt)
pf, sf = res["temporal_pos"], res["temporal_status"]
res["fb_in_pos"], res["fb_in_valid"], res["fb_init"] = pf, valid & sf, pos - pf
fb = dataclasses.replace(cfg.temporal_klt, max_level=0, max_iters=8)
res["fb_pos"], res["fb_status"] = track(l1, l0, pf, valid & sf, fb, init=pos - pf)

# (a') the temporal call where every level takes the fused kernel
H, W = @WIDE@
seq = SyntheticSequence(n_frames=2, shape=(H, W), fx=160.0, speed=0.25, seed=11)
(l0, _), (l1, _) = seq.frame(0), seq.frame(1)
cfg = Config(use_orb=False, image_height=H, image_width=W)
pos, _, valid = detect_fast(jnp.asarray(l0), 20.0, None, cfg)
pos, valid = np.array(pos)[:64].astype(np.float32), np.array(valid)[:64]
valid[::7] = False
res.update(wide_l0=l0, wide_l1=l1, wide_pos=pos, wide_valid=valid)
res["wide_out_pos"], res["wide_out_status"] = track(l0, l1, pos, valid, cfg.temporal_klt)

# (b) one step from the fused bootstrap state, with this step's PnP noise
H, W = @PIPE@
seq = SyntheticSequence(n_frames=13, shape=(H, W), fx=120.0, speed=0.12, seed=3)
cam = cam_mod.from_intrinsics(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline)
cfg = Config(use_orb=False, image_height=H, image_width=W)
l0, r0 = seq.frame(0)
l1, r1 = seq.frame(1)
st = frontend.make_bootstrap(cam, cfg)(jnp.asarray(l0), jnp.asarray(r0), jnp.uint32(0))
res.update(flat(jax.tree.map(np.asarray, st), "boot"))
_, sub = jax.random.split(st.rng)
res["noise"] = np.array(jax.random.gumbel(
    sub, (cfg.ransac.num_hypotheses, cfg.capacity.max_features)))
step = jax.jit(lambda s, l, r: frontend.step_body(s, l, r, cam, cfg, kf_mode="always"))
res.update(flat(jax.tree.map(np.asarray, step(st, jnp.asarray(l1), jnp.asarray(r1))), "step"))

# (c) bench.py's cadenced chunk path, from the same bootstrap state, and
# the PnP noise of each of its steps (frontend.py:317)
rc = StereoVO(cfg, cam, chunk=12, kf_cadence=6).run_chunked(list(seq))
res.update(run_poses=rc.poses, run_metrics=rc.metrics, run_kf=rc.kf_flags)
rng, noises = st.rng, []
for _ in range(12):
    rng, sub = jax.random.split(rng)
    noises.append(np.array(jax.random.gumbel(
        sub, (cfg.ransac.num_hypotheses, cfg.capacity.max_features))))
res["run_noise"] = np.stack(noises)
np.savez(out, **res)
print("DONE")
"""


@pytest.fixture(scope="module")
def svo(tmp_path_factory):
    """svo_tpu's fused-interpret results, from one subprocess."""
    out = tmp_path_factory.mktemp("svo_fused") / "svo_tpu_fused.npz"
    src = (_DRIVER.replace("@REPO@", repr(REPO)).replace("@KLT@", repr(KLT_SHAPE))
           .replace("@WIDE@", repr(WIDE_SHAPE))
           .replace("@PIPE@", repr(PIPE_SHAPE)))
    env = dict(os.environ, JAX_PLATFORMS="", SVO_TPU_FUSED_INTERPRET="1")
    env.pop("SVO_TPU_FUSED_LK", None)
    env.pop("SVO_TPU_NO_PALLAS", None)
    proc = subprocess.run(
        [sys.executable, "-c", src, str(out)],
        capture_output=True, text=True, timeout=900, env=env,
    )
    assert proc.returncode == 0 and "DONE" in proc.stdout, proc.stderr[-3000:]
    with np.load(out) as z:
        return dict(z)


def _status_and_pos(pj, sj, pt, st, min_tracked):
    assert (sj == st).mean() >= 0.99, f"status agrees on {(sj == st).mean():.3f}"
    both = sj & st
    assert both.sum() >= min_tracked
    np.testing.assert_allclose(pt[both], pj[both], rtol=0, atol=1e-3)


@pytest.mark.parametrize("case", ["temporal", "stereo", "fb"])
def test_fused_track_matches_svo_tpu(svo, case):
    cfg = TConfig()
    t = {k: torch.from_numpy(svo[k]) for k in ("l0", "r0", "l1")}
    if case == "temporal":
        params, prev, curr = cfg.temporal_klt, t["l0"], t["l1"]
        pos, valid, init = svo["pos"], svo["valid"], None
    elif case == "stereo":
        params, prev, curr = cfg.stereo_klt, t["l0"], t["r0"]
        pos, valid, init = svo["pos"], svo["valid"], None
    else:
        params = dataclasses.replace(cfg.temporal_klt, max_level=0, max_iters=8)
        prev, curr = t["l1"], t["l0"]
        pos, valid, init = svo["fb_in_pos"], svo["fb_in_valid"], svo["fb_init"]
    r = TKlt.track(
        TKlt.build_pyramid(prev, params.max_level),
        TKlt.build_pyramid(curr, params.max_level),
        torch.from_numpy(pos), torch.from_numpy(valid), params,
        init_flow=None if init is None else torch.from_numpy(init), engine="fused",
    )
    _status_and_pos(svo[f"{case}_pos"], svo[f"{case}_status"],
                    r.pos.numpy(), r.status.numpy(), min_tracked=40)


def test_fused_track_all_levels_in_one_run_matches_svo_tpu(svo):
    """96x544: the port's temporal call is ONE lk_track_pyramid run over
    all four levels; svo_tpu runs its fused kernel level by level."""
    params = TConfig().temporal_klt
    prev, curr = torch.from_numpy(svo["wide_l0"]), torch.from_numpy(svo["wide_l1"])
    r = TKlt.track(
        TKlt.build_pyramid(prev, params.max_level), TKlt.build_pyramid(curr, params.max_level),
        torch.from_numpy(svo["wide_pos"]), torch.from_numpy(svo["wide_valid"]), params,
        engine="fused",
    )
    _status_and_pos(svo["wide_out_pos"], svo["wide_out_status"],
                    r.pos.numpy(), r.status.numpy(), min_tracked=15)


def _tree(z, prefix):
    """svo_tpu's flattened VoState -> an object from_numpy can read."""
    def g(k):
        return z[prefix + k]

    n_lvl = sum(1 for k in z if k.startswith(prefix + ".prev_pyramid[0]["))
    return SimpleNamespace(
        features=SimpleNamespace(**{f: g(f".features.{f}") for f in tstate.FeatureSet._fields}),
        map=SimpleNamespace(**{f: g(f".map.{f}") for f in tstate.MapState._fields}),
        prev_pyramid=(
            tuple(g(f".prev_pyramid[0][{i}]") for i in range(n_lvl)),
            tuple((g(f".prev_pyramid[1][{i}][0]"), g(f".prev_pyramid[1][{i}][1]"))
                  for i in range(n_lvl)),
        ),
        **{f: g("." + f) for f in tstate.VoState._fields[3:]},
    )


def _pipe():
    seq = SyntheticSequence(n_frames=13, shape=PIPE_SHAPE, fx=120.0, speed=0.12, seed=3)
    cam = tcam.from_intrinsics(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline)
    cfg = TConfig(use_orb=False, image_height=PIPE_SHAPE[0], image_width=PIPE_SHAPE[1])
    return seq, cam, cfg


def test_fused_step_from_svo_tpu_state(svo):
    """A keyframe step: all three tracker calls (temporal, fb, stereo)."""
    seq, cam, cfg = _pipe()
    l1, r1 = seq.frame(1)
    st = tstate.from_numpy(_tree(svo, "boot"), "cpu")
    out_t = tstate.to_numpy(tfront.step_body(
        st, torch.from_numpy(l1), torch.from_numpy(r1), cam, cfg, kf_mode="always",
        pnp_noise=torch.from_numpy(svo["noise"]), lk_engine="fused",
    ))
    out_j = _tree(svo, "step")
    np.testing.assert_allclose(out_t.pose, out_j.pose, rtol=1e-4, atol=1e-4)
    fj, ft = out_j.features, out_t.features
    assert fj.valid.sum() > 40
    np.testing.assert_array_equal(ft.valid, fj.valid)
    v = fj.valid
    np.testing.assert_allclose(ft.pos[v], fj.pos[v], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(ft.point_id[v], fj.point_id[v])
    np.testing.assert_array_equal(ft.age[v], fj.age[v])
    assert int(out_t.map.n_points) == int(out_j.map.n_points)
    for f in ("frame_id", "prev_is_kf", "last_kf_id", "prior_ok", "kf_flags"):
        np.testing.assert_array_equal(getattr(out_t, f), getattr(out_j, f))


def test_fused_run_chunked_matches_svo_tpu(svo):
    seq, cam, cfg = _pipe()
    rt = TStereoVO(cfg, cam, chunk=12, kf_cadence=6, device="cpu", lk_engine="fused").run_chunked(list(seq))
    live_j, live_t = svo["run_metrics"][1:, 2], rt.metrics[1:, 2]
    assert live_j.min() > 40 and live_t.min() > 40
    assert live_t.mean() > 0.7 * live_j.mean(), (live_t.mean(), live_j.mean())
    pj = svo["run_poses"]
    assert np.isfinite(rt.poses).all() and rt.poses.shape == pj.shape
    dt = np.linalg.norm(pj[:, :3, 3] - rt.poses[:, :3, 3], axis=-1)
    assert dt.max() < 0.1, f"trajectories diverge: {dt}"
    for a, b in zip(pj, rt.poses):
        c = (np.trace(a[:3, :3].T @ b[:3, :3]) - 1) / 2
        assert np.degrees(np.arccos(np.clip(c, -1, 1))) < 1.0
    np.testing.assert_array_equal(rt.kf_flags, svo["run_kf"])


def test_stereo_vo_rejects_unknown_engine():
    _, cam, cfg = _pipe()
    with pytest.raises(ValueError, match="lk_engine"):
        TStereoVO(cfg, cam, device="cpu", lk_engine="xla")


def test_fused_cadenced_steps_with_svo_tpu_noise(svo):
    """run_chunked's steps (uint8 frames, keyframe every 6) with the PnP
    noise svo_tpu drew for each of them."""
    seq, cam, cfg = _pipe()
    frames = list(seq)
    st = tfront.make_bootstrap(cam, cfg, "fused")(
        torch.from_numpy(frames[0][1]), torch.from_numpy(frames[0][2]), 0
    )
    for i, (_, left, right) in enumerate(frames[1:]):
        l8, r8 = (torch.from_numpy(np.clip(a, 0, 255).astype(np.uint8)) for a in (left, right))
        st = tfront.step_body(
            st, l8.to(torch.float32), r8.to(torch.float32), cam, cfg,
            kf_mode="always" if i % 6 == 0 else "never",
            pnp_noise=torch.from_numpy(svo["run_noise"][i]), lk_engine="fused",
        )
    np.testing.assert_allclose(st.poses[: len(frames)].numpy(), svo["run_poses"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(st.kf_flags[: len(frames)].numpy(), svo["run_kf"])
