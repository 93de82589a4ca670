"""The back-end inside the engines, against svo_tpu's.

(a) BatchedStereoVO.refine: S=2 streams run 13 frames at 96x256 through the
    port's cadenced path (chunk 12, cadence 6); the state is handed to
    svo_tpu (its VoState built from the numpy leaves) and carried back with
    state.from_numpy; stream 1's recent trajectory is then bent, so that
    one sweep takes the conservative regime on stream 0 and the aggressive
    one on stream 1. Both packages refine (3 blocks of 5 cameras, span 11):
    verdicts identical; `pose` and `poses` within 1e-4 on the healthy
    stream and 5e-3 on the rebuilt one (read 2.5e-3 of a 24 cm correction:
    block BA and pose graph at their accept edges, see
    test_torch_global_opt.py, on 96x256 images at fx 120, where a pixel is
    a large angle); the recursive `pose` is `poses[frame_id]`.
(b) cfg.ba.enabled=True through the frame steps at the size of
    tests/test_ba_window.py::test_pipeline_with_ba_runs (184x320, 14 frames,
    window 2, interval 1, dynamic keyframes), svo_tpu's PnP noise fed to
    the port: the same keyframes, the port's BA solves at the frames the
    rule gives from kf_flags, poses within 1e-4 up to the first solve and
    1e-3 after it, ATE under 5% of
    the distance travelled. And StereoVO.run with ba.enabled on its own
    generator, held to that ATE bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_tpu.config import BaParams as JBaParams
from svo_tpu.config import Config as JConfig
from svo_tpu.eval.trajectory import ate_rmse
from svo_tpu.geometry import camera as jcam
from svo_tpu.io.synthetic import SyntheticSequence
from svo_tpu.parallel.batched import BatchedStereoVO as JBatched
from svo_tpu.pipeline import frontend as jfront
from svo_tpu.pipeline.state import FeatureSet as JFeatureSet
from svo_tpu.pipeline.state import MapState as JMapState
from svo_tpu.pipeline.state import VoState as JVoState
from svo_tpu_torch.config import BaParams as TBaParams
from svo_tpu_torch.config import Config as TConfig
from svo_tpu_torch.geometry import camera as tcam
from svo_tpu_torch.parallel.batched import BatchedStereoVO as TBatched
from svo_tpu_torch.pipeline import frontend as tfront
from svo_tpu_torch.pipeline import state as tstate
from svo_tpu_torch.pipeline.odometry import StereoVO as TStereoVO

torch.set_num_threads(2)

S = 2
REFINER = dict(n_blocks=3, cams_per_block=5, n_points=256, n_obs=1024, ba_iterations=8, pg_iterations=6)


def _u8(x):
    return np.clip(x, 0, 255).astype(np.uint8)


def _jax_state(tree) -> JVoState:
    """svo_tpu's VoState from the port's state as numpy leaves."""
    levels, grads = tree.prev_pyramid
    lead = tree.frame_id.shape
    return JVoState(
        features=JFeatureSet(*(jnp.asarray(x) for x in tree.features)),
        map=JMapState(*(jnp.asarray(x) for x in tree.map)),
        prev_pyramid=(tuple(jnp.asarray(l) for l in levels),
                      tuple((jnp.asarray(gx), jnp.asarray(gy)) for gx, gy in grads)),
        **{f: jnp.asarray(getattr(tree, f)) for f in tstate.VoState._fields[3:]},
        rng=jnp.zeros(lead + (2,), jnp.uint32),
    )


@pytest.fixture(scope="module")
def refined():
    seqs = [SyntheticSequence(n_frames=13, shape=(96, 256), fx=120.0, speed=0.12, seed=3 + s)
            for s in range(S)]
    frames = [list(q) for q in seqs]
    kw = dict(use_orb=False, image_height=96, image_width=256)
    args = (120.0, 120.0, 128.0, 48.0, seqs[0].baseline)
    bvo = TBatched(TConfig(**kw), tcam.from_intrinsics(*args), S, chunk=12, kf_cadence=6, device="cpu")
    bvo.start(np.stack([fr[0][1] for fr in frames]), np.stack([fr[0][2] for fr in frames]))
    bvo.process_chunk(*(np.stack([np.stack([_u8(fr[t][k]) for fr in frames]) for t in range(1, 13)])
                        for k in (1, 2)))
    tree = tstate.to_numpy(bvo.state)
    # bend stream 1's last 8 poses: a growing yaw and side slip, as drift does
    for k, f in enumerate(range(5, 13)):
        a = 0.01 * (k + 1)
        bend = np.eye(4, dtype=np.float32)
        bend[0, 0], bend[0, 2], bend[2, 0], bend[2, 2] = np.cos(a), np.sin(a), -np.sin(a), np.cos(a)
        bend[0, 3] = 0.03 * (k + 1)
        tree.poses[1, f] = tree.poses[1, f] @ bend
    tree.pose[1] = tree.poses[1, 12]

    jb = JBatched(JConfig(**kw), jcam.from_intrinsics(*args), S, chunk=12, kf_cadence=6)
    jb.make_refiner(**REFINER)
    jb.state = _jax_state(tree)
    before = jax.tree.map(np.array, jb.state)  # copied: the refiner donates its state
    acc_j = jb.refine()
    after_j = jax.tree.map(np.asarray, jb.state)

    bvo.state = tstate.from_numpy(before, "cpu")
    bvo.make_refiner(**REFINER)
    acc_t = bvo.refine()
    return dict(before=before, acc_j=acc_j, after_j=after_j, acc_t=acc_t,
                after_t=tstate.to_numpy(bvo.state), bvo=bvo)


def test_batched_refine_matches_svo_tpu(refined):
    r = refined
    assert r["acc_t"].dtype == np.bool_ and r["acc_t"].shape == (S,)
    assert np.array_equal(r["acc_t"], r["acc_j"])
    assert r["acc_t"][1], "the bent stream was not rebuilt"
    aj, at, b = r["after_j"], r["after_t"], r["before"]
    for s, tol in ((0, 1e-4), (1, 5e-3)):
        np.testing.assert_allclose(at.poses[s], aj.poses[s], atol=tol, rtol=0)
        np.testing.assert_allclose(at.pose[s], aj.pose[s], atol=tol, rtol=0)
        # points within 20 m: at fx 120 and a 0.5 m baseline a point at 100 m
        # has 0.6 px of disparity, and 0.02 px of it is 3 m of depth
        near = np.linalg.norm(aj.map.points[s], axis=-1) < 20.0
        np.testing.assert_allclose(at.map.points[s][near], aj.map.points[s][near], atol=20 * tol, rtol=0)
        assert np.array_equal(at.pose[s], at.poses[s, 12])  # the recursive pose follows
    assert np.array_equal(at.poses[0], b.poses[0])          # healthy: poses never move
    assert not np.array_equal(at.poses[1, 5:13], b.poses[1, 5:13])
    # nothing but points, poses and pose is touched
    for name in ("features", "prev_pyramid", "frame_id", "kf_flags", "metrics", "rel_motion"):
        for x, y in zip(jax.tree.leaves(getattr(at, name)), jax.tree.leaves(getattr(b, name))):
            assert np.array_equal(x, y), name
    for f in at.map._fields[1:]:
        assert np.array_equal(getattr(at.map, f), getattr(b.map, f)), f


def test_refine_twice_is_bit_identical(refined):
    bvo = refined["bvo"]
    out = []
    for _ in range(2):
        bvo.state = tstate.from_numpy(refined["before"], "cpu")
        acc = bvo.refine()
        out.append((acc, tstate.to_numpy(bvo.state)))
    assert np.array_equal(out[0][0], out[1][0])
    for x, y in zip(jax.tree.leaves(out[0][1]), jax.tree.leaves(out[1][1])):
        assert np.array_equal(x, y)


# ---- (b) the in-pipeline window BA -----------------------------------------

BA_SHAPE = (184, 320)
BA = dict(enabled=True, window=2, interval=1, max_points=512, max_obs=2048, iterations=5)


@pytest.fixture(scope="module")
def ba_seq():
    return SyntheticSequence(n_frames=14, shape=BA_SHAPE, fx=200.0, speed=0.25)


def _ba_setup(seq, Config, BaParams, cam_mod):
    cfg = Config(use_orb=False, image_height=BA_SHAPE[0], image_width=BA_SHAPE[1], ba=BaParams(**BA))
    cam = cam_mod.from_intrinsics(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline)
    return cfg, cam


@pytest.fixture(scope="module")
def ba_runs(ba_seq):
    """svo_tpu's frame steps with BA on (dynamic keyframes), the port's with
    the noise svo_tpu drew at each step, and the frames at which the port
    ran its window BA."""
    frames = list(ba_seq)
    cfg_j, cam_j = _ba_setup(ba_seq, JConfig, JBaParams, jcam)
    cfg_t, cam_t = _ba_setup(ba_seq, TConfig, TBaParams, tcam)
    step_j = jax.jit(lambda s, l, r: jfront.step_body(s, l, r, cam_j, cfg_j))
    st_j = jfront.make_bootstrap(cam_j, cfg_j)(
        jnp.asarray(frames[0][1]), jnp.asarray(frames[0][2]), jnp.uint32(0))
    st_t = tfront.make_bootstrap(cam_t, cfg_t)(
        torch.from_numpy(frames[0][1]), torch.from_numpy(frames[0][2]))
    shape = (cfg_j.ransac.num_hypotheses, cfg_j.capacity.max_features)
    solved = []
    window_ba = tfront._window_ba

    def counted(mp, poses, kf_flags, fid, camera, cfg):
        solved.append(int(fid))
        return window_ba(mp, poses, kf_flags, fid, camera, cfg)

    monkey = pytest.MonkeyPatch()
    monkey.setattr(tfront, "_window_ba", counted)
    for i, left, right in frames[1:]:
        _, sub = jax.random.split(st_j.rng)
        noise = np.asarray(jax.random.gumbel(sub, shape))
        st_j = step_j(st_j, jnp.asarray(left), jnp.asarray(right))
        st_t = tfront.step_body(st_t, torch.from_numpy(left), torch.from_numpy(right), cam_t, cfg_t,
                                pnp_noise=torch.from_numpy(noise))
    monkey.undo()
    return dict(j=jax.tree.map(np.asarray, st_j), t=tstate.to_numpy(st_t), solved=solved)


def test_pipeline_with_ba_matches_svo_tpu(ba_seq, ba_runs):
    j, t = ba_runs["j"], ba_runs["t"]
    n = 14
    assert np.array_equal(t.kf_flags[:n], j.kf_flags[:n])
    # the rule of the frontend, from the keyframe flags
    count = np.cumsum(t.kf_flags[:n])
    due = [f for f in range(1, n) if t.kf_flags[f] and count[f] >= BA["window"] and count[f] % BA["interval"] == 0]
    assert ba_runs["solved"] == due and len(due) >= 2
    first = due[0]
    # the final trajectory: frames the solves rewrote and the frames after them
    np.testing.assert_allclose(t.poses[:n], j.poses[:n], atol=1e-3, rtol=0)
    np.testing.assert_allclose(t.pose, j.pose, atol=1e-3, rtol=0)
    assert np.array_equal(t.pose, t.poses[n - 1])
    # frames before the first window's first keyframe were never touched by BA
    kfs = np.nonzero(t.kf_flags[:n])[0]
    untouched = kfs[kfs <= first][-BA["window"]]
    np.testing.assert_allclose(t.poses[:untouched + 1], j.poses[:untouched + 1], atol=1e-4, rtol=0)
    travelled = np.linalg.norm(np.diff(ba_seq.gt_poses[:, :3, 3], axis=0), axis=1).sum()
    for poses in (t.poses[:n], j.poses[:n]):
        assert ate_rmse(poses, ba_seq.gt_poses) < 0.05 * travelled


def test_stereo_vo_run_with_ba(ba_seq):
    """tests/test_ba_window.py::test_pipeline_with_ba_runs, through the port."""
    cfg, cam = _ba_setup(ba_seq, TConfig, TBaParams, tcam)
    res = TStereoVO(cfg, cam, device="cpu").run(list(ba_seq))
    travelled = np.linalg.norm(np.diff(ba_seq.gt_poses[:, :3, 3], axis=0), axis=1).sum()
    ate = ate_rmse(res.poses, ba_seq.gt_poses)
    assert np.isfinite(ate) and ate < 0.05 * travelled, f"ATE with BA {ate:.3f} m over {travelled:.1f} m"


def test_batched_ba_selects_per_stream(ba_seq):
    """Two streams whose keyframe counts differ: the solve runs when ANY
    stream's rule fires and is kept only by that stream; the other stream's
    step equals its step without BA, bit for bit."""
    frames = list(ba_seq)[:4]
    cfg, cam = _ba_setup(ba_seq, TConfig, TBaParams, tcam)
    cfg_off, _ = _ba_setup(ba_seq, TConfig, lambda **kw: TBaParams(**{**kw, "enabled": False}), tcam)
    gen = torch.Generator().manual_seed(0)
    img = lambda a: torch.from_numpy(np.stack([a, a]))  # noqa: E731
    st = tfront.make_bootstrap(cam, cfg)(img(frames[0][1]), img(frames[0][2]))
    noise = [tfront.gumbel_noise((2, cfg.ransac.num_hypotheses, cfg.capacity.max_features), gen, "cpu")
             for _ in range(3)]
    # two track-only steps, then a keyframe step with stream 1's keyframe
    # count pushed to an odd value under interval 2: only stream 0 is due
    for i in (1, 2):
        st = tfront.step_body(st, img(frames[i][1]), img(frames[i][2]), cam, cfg, kf_mode="never",
                              pnp_noise=noise[i - 1])
    flags = st.kf_flags.clone()
    flags[0, 1] = True   # stream 0: keyframes 0, 1 and the coming one -> 3; stream 1: 0 and the coming -> 2
    st = st._replace(kf_flags=flags)
    import dataclasses
    cfg3 = dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba, window=3, interval=1))
    on = tfront.step_body(st, img(frames[3][1]), img(frames[3][2]), cam, cfg3, kf_mode="always",
                          pnp_noise=noise[2])
    off = tfront.step_body(st, img(frames[3][1]), img(frames[3][2]), cam, cfg_off, kf_mode="always",
                           pnp_noise=noise[2])
    assert torch.equal(on.poses[1], off.poses[1]) and torch.equal(on.map.points[1], off.map.points[1])
    assert not torch.equal(on.map.points[0], off.map.points[0])
    assert torch.equal(on.pose[0], on.poses[0, 3])
