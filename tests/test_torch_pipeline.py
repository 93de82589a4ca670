"""The port's pipeline against svo_tpu's.

(a) One frame step from svo_tpu's bootstrap state, converted with
    state.from_numpy, with svo_tpu's PnP noise injected: both steps see the
    same state, images and hypotheses, so pose, map and feature table must
    agree slot for slot (pose to 1e-4, positions to 1e-3 px as in
    test_torch_klt.py, masks and ids exactly).
(b) The 96x256 synthetic run of tests/test_lk_fused_pipeline.py through
    run_chunked (chunk 12, cadence 6, 13 frames) in both packages, held to
    that file's bounds: live features >= 40 every frame, the port's mean
    survival >= 70% of svo_tpu's, trajectories within 10 cm and 1 degree,
    the final PnP keys bit-equal (each package draws from its own state's
    key, svo_tpu's chain in both).
Plus the tie and drop semantics of the state updates, the state
converters, and the no-host-sync rule of the cadenced step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_tpu.config import Capacity as JCapacity
from svo_tpu.config import Config as JConfig
from svo_tpu.geometry import camera as jcam
from svo_tpu.io.synthetic import SyntheticSequence
from svo_tpu.pipeline import frontend as jfront
from svo_tpu.pipeline.odometry import StereoVO as JStereoVO
from svo_tpu.pipeline.state import FeatureSet as JFeatureSet
from svo_tpu.pipeline.state import MapState as JMapState
from svo_tpu_torch.config import Capacity as TCapacity
from svo_tpu_torch.config import Config as TConfig
from svo_tpu_torch.geometry import camera as tcam
from svo_tpu_torch.pipeline import frontend as tfront
from svo_tpu_torch.pipeline import state as tstate
from svo_tpu_torch.pipeline.odometry import StereoVO as TStereoVO

torch.set_num_threads(2)

H, W = 96, 256


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(n_frames=13, shape=(H, W), fx=120.0, speed=0.12, seed=3)


def _cams(seq):
    args = (seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline)
    return jcam.from_intrinsics(*args), tcam.from_intrinsics(*args)


def _cfgs():
    kw = dict(use_orb=False, image_height=H, image_width=W)
    return JConfig(**kw), TConfig(**kw)


@pytest.fixture(scope="module")
def jax_bootstrap(seq):
    cam_j, _ = _cams(seq)
    cfg_j, _ = _cfgs()
    _, l0, r0 = next(iter(seq))
    return jfront.make_bootstrap(cam_j, cfg_j)(jnp.asarray(l0), jnp.asarray(r0), jnp.uint32(0))


def _angle_deg(a, b):
    c = (np.trace(a[:3, :3].T @ b[:3, :3]) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


@pytest.mark.parametrize("kf_mode", ["always", "never"])
def test_one_step_from_svo_tpu_state(seq, jax_bootstrap, kf_mode):
    cam_j, cam_t = _cams(seq)
    cfg_j, cfg_t = _cfgs()
    l1, r1 = seq.frame(1)
    st_j = jax_bootstrap
    tree = jax.tree.map(np.asarray, st_j)

    # the converters round-trip every leaf exactly
    st_t = tstate.from_numpy(tree, "cpu")
    back = tstate.to_numpy(st_t)
    assert len(jax.tree.leaves(back)) == len(jax.tree.leaves(tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

    # svo_tpu's hypothesis noise for this step (frontend.py:317, pnp.py:168)
    _, sub = jax.random.split(st_j.rng)
    noise = np.array(jax.random.gumbel(sub, (cfg_j.ransac.num_hypotheses, cfg_j.capacity.max_features)))

    step_j = jax.jit(lambda s, l, r: jfront.step_body(s, l, r, cam_j, cfg_j, kf_mode=kf_mode))
    out_j = jax.tree.map(np.asarray, step_j(st_j, jnp.asarray(l1), jnp.asarray(r1)))
    out_t = tstate.to_numpy(tfront.step_body(
        st_t, torch.from_numpy(l1), torch.from_numpy(r1), cam_t, cfg_t,
        kf_mode=kf_mode, pnp_noise=torch.from_numpy(noise),
    ))

    np.testing.assert_allclose(out_t.pose, out_j.pose, rtol=1e-4, atol=1e-4)
    fj, ft = out_j.features, out_t.features
    assert fj.valid.sum() > 40
    np.testing.assert_array_equal(ft.valid, fj.valid)
    v = fj.valid
    np.testing.assert_allclose(ft.pos[v], fj.pos[v], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(ft.point_id[v], fj.point_id[v])
    np.testing.assert_array_equal(ft.age[v], fj.age[v])
    assert int(out_t.map.n_points) == int(out_j.map.n_points)
    assert int(out_t.map.obs_cursor) == int(out_j.map.obs_cursor)
    n = int(out_j.map.n_points)
    np.testing.assert_allclose(out_t.map.points[:n], out_j.map.points[:n], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out_t.metrics[1], out_j.metrics[1], rtol=1e-5)
    for f in ("frame_id", "prev_is_kf", "last_kf_id", "prior_ok", "kf_flags", "rng"):
        np.testing.assert_array_equal(getattr(out_t, f), getattr(out_j, f))


def test_run_chunked_matches_svo_tpu(seq):
    """bench.py's path (cadenced chunk 12/6) in both packages."""
    frames = list(seq)
    cam_j, cam_t = _cams(seq)
    cfg_j, cfg_t = _cfgs()
    jvo = JStereoVO(cfg_j, cam_j, chunk=12, kf_cadence=6)
    rj = jvo.run_chunked(frames)
    tvo = TStereoVO(cfg_t, cam_t, chunk=12, kf_cadence=6, device="cpu")
    rt = tvo.run_chunked(frames)
    np.testing.assert_array_equal(tstate.to_numpy(tvo.state).rng, np.asarray(jvo.state.rng))
    live_j, live_t = rj.metrics[1:, 2], rt.metrics[1:, 2]
    assert live_j.min() > 40 and live_t.min() > 40
    assert live_t.mean() > 0.7 * live_j.mean(), (live_t.mean(), live_j.mean())
    assert np.isfinite(rt.poses).all() and rt.poses.shape == rj.poses.shape
    dt = np.linalg.norm(rj.poses[:, :3, 3] - rt.poses[:, :3, 3], axis=-1)
    assert dt.max() < 0.1, f"trajectories diverge: {dt}"
    for a, b in zip(rj.poses, rt.poses):
        assert _angle_deg(a, b) < 1.0
    np.testing.assert_array_equal(rt.kf_flags, rj.kf_flags)


def test_merge_features_tied_keys():
    """Every tracked key is 2e9 + age in f32 (one value for small ages) and
    every dead key is -1: the slot order comes from the tie rule alone."""
    rng = np.random.default_rng(0)
    N, D = 16, 24
    feats = dict(
        pos=rng.uniform(0, 100, (N, 2)).astype(np.float32),
        valid=rng.random(N) > 0.4,
        point_id=rng.integers(0, 50, N).astype(np.int32),
        age=rng.integers(0, 40, N).astype(np.int32),
        anchor=rng.uniform(0, 100, (N, 2)).astype(np.float32),
    )
    new = (
        rng.uniform(0, 100, (D, 2)).astype(np.float32),
        rng.integers(0, 50, D).astype(np.int32),
        rng.choice([1.0, 2.0], D).astype(np.float32),  # tied detection keys
        rng.random(D) > 0.3,
    )
    out_j = jfront._merge_features(
        JFeatureSet(**{k: jnp.asarray(v) for k, v in feats.items()}), *map(jnp.asarray, new)
    )
    out_t = tfront._merge_features(
        tstate.FeatureSet(**{k: torch.from_numpy(v) for k, v in feats.items()}),
        *map(torch.from_numpy, new),
    )
    for a, b in zip(out_j, out_t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_alloc_and_record_drop_semantics():
    """Rows past the map's capacity and the dead rows are dropped, and the
    observation ring wraps, exactly as jax's .at[].set(mode="drop")."""
    cj = dataclasses.replace(JConfig(), capacity=JCapacity(max_points=10),
                             ba=dataclasses.replace(JConfig().ba, ring_obs=7))
    ct = dataclasses.replace(TConfig(), capacity=TCapacity(max_points=10),
                             ba=dataclasses.replace(TConfig().ba, ring_obs=7))
    rng = np.random.default_rng(1)
    mj, mt = JMapState.empty(cj), tstate.MapState.empty(ct)
    for step in range(3):
        X = rng.normal(0, 1, (6, 3)).astype(np.float32)
        valid = rng.random(6) > 0.2
        uv = rng.uniform(0, 50, (6, 2)).astype(np.float32)
        ids_j, mj = jfront._alloc_points(mj, jnp.asarray(X), jnp.asarray(valid))
        ids_t, mt = tfront._alloc_points(mt, torch.from_numpy(X), torch.from_numpy(valid))
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
        ok = valid & (np.asarray(ids_j) >= 0)
        mj = jfront._record_obs(mj, jnp.asarray(uv), ids_j, jnp.asarray(ok), jnp.int32(step))
        mt = tfront._record_obs(
            mt, torch.from_numpy(uv), ids_t, torch.from_numpy(ok),
            torch.tensor(step, dtype=torch.int32),
        )
        for a, b in zip(mj, mt):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("lk_engine, use_orb", [("patches", False), ("fused", False),
                                                ("fused", True)],
                         ids=["patches", "fused", "orb-fused"])
def test_cadenced_step_makes_no_host_sync(seq, monkeypatch, lk_engine, use_orb):
    """The cadenced chunk step reads no tensor value on the host (svo_tpu
    branches on none either): any bool()/int()/float()/.item() on a tensor
    inside it fails the test. Both KLT engines, so the fused level's
    wrapper is held to it too, and Config()'s ORB detector at cadence 6:
    what lets the card capture the chunk, the shipping configuration's
    included, as one CUDA graph (pipeline/graph.py)."""
    frames = list(seq)[:7]
    _, cam_t = _cams(seq)
    _, cfg_t = _cfgs()
    cfg_t = dataclasses.replace(cfg_t, use_orb=use_orb)
    vo = TStereoVO(cfg_t, cam_t, chunk=6, kf_cadence=6, device="cpu", lk_engine=lk_engine)
    vo.start(frames[0][1], frames[0][2])
    lefts = torch.from_numpy(np.stack([f[1] for f in frames[1:]]).astype(np.uint8))
    rights = torch.from_numpy(np.stack([f[2] for f in frames[1:]]).astype(np.uint8))

    def no_sync(*_a, **_k):
        raise AssertionError("host read of a tensor value in the cadenced step")

    for name in ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, no_sync)
    vo.state = vo._chunk_step(vo.state, lefts, rights)
    monkeypatch.undo()
    assert int(vo.state.frame_id) == 6


def test_ba_and_orb_not_ported(seq):
    """Both are ported now: an engine with ba.enabled and Config()'s ORB
    detector (its default, use_orb=True) starts and steps a frame on the
    test sequence."""
    _, cam_t = _cams(seq)
    cfg = dataclasses.replace(
        TConfig(ba=dataclasses.replace(TConfig().ba, enabled=True)), image_height=H, image_width=W
    )
    assert cfg.use_orb
    vo = TStereoVO(cfg, cam_t, device="cpu")
    (l0, r0), (l1, r1) = seq.frame(0), seq.frame(1)
    vo.start(l0, r0)
    n0 = int(vo.state.features.count())
    vo.process(l1, r1)
    assert n0 > 40 and int(vo.state.frame_id) == 1
    assert bool(torch.isfinite(vo.state.pose).all())
    assert float(vo.state.metrics[1, 1]) > 0.8
