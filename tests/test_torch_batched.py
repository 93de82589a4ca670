"""The port's BatchedStereoVO against svo_tpu's, and against the port's own
single-stream engine.

Shapes of tests/test_batched.py: 184x320, S=2 streams, one chunk of 4 frames
with a keyframe every 2 (keyframe, track, keyframe, track). svo_tpu's
batched engine is jitted and run ONCE for the whole file (fixture `svo`).

(a) From svo_tpu's batched bootstrap state (state.from_numpy) the port
    steps the same chunk with the PnP noise svo_tpu drew for every step and
    stream: poses of every frame within 1e-4, the metrics row of every
    frame (tracked, inlier ratio, live, keyframe flag, map points) equal,
    and the final feature table slot for slot: masks, ids and ages
    identical, positions within 1e-3 px (the bounds of
    test_torch_pipeline.py, per stream).
(b) The whole run through both BatchedStereoVOs, each drawing its own
    noise from the keys in its state (stream s keyed by PRNGKey(seed + s)
    in both): the final keys bit-equal, trajectories within 10 cm and 1
    degree.
(c) Stream s of a batched run against the port's single-stream frame
    steps from PRNGKey(seed + s) (StereoVO(seed=seed+s)): keys bit-equal,
    poses within 1e-4 (sums over (S, N, ...) may add in another order than
    over (N, ...)), each engine, on the cadenced path and on the dynamic
    per-frame path; a dynamic step in which only one stream keyframes.
(d) The ValueErrors of the shape checks and of chunk % kf_cadence, the
    refiner's defaults and its call before start(), and the device default.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_tpu.config import Config as JConfig
from svo_tpu.geometry import camera as jcam
from svo_tpu.io.synthetic import SyntheticSequence
from svo_tpu.parallel.batched import BatchedStereoVO as JBatched
from svo_tpu_torch.config import Config as TConfig
from svo_tpu_torch.geometry import camera as tcam
from svo_tpu_torch.parallel.batched import BatchedStereoVO as TBatched
from svo_tpu_torch.pipeline import frontend as tfront
from svo_tpu_torch.pipeline import state as tstate
from svo_tpu_torch.pipeline.odometry import StereoVO as TStereoVO

torch.set_num_threads(2)

S, F = 2, 5            # 1 bootstrap frame + one chunk of 4
SHAPE = (184, 320)
CHUNK, CADENCE = 4, 2
KW = dict(use_orb=False, image_height=SHAPE[0], image_width=SHAPE[1])


def _u8(x):
    return np.clip(x, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def data():
    seqs = [SyntheticSequence(n_frames=F, shape=SHAPE, fx=200.0, speed=0.2 + 0.02 * s, seed=s)
            for s in range(S)]
    frames = [list(q) for q in seqs]
    l0 = np.stack([fr[0][1] for fr in frames])
    r0 = np.stack([fr[0][2] for fr in frames])
    lefts = np.stack([np.stack([_u8(fr[t][1]) for fr in frames]) for t in range(1, F)])
    rights = np.stack([np.stack([_u8(fr[t][2]) for fr in frames]) for t in range(1, F)])
    return dict(frames=frames, l0=l0, r0=r0, lefts=lefts, rights=rights,
                baseline=seqs[0].baseline)


def _tcam(data):
    return tcam.from_intrinsics(200.0, 200.0, 160.0, 92.0, data["baseline"])


@pytest.fixture(scope="module")
def svo(data):
    """svo_tpu's batched run: bootstrap state, the state after the chunk,
    and the PnP noise of every step and stream (frontend.py:317)."""
    cfg = JConfig(**KW)
    cam = jcam.from_intrinsics(200.0, 200.0, 160.0, 92.0, data["baseline"])
    bvo = JBatched(cfg, cam, S, chunk=CHUNK, kf_cadence=CADENCE)
    bvo.start(data["l0"], data["r0"])
    boot = jax.tree.map(np.array, bvo.state)  # copied: the step donates its state
    shape = (cfg.ransac.num_hypotheses, cfg.capacity.max_features)
    noise = np.zeros((CHUNK, S) + shape, np.float32)
    for s in range(S):
        rng = jnp.asarray(boot.rng[s])
        for i in range(CHUNK):
            rng, sub = jax.random.split(rng)
            noise[i, s] = np.asarray(jax.random.gumbel(sub, shape))
    bvo.process_chunk(data["lefts"], data["rights"])
    final = jax.tree.map(np.array, bvo.state)
    return dict(boot=boot, final=final, noise=noise, traj=bvo.trajectories(F))


def _angle_deg(a, b):
    c = (np.trace(a[:3, :3].T @ b[:3, :3]) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


def test_from_numpy_carries_the_batched_state(svo):
    boot = svo["boot"]
    st = tstate.from_numpy(boot, "cpu")
    assert tuple(st.pose.shape) == (S, 4, 4) and tuple(st.frame_id.shape) == (S,)
    assert tuple(st.features.pos.shape)[:1] == (S,) and st.prev_pyramid[0][0].dim() == 3
    back = tstate.to_numpy(st)
    assert len(jax.tree.leaves(back)) == len(jax.tree.leaves(boot))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(boot)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # stack / unstack between S single states and one batched state
    singles = tstate.unstack(st)
    assert len(singles) == S and tuple(singles[1].pose.shape) == (4, 4)
    again = tstate.stack(singles)
    for a, b in zip(jax.tree.leaves(tstate.to_numpy(again)), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_chunk_from_svo_tpu_state_with_its_noise(svo, data):
    """One keyframe step, one track step, and again, from svo_tpu's state."""
    cfg, cam = TConfig(**KW), _tcam(data)
    st = tstate.from_numpy(svo["boot"], "cpu")
    lefts, rights = torch.from_numpy(data["lefts"]), torch.from_numpy(data["rights"])
    for i in range(CHUNK):
        st = tfront.step_body(
            st, lefts[i].to(torch.float32), rights[i].to(torch.float32), cam, cfg,
            kf_mode="always" if i % CADENCE == 0 else "never",
            pnp_noise=torch.from_numpy(svo["noise"][i]),
        )
    out_t, out_j = tstate.to_numpy(st), svo["final"]
    np.testing.assert_allclose(out_t.poses[:, :F], out_j.poses[:, :F], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out_t.pose, out_j.pose, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out_t.metrics[:, :F], out_j.metrics[:, :F], rtol=1e-5)
    fj, ft = out_j.features, out_t.features
    assert (fj.valid.sum(-1) > 40).all()
    np.testing.assert_array_equal(ft.valid, fj.valid)
    v = fj.valid
    np.testing.assert_allclose(ft.pos[v], fj.pos[v], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(ft.point_id[v], fj.point_id[v])
    np.testing.assert_array_equal(ft.age[v], fj.age[v])
    np.testing.assert_array_equal(out_t.map.n_points, out_j.map.n_points)
    np.testing.assert_array_equal(out_t.map.obs_cursor, out_j.map.obs_cursor)
    for s in range(S):
        n = int(out_j.map.n_points[s])
        np.testing.assert_allclose(out_t.map.points[s, :n], out_j.map.points[s, :n],
                                   rtol=1e-4, atol=1e-4)
    for f in ("frame_id", "prev_is_kf", "last_kf_id", "prior_ok", "kf_flags"):
        np.testing.assert_array_equal(getattr(out_t, f), getattr(out_j, f))
    np.testing.assert_array_equal(out_t.kf_flags[:, :F], [[True, True, False, True, False]] * S)


@pytest.fixture(scope="module")
def port_runs(data):
    """The port's batched cadenced run, once per engine."""
    cfg, cam = TConfig(**KW), _tcam(data)
    out = {}
    for engine in ("patches", "fused"):
        bvo = TBatched(cfg, cam, S, chunk=CHUNK, kf_cadence=CADENCE, device="cpu",
                       lk_engine=engine)
        bvo.start(data["l0"], data["r0"])
        bvo.process_chunk(data["lefts"], data["rights"])
        out[engine] = bvo.trajectories(F)
        out[engine + "_rng"] = bvo.state.rng
    return out


def test_batched_run_matches_svo_tpu(svo, port_runs):
    """The same keys, so the same noise; the bound is still that of two
    engines on one run."""
    np.testing.assert_array_equal(port_runs["patches_rng"].numpy().view(np.uint32),
                                  svo["final"].rng)
    got, want = port_runs["patches"], svo["traj"]
    assert got.shape == want.shape == (S, F, 4, 4) and np.isfinite(got).all()
    dt = np.linalg.norm(got[:, :, :3, 3] - want[:, :, :3, 3], axis=-1)
    assert dt.max() < 0.1, f"trajectories diverge: {dt}"
    assert max(_angle_deg(a, b) for s in range(S) for a, b in zip(got[s], want[s])) < 1.0
    # the streams are different sequences
    assert not np.allclose(got[0][:, :3, 3], got[1][:, :3, 3], atol=1e-3)


def _single_stream_drive(data, s, seed, kf_modes, engine="patches"):
    """Stream s alone through the frame steps, keyed PRNGKey(seed + s) as
    a BatchedStereoVO started with `seed` keys its stream s."""
    cfg, cam = TConfig(**KW), _tcam(data)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    st = tfront.make_bootstrap(cam, cfg, engine)(f32(data["l0"][s]), f32(data["r0"][s]), seed + s)
    for t, mode in enumerate(kf_modes, start=1):
        _, left, right = data["frames"][s][t]
        st = tfront.step_body(
            st, f32(_u8(left)), f32(_u8(right)), cam, cfg, kf_mode=mode, lk_engine=engine,
        )
    return st


@pytest.mark.parametrize("engine", ["patches", "fused"])
@pytest.mark.parametrize("s", range(S))
def test_stream_equals_single_stream_run(data, port_runs, engine, s):
    """Stream s of the batched run against stream s alone on the same noise."""
    modes = ["always" if i % CADENCE == 0 else "never" for i in range(CHUNK)]
    st = _single_stream_drive(data, s, 0, modes, engine)
    assert torch.equal(port_runs[engine + "_rng"][s], st.rng)
    np.testing.assert_allclose(port_runs[engine][s], st.poses[:F].numpy(), rtol=0, atol=1e-4)


def test_process_dynamic_rule_equals_single_stream(data):
    cfg, cam = TConfig(**KW), _tcam(data)
    bvo = TBatched(cfg, cam, S, device="cpu")
    assert (bvo.chunk, bvo.kf_cadence) == (12, 6)  # svo_tpu's defaults
    bvo.start(data["l0"], data["r0"], seed=5)
    for t in range(1, F):
        bvo.process(np.stack([_u8(fr[t][1]) for fr in data["frames"]]),
                    np.stack([_u8(fr[t][2]) for fr in data["frames"]]))
    trajs = bvo.trajectories(F)
    for s in range(S):
        st = _single_stream_drive(data, s, 5, ["dynamic"] * (F - 1))
        assert torch.equal(bvo.state.rng[s], st.rng)
        np.testing.assert_allclose(trajs[s], st.poses[:F].numpy(), rtol=0, atol=1e-4)
        np.testing.assert_array_equal(bvo.state.kf_flags[s, :F].numpy(), st.kf_flags[:F].numpy())


def test_dynamic_step_where_one_stream_keyframes(data):
    """Replenishment is computed for all streams and taken per stream."""
    cfg, cam = TConfig(**KW), _tcam(data)
    boot = tfront.make_bootstrap(cam, cfg)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    singles = [boot(f32(data["l0"][s]), f32(data["r0"][s]), s) for s in range(S)]
    # stream 1 is due by the interval rule; stream 0 has just keyframed
    singles[1] = singles[1]._replace(
        prev_is_kf=torch.zeros((), dtype=torch.bool),
        last_kf_id=torch.tensor(-cfg.tracking.kf_max_interval, dtype=torch.int32),
    )
    gen = torch.Generator().manual_seed(0)
    noise = torch.stack([
        -torch.log(-torch.log(torch.rand((cfg.ransac.num_hypotheses, cfg.capacity.max_features),
                                         generator=gen).clamp_min(1e-30)))
        for _ in range(S)
    ])
    l1 = np.stack([fr[1][1] for fr in data["frames"]])
    r1 = np.stack([fr[1][2] for fr in data["frames"]])
    out = tfront.step_body(tstate.stack(singles), f32(l1), f32(r1), cam, cfg, pnp_noise=noise)
    assert out.prev_is_kf.tolist() == [False, True]
    for s, got in enumerate(tstate.unstack(out)):
        want = tfront.step_body(singles[s], f32(l1[s]), f32(r1[s]), cam, cfg, pnp_noise=noise[s])
        for a, b in zip(jax.tree.leaves(tstate.to_numpy(got)), jax.tree.leaves(tstate.to_numpy(want))):
            if a.dtype == np.float32:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)
            else:
                np.testing.assert_array_equal(a, b)
    # only stream 1 took new detections: its map grew, stream 0's did not
    grew = out.map.n_points - torch.stack([x.map.n_points for x in singles])
    assert int(grew[0]) == 0 and int(grew[1]) > 0


def test_shape_and_cadence_errors(data):
    cfg, cam = TConfig(**KW), _tcam(data)
    with pytest.raises(ValueError, match="multiple of kf_cadence"):
        TBatched(cfg, cam, S, chunk=5, kf_cadence=2, device="cpu")
    with pytest.raises(ValueError, match="lk_engine"):
        TBatched(cfg, cam, S, device="cpu", lk_engine="xla")
    bvo = TBatched(cfg, cam, S, chunk=CHUNK, kf_cadence=CADENCE, device="cpu")
    with pytest.raises(RuntimeError, match="start"):
        bvo.process(data["l0"], data["r0"])
    with pytest.raises(ValueError, match="expected shape"):
        bvo.start(np.zeros((S, 100, 100)), np.zeros((S, 100, 100)))
    bvo.start(data["l0"], data["r0"])
    with pytest.raises(ValueError, match="frame-major"):  # stream-major instead
        bvo.process_chunk(np.zeros((S, CHUNK) + SHAPE, np.uint8), np.zeros((S, CHUNK) + SHAPE, np.uint8))
    with pytest.raises(ValueError, match="expected shape"):
        bvo.process(data["l0"][:1], data["r0"][:1])
    step = tfront.make_cadenced_chunk_step(cam, cfg, CHUNK, CADENCE)
    with pytest.raises(ValueError, match="streams"):  # a single stream's chunk
        step(bvo.state, torch.zeros((CHUNK,) + SHAPE, dtype=torch.uint8),
             torch.zeros((CHUNK,) + SHAPE, dtype=torch.uint8))


def test_back_end_and_the_sharded_refiner(data):
    """The back-end is ported (test_torch_global_opt.py holds refine()
    against svo_tpu's): make_refiner builds with svo_tpu's defaults, and
    refine() before start() raises like the other entry points. The
    process-group refiner runs: on a gloo world of one it returns what
    refine_global returns on a drifted span, bit for bit
    (test_torch_global_opt.py runs it over two ranks)."""
    from svo_tpu_torch.ba import synthetic
    from svo_tpu_torch.parallel import global_opt
    from torch_dist import world_of_one

    bvo = TBatched(TConfig(**KW), _tcam(data), S, device="cpu")
    assert callable(bvo.make_refiner())
    with pytest.raises(RuntimeError, match="start"):
        bvo.refine()
    mp, poses, _ = synthetic.drifted_state(0)
    args = (mp, poses, torch.tensor(21, dtype=torch.int32), torch.tensor(synthetic.K_MAT),
            synthetic.FX * synthetic.BASELINE)
    kw = dict(n_blocks=4, ba_iterations=6, pg_iterations=6)
    want = global_opt.refine_global(*args, **kw)
    with world_of_one():
        got = global_opt.refine_global_sharded(*args, **kw)
    assert float(want.cost_per_obs) > 10.0  # the aggressive regime: block BA and consensus
    assert torch.equal(got.map.points, want.map.points)
    for f in global_opt.RefineResult._fields[1:]:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("engine_cls", [TStereoVO, TBatched], ids=["StereoVO", "BatchedStereoVO"])
def test_default_device_is_the_card(data, engine_cls):
    """No device argument means the card; without one the constructor
    raises instead of carrying on on the CPU."""
    import inspect

    assert inspect.signature(engine_cls.__init__).parameters["device"].default == "cuda"
    args = (TConfig(**KW), _tcam(data)) + ((S,) if engine_cls is TBatched else ())
    if torch.cuda.is_available():
        assert engine_cls(*args).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match=r'device="cpu"'):
            engine_cls(*args)
    assert engine_cls(*args, device="cpu").device.type == "cpu"
