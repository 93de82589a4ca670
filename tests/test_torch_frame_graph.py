"""The compiled frame step (svo_tpu_torch/pipeline/graph.py::FrameGraph)
and the window BA's chunk schedules, on the CPU.

svo_tpu jits its per-frame step with the state donated and takes the
keyframe rule's and the window BA's branches inside it (lax.cond). The
port reads one branch key a frame on the host (frontend.step_key) and, on
the card, replays one whole-frame graph per key over static buffers; on
the CPU the same static-buffer code runs eagerly. These tests hold it, on
test_torch_chunk_graph.py's 96x256 sequences (and test_torch_backend_
pipeline.py's 184x320 one for the BA against svo_tpu):

(a) bit-equal to the eager step (graph=False) in every leaf: make_step over
    frames that keyframe and frames that do not, one stream and S=2 (whose
    streams disagree on the keyframe), each KLT engine; make_chunked_step,
    sharing one step's buffers; BatchedStereoVO.process with S=2;
(b) cfg.ba.enabled with test_torch_backend_pipeline.py's BA parameters and
    with window 3, interval 2 (a chunk of 6 at cadence 2 then meets two
    schedules): frame by frame and cadenced, bit-equal to the eager loop;
(c) the key against the two host reads it replaces (is_kf.any(),
    run_ba.any(), recomputed here in numpy), past a wrapped trajectory ring
    (capacity.max_frames 8);
(d) against svo_tpu's jitted make_chunked_step (the dynamic rule) and its
    jitted step with the window BA, each drawing svo_tpu's noise from the
    key in its state: test_dynamic_chunked_step_matches_svo_tpu's and
    test_pipeline_with_ba_matches_svo_tpu's bounds;
(e) the donated contract; graph=True refused on the CPU;
(f) exactly one host read a frame (the patched read helper, every other
    read of a tensor's value refused), one a chunk with the BA's schedule,
    none for a cadenced chunk without the BA.
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
from svo_tpu.pipeline import frontend as jfront
from svo_tpu_torch.config import BaParams as TBaParams
from svo_tpu_torch.config import Capacity
from svo_tpu_torch.config import Config as TConfig
from svo_tpu_torch.geometry import camera as tcam
from svo_tpu_torch.parallel.batched import BatchedStereoVO
from svo_tpu_torch.pipeline import frontend as tfront
from svo_tpu_torch.pipeline.graph import ChunkGraph, FrameGraph
from svo_tpu_torch.pipeline.odometry import StereoVO
from svo_tpu_torch.pipeline.state import clone, leaves, stack, to_numpy
from test_torch_backend_pipeline import BA, BA_SHAPE
from test_torch_chunk_graph import H, W, _cam, _cfg, _equal, data  # noqa: F401 (fixture)

torch.set_num_threads(2)

N = 12  # frame steps after the bootstrap
BA_WIDE = dict(BA, window=3, interval=2)


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32))


def _boot(data, S: int, engine: str, cfg=None):
    """The bootstrap state (one stream, or S stacked). For S=2, stream 1 is
    made due at frame 1 by the interval rule while stream 0 has just
    keyframed, so the streams disagree on the keyframe."""
    cfg = cfg or _cfg()
    boot = tfront.make_bootstrap(_cam(data["seq"]), cfg, engine)
    if S == 0:
        _, l0, r0 = data["frames"][0][0]
        return boot(_f32(l0), _f32(r0), 0)
    state = stack([boot(_f32(data["frames"][s][0][1]), _f32(data["frames"][s][0][2]), s)
                   for s in range(S)])
    return state._replace(
        prev_is_kf=torch.tensor([True, False]),
        last_kf_id=torch.tensor([0, -cfg.tracking.kf_max_interval], dtype=torch.int32))


def _frame(data, S: int, t: int, k: int) -> torch.Tensor:
    """Frame t's left (k=1) or right (k=2) image as uint8, ([S,] H, W)."""
    if S == 0:
        return torch.from_numpy(data["u8"][0][k - 1][t - 1])
    return torch.from_numpy(np.stack([data["u8"][s][k - 1][t - 1] for s in range(S)]))


def _drive(step, state, data, S, n=N):
    for t in range(1, n + 1):
        state = step(state, _frame(data, S, t, 1), _frame(data, S, t, 2))
    return state


# ----------------------------------------------------------------------- (a)

@pytest.mark.parametrize("engine", ["patches", "fused"])
@pytest.mark.parametrize("S", [0, 2], ids=["one_stream", "S2"])
def test_frame_step_bit_equal_to_eager(data, S, engine):
    cam, cfg = _cam(data["seq"]), _cfg()
    eager = tfront.make_step(cam, cfg, engine, graph=False)
    static = tfront.make_step(cam, cfg, engine)
    assert isinstance(static, FrameGraph) and not static.capture
    state = _boot(data, S, engine)
    a = _drive(eager, state, data, S, n=8)
    b = _drive(static, state, data, S, n=8)
    assert _equal(a, b)
    kf = b.kf_flags.reshape(-1, b.kf_flags.shape[-1])[:, 1:9]
    assert bool(kf.any()) and not bool(kf.all())  # keyframe and tracking steps both ran
    if S:
        assert b.kf_flags[:, 1].tolist() == [False, True]  # the streams disagreed


def test_chunked_step_shares_the_frame_step(data):
    cam, cfg = _cam(data["seq"]), _cfg()
    step = tfront.make_step(cam, cfg, "patches")
    chunked = tfront.make_chunked_step(cam, cfg, 6, "patches", step=step)
    eager = tfront.make_chunked_step(cam, cfg, 6, "patches", graph=False)
    lefts, rights = (torch.from_numpy(x) for x in data["u8"][0])
    a = b = _boot(data, 0, "patches")
    for c in range(2):
        a = eager(a, lefts[6 * c:6 * c + 6], rights[6 * c:6 * c + 6])
        b = chunked(b, lefts[6 * c:6 * c + 6], rights[6 * c:6 * c + 6])
    assert _equal(a, b)
    assert all(x is y for x, y in zip(leaves(b), step._leaves))  # the frame step's buffers
    # and a frame after the chunks goes through the same step
    assert _equal(step(b, _frame(data, 0, 12, 1), _frame(data, 0, 12, 2)),
                  tfront.make_step(cam, cfg, "patches", graph=False)(
                      a, _frame(data, 0, 12, 1), _frame(data, 0, 12, 2)))


def test_batched_process_bit_equal_to_eager(data):
    cam = _cam(data["seq"])
    runs = []
    for graph in (False, None):
        bvo = BatchedStereoVO(_cfg(), cam, 2, chunk=6, kf_cadence=6, device="cpu", graph=graph)
        bvo.state = _boot(data, 2, "patches")
        for t in range(1, 9):
            bvo.process(_frame(data, 2, t, 1).numpy(), _frame(data, 2, t, 2).numpy())
        runs.append(bvo)
    assert isinstance(runs[1]._step, FrameGraph)
    assert _equal(runs[0].state, runs[1].state)
    assert runs[1].state.kf_flags[:, 1].tolist() == [False, True]


# ----------------------------------------------------------------------- (b)

def _ba_cfg(params):
    return _cfg(ba=TBaParams(**params))


@pytest.mark.parametrize("params", [BA, BA_WIDE], ids=["window2_interval1", "window3_interval2"])
def test_ba_frame_step_bit_equal_to_eager(data, params):
    cam, cfg = _cam(data["seq"]), _ba_cfg(params)
    static = tfront.make_step(cam, cfg, "fused")
    state = _boot(data, 0, "fused", cfg)
    # one more keyframe flag, in a slot these 12 frames never write: the
    # counts start at 2, so window 3 and interval 2 meet a solve in 12 frames
    flags = state.kf_flags.clone()
    flags[-1] = True
    state = state._replace(kf_flags=flags)
    a = _drive(tfront.make_step(cam, cfg, "fused", graph=False), state, data, 0)
    b = _drive(static, state, data, 0)
    assert _equal(a, b)
    count = np.cumsum(b.kf_flags.numpy()[:N + 1]) + 1
    due = [f for f in range(1, N + 1) if b.kf_flags[f] and count[f] >= params["window"]
           and count[f] % params["interval"] == 0]
    assert due and not all(b.kf_flags[1:N + 1])  # solves, and steps without one


@pytest.mark.parametrize("params", [BA, BA_WIDE], ids=["window2_interval1", "window3_interval2"])
def test_ba_cadenced_chunk_bit_equal_to_eager(data, params, monkeypatch):
    """Chunks of 6 at cadence 2: three keyframe steps a chunk. With window 3
    and interval 2 the keyframe counts 2, 3, 4 then 5, 6, 7 give the
    schedules (F, F, T) and (F, T, F); with window 2 and interval 1 every
    keyframe step solves."""
    cam, cfg = _cam(data["seq"]), _ba_cfg(params)
    eager = tfront.make_cadenced_chunk_step(cam, cfg, 6, 2, "fused", graph=False)
    static = tfront.make_cadenced_chunk_step(cam, cfg, 6, 2, "fused")
    assert isinstance(static, ChunkGraph)
    keys = []
    read = tfront._read_key
    monkeypatch.setattr(tfront, "_read_key", lambda f: keys.append(read(f)) or keys[-1])
    lefts, rights = (torch.from_numpy(x) for x in data["u8"][0])
    a = b = _boot(data, 0, "fused", cfg)
    for c in range(2):
        a = eager(a, lefts[6 * c:6 * c + 6], rights[6 * c:6 * c + 6])
        b = static(b, lefts[6 * c:6 * c + 6], rights[6 * c:6 * c + 6])
    assert _equal(a, b)
    want = ([(True,) * 3] * 2 if params is BA else [(False, False, True), (False, True, False)])
    assert keys == [k for k in want for _ in range(2)]  # each chunk read once, eager and static
    with pytest.raises(ValueError, match="a chunk is 6 frames"):
        static(b, lefts[:4], rights[:4])


# ----------------------------------------------------------------------- (c)

def _reads_by_hand(state, cfg):
    """The two reads the step made before the key: is_kf.any() and, on a
    keyframe step with the BA on, run_ba.any(), here in numpy."""
    s = to_numpy(state)
    t = cfg.tracking
    fid = s.frame_id + 1
    fresh = ~s.prev_is_kf
    is_kf = fresh & (s.features.valid.sum(-1) < t.features_to_track)
    is_kf |= fresh & (fid - s.last_kf_id >= t.kf_max_interval)
    flags = s.kf_flags.copy()
    if fid < flags.shape[-1]:  # past the ring the write is dropped
        flags[fid] = is_kf
    count = flags.sum()
    run_ba = is_kf & (count >= cfg.ba.window) & (count % cfg.ba.interval == 0)
    return bool(is_kf), bool(run_ba)


def test_key_is_the_reads_it_replaces(data):
    cap = Capacity(max_frames=8)
    cam, cfg = _cam(data["seq"]), _cfg(capacity=cap, ba=TBaParams(**dict(BA, interval=2)))
    eager = tfront.make_step(cam, _cfg(capacity=cap), "patches", graph=False)
    state = _boot(data, 0, "patches", _cfg(capacity=cap))
    keys = {}
    for t in range(1, N + 1):
        keys[t] = tfront.step_key(state, cfg)
        assert keys[t] == _reads_by_hand(state, cfg), t
        state = eager(state, _frame(data, 0, t, 1), _frame(data, 0, t, 2))
        assert bool(state.prev_is_kf) == keys[t][0]
    assert int(state.frame_id) == N > cap.max_frames  # the ring wrapped
    assert {(False, False), (True, True)} <= set(keys.values())
    assert any(keys[t][0] for t in range(cap.max_frames, N + 1))  # a keyframe past the ring


# ----------------------------------------------------------------------- (d)

def test_dynamic_chunked_step_matches_svo_tpu(data):
    """test_torch_cli.py's bounds: keyframe flags identical and decided by
    the rule, live features > 40, trajectories within 10 cm and 1 degree,
    the final keys bit-equal."""
    seq, frames = data["seq"], data["frames"][0]
    args = (seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline)
    cfg_j = JConfig(use_orb=False, image_height=H, image_width=W)
    cam_j = jcam.from_intrinsics(*args)
    st_j = jfront.make_bootstrap(cam_j, cfg_j)(
        jnp.asarray(frames[0][1]), jnp.asarray(frames[0][2]), jnp.uint32(0))
    st_j = jfront.make_chunked_step(cam_j, cfg_j, N)(
        st_j, *(jnp.asarray(x) for x in data["u8"][0]))
    st_j = jax.tree.map(np.asarray, st_j)
    step = tfront.make_chunked_step(_cam(seq), _cfg(), N, "patches")
    st_t = to_numpy(step(_boot(data, 0, "patches"), *(torch.from_numpy(x) for x in data["u8"][0])))
    np.testing.assert_array_equal(st_t.rng, st_j.rng)
    np.testing.assert_array_equal(st_t.kf_flags[:N + 1], st_j.kf_flags[:N + 1])
    assert 1 < st_t.kf_flags[:N + 1].sum() < N + 1
    assert st_t.metrics[1:N + 1, 2].min() > 40
    pj, pt = st_j.poses[:N + 1], st_t.poses[:N + 1]
    assert np.isfinite(pt).all()
    assert np.linalg.norm(pj[:, :3, 3] - pt[:, :3, 3], axis=-1).max() < 0.1
    cos = (np.einsum("nij,nij->n", pj[:, :3, :3], pt[:, :3, :3]) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))).max() < 1.0


def test_ba_frame_step_matches_svo_tpu(monkeypatch):
    """test_pipeline_with_ba_matches_svo_tpu's run (184x320, 14 frames, its
    BA parameters) through svo_tpu's jitted make_step and the port's
    FrameGraph, each drawing svo_tpu's noise from its own key: its bounds
    (keys bit-equal, the same keyframes, solves where the rule says, poses
    within 1e-3 and 1e-4 before the first window, ATE under 5%)."""
    seq = SyntheticSequence(n_frames=14, shape=BA_SHAPE, fx=200.0, speed=0.25)
    frames = list(seq)
    args = (seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline)
    kw = dict(use_orb=False, image_height=BA_SHAPE[0], image_width=BA_SHAPE[1])
    cfg_j, cam_j = JConfig(**kw, ba=JBaParams(**BA)), jcam.from_intrinsics(*args)
    cfg_t, cam_t = TConfig(**kw, ba=TBaParams(**BA)), tcam.from_intrinsics(*args)
    step_j = jfront.make_step(cam_j, cfg_j)
    st_j = jfront.make_bootstrap(cam_j, cfg_j)(
        jnp.asarray(frames[0][1]), jnp.asarray(frames[0][2]), jnp.uint32(0))
    step_t = tfront.make_step(cam_t, cfg_t)
    st_t = tfront.make_bootstrap(cam_t, cfg_t)(_f32(frames[0][1]), _f32(frames[0][2]), 0)
    keys = []
    read = tfront._read_key
    monkeypatch.setattr(tfront, "_read_key", lambda f: keys.append(read(f)) or keys[-1])
    for _, left, right in frames[1:]:
        st_j = step_j(st_j, jnp.asarray(left), jnp.asarray(right))
        st_t = step_t(st_t, _f32(left), _f32(right))
    j, t = jax.tree.map(np.asarray, st_j), to_numpy(st_t)
    n = 14
    np.testing.assert_array_equal(t.rng, j.rng)
    assert np.array_equal(t.kf_flags[:n], j.kf_flags[:n])
    count = np.cumsum(t.kf_flags[:n])
    due = [f for f in range(1, n) if t.kf_flags[f] and count[f] >= BA["window"]
           and count[f] % BA["interval"] == 0]
    assert [f for f, k in enumerate(keys, start=1) if k[1]] == due and len(due) >= 2
    np.testing.assert_allclose(t.poses[:n], j.poses[:n], atol=1e-3, rtol=0)
    np.testing.assert_allclose(t.pose, j.pose, atol=1e-3, rtol=0)
    kfs = np.nonzero(t.kf_flags[:n])[0]
    untouched = kfs[kfs <= due[0]][-BA["window"]]
    np.testing.assert_allclose(t.poses[:untouched + 1], j.poses[:untouched + 1], atol=1e-4, rtol=0)
    travelled = np.linalg.norm(np.diff(seq.gt_poses[:, :3, 3], axis=0), axis=1).sum()
    for poses in (t.poses[:n], j.poses[:n]):
        assert ate_rmse(poses, seq.gt_poses) < 0.05 * travelled


# ----------------------------------------------------------------------- (e)

def test_donated_contract(data):
    cam, cfg = _cam(data["seq"]), _cfg()
    step = tfront.make_step(cam, cfg, "patches")
    state = _boot(data, 0, "patches")
    before = clone(state)
    out = step(state, _frame(data, 0, 1, 1), _frame(data, 0, 1, 2))
    assert _equal(state, before)  # the caller's state is only read
    assert all(x is y for x, y in zip(leaves(out), step._leaves))
    kept = clone(out)
    again = step(out, _frame(data, 0, 2, 1), _frame(data, 0, 2, 2))
    assert again is out and int(out.frame_id) == 2 and int(kept.frame_id) == 1
    eager = tfront.make_step(cam, cfg, "patches", graph=False)
    assert _equal(eager(kept, _frame(data, 0, 2, 1), _frame(data, 0, 2, 2)), out)
    # a state of the caller's own, some leaves the step's buffers and some not
    mine = out._replace(pose=out.pose.clone())
    mine_pose = mine.pose.clone()
    step(mine, _frame(data, 0, 3, 1), _frame(data, 0, 3, 2))
    assert torch.equal(mine.pose, mine_pose)
    with pytest.raises(ValueError, match="streams"):  # a batched frame for one stream
        step(out, _frame(data, 2, 4, 1), _frame(data, 2, 4, 2))


def test_graph_true_needs_the_card(data):
    cam, cfg = _cam(data["seq"]), _cfg()
    with pytest.raises(ValueError, match="CUDA"):
        tfront.make_step(cam, cfg, graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        tfront.make_chunked_step(cam, cfg, 6, graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        StereoVO(cfg, cam, device="cpu", graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        tfront.make_cadenced_chunk_step(cam, _ba_cfg(BA), 6, 2, graph=True)


# ----------------------------------------------------------------------- (f)

def _count_reads(monkeypatch) -> list:
    """Patch the step's read helper to count its calls, and refuse every
    other read of a tensor's value."""
    tolist = torch.Tensor.tolist
    reads = []

    def read(flags):
        reads.append(1)
        return tuple(tolist(flags))

    def no_sync(*_a, **_k):
        raise AssertionError("host read of a tensor value outside the key")

    monkeypatch.setattr(tfront, "_read_key", read)
    for name in ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, no_sync)
    return reads


@pytest.mark.parametrize("ba", [False, True], ids=["ba_off", "ba_on"])
def test_one_host_read_a_frame(data, ba, monkeypatch):
    cam, cfg = _cam(data["seq"]), (_ba_cfg(BA) if ba else _cfg())
    state = _boot(data, 0, "fused", cfg)
    frame_step = tfront.make_step(cam, cfg, "fused")
    chunk_step = tfront.make_cadenced_chunk_step(cam, cfg, 6, 2, "fused")
    lefts, rights = (torch.from_numpy(x[:6]) for x in data["u8"][0])
    reads = _count_reads(monkeypatch)
    _drive(frame_step, state, data, 0, n=6)
    assert len(reads) == 6
    chunk_step(state, lefts, rights)
    assert len(reads) == 6 + ba  # the BA's schedule, once a chunk
