"""The compiled chunk dispatch (svo_tpu_torch/pipeline/graph.py) on the CPU.

svo_tpu's cadenced chunk step is jax.jit(run_chunk, donate_argnums=(0,)).
The port's counterpart captures the chunk as a CUDA graph on the card and
replays it over static buffers; on the CPU the same static-buffer code runs
eagerly, and that is what these tests hold, on the 96x256 sequence of
test_torch_pipeline.py (13 frames: two chunks of 6, a keyframe every 6):

(a) bit-equal to the eager loop (graph=False) over two chunks, every leaf
    of the final state, one stream and S=2, each KLT engine;
(b) against svo_tpu's jitted step on the same frames, at
    test_run_chunked_matches_svo_tpu's bounds, and the PnP key after the
    chunks bit-equal to svo_tpu's (nothing advanced it twice);
(c) the donated contract: the returned state's leaves are the step's static
    buffers; a state kept by clone survives the next call; a caller's state
    that is not the static buffers is only read; two engines hold buffers
    of their own;
(d) the copy of the output into the static buffers reads every aliased
    leaf before it writes any;
(e) graph=True on a CPU device raises, for every step an engine holds, the
    window BA's included (its chunk is keyed by its BA schedule).
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
from svo_tpu_torch.parallel.batched import BatchedStereoVO
from svo_tpu_torch.pipeline import frontend as tfront
from svo_tpu_torch.pipeline.graph import ChunkGraph, _copy_into
from svo_tpu_torch.pipeline.odometry import StereoVO
from svo_tpu_torch.pipeline.state import clone, leaves, stack

torch.set_num_threads(2)

H, W = 96, 256
CHUNK, CADENCE = 6, 6


@pytest.fixture(scope="module")
def data():
    """Frames of two streams (the second on another seed), the first as
    f32 and the rest as (12, H, W) uint8 stacks per stream."""
    seqs = [SyntheticSequence(n_frames=13, shape=(H, W), fx=120.0, speed=0.12, seed=3 + s)
            for s in range(2)]
    frames = [list(q) for q in seqs]
    u8 = [tuple(np.stack([np.clip(f[k], 0, 255).astype(np.uint8) for f in fr[1:]])
                for k in (1, 2)) for fr in frames]
    return dict(seq=seqs[0], frames=frames, u8=u8)


def _cam(seq):
    return tcam.from_intrinsics(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline)


def _cfg(**kw):
    return TConfig(use_orb=False, image_height=H, image_width=W, **kw)


def _start(data, S: int, engine: str, seed: int = 0):
    """The bootstrap state (one stream, or S stacked) and the two chunks of
    uint8 frames ((6, [S,] H, W) each)."""
    boot = tfront.make_bootstrap(_cam(data["seq"]), _cfg(), engine)
    first = [data["frames"][s][0] for s in range(max(S, 1))]
    if S == 0:
        state = boot(torch.from_numpy(first[0][1]), torch.from_numpy(first[0][2]), seed)
        lefts, rights = (torch.from_numpy(x) for x in data["u8"][0])
    else:
        state = stack([boot(torch.from_numpy(f[1]), torch.from_numpy(f[2]), seed + s)
                       for s, f in enumerate(first)])
        lefts, rights = (torch.from_numpy(np.stack([data["u8"][s][k] for s in range(S)], axis=1))
                         for k in (0, 1))
    chunks = [(lefts[c * CHUNK:(c + 1) * CHUNK], rights[c * CHUNK:(c + 1) * CHUNK])
              for c in range(2)]
    return state, chunks


def _step(data, engine, graph):
    return tfront.make_cadenced_chunk_step(_cam(data["seq"]), _cfg(), CHUNK, CADENCE, engine,
                                           graph=graph)


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


@pytest.mark.parametrize("engine", ["patches", "fused"])
@pytest.mark.parametrize("S", [0, 2], ids=["one_stream", "S2"])
def test_static_chunk_bit_equal_to_eager_loop(data, S, engine):
    state, chunks = _start(data, S, engine)
    eager, static = _step(data, engine, False), _step(data, engine, None)
    assert isinstance(static, ChunkGraph) and not static.capture
    a = b = state
    for c in chunks:
        a = eager(a, *c)
        b = static(b, *c)
    assert int(b.frame_id.reshape(-1)[0]) == 2 * CHUNK
    assert _equal(a, b)


@pytest.fixture(scope="module")
def both_packages(data):
    """Two chunks through svo_tpu's jitted step and the port's static one,
    each from its own bootstrap of frame 0 with PnP seed 0."""
    seq = data["seq"]
    args = (seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline)
    cam_j = jcam.from_intrinsics(*args)
    cfg_j = JConfig(use_orb=False, image_height=H, image_width=W)
    _, l0, r0 = data["frames"][0][0]
    st_j = jfront.make_bootstrap(cam_j, cfg_j)(jnp.asarray(l0), jnp.asarray(r0), jnp.uint32(0))
    step_j = jfront.make_cadenced_chunk_step(cam_j, cfg_j, CHUNK, CADENCE)
    state, chunks = _start(data, 0, "patches")
    step_t = _step(data, "patches", None)
    for lefts, rights in chunks:
        st_j = step_j(st_j, jnp.asarray(lefts.numpy()), jnp.asarray(rights.numpy()))
        state = step_t(state, lefts, rights)
    return jax.tree.map(np.asarray, st_j), state


def test_static_chunk_matches_svo_tpu(data, both_packages):
    """test_run_chunked_matches_svo_tpu's bounds: live features >= 40 every
    frame, the port's mean survival >= 70% of svo_tpu's, trajectories
    within 10 cm and 1 degree, keyframe flags equal."""
    st_j, st_t = both_packages
    n = 1 + 2 * CHUNK
    live_j, live_t = st_j.metrics[1:n, 2], st_t.metrics[1:n, 2].numpy()
    assert live_j.min() > 40 and live_t.min() > 40
    assert live_t.mean() > 0.7 * live_j.mean(), (live_t.mean(), live_j.mean())
    pj, pt = st_j.poses[:n], st_t.poses[:n].numpy()
    assert np.isfinite(pt).all()
    assert np.linalg.norm(pj[:, :3, 3] - pt[:, :3, 3], axis=-1).max() < 0.1
    cos = (np.einsum("nij,nij->n", pj[:, :3, :3], pt[:, :3, :3]) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))).max() < 1.0
    np.testing.assert_array_equal(st_t.kf_flags[:n].numpy(), st_j.kf_flags[:n])


def test_key_after_chunks_is_svo_tpus(both_packages):
    """The first call's run is the chunk itself, on copies of the caller's
    state: the key is split once a frame, as svo_tpu's, and never more."""
    st_j, st_t = both_packages
    np.testing.assert_array_equal(st_t.rng.numpy().view(np.uint32), st_j.rng)


def test_returned_state_is_the_static_buffers(data):
    state, chunks = _start(data, 0, "patches")
    step = _step(data, "patches", None)
    out = step(state, *chunks[0])
    assert all(x is y for x, y in zip(leaves(out), step._leaves))
    assert not any(x is y for x, y in zip(leaves(out), leaves(state)))
    again = step(out, *chunks[1])
    assert again is out  # donated: the same buffers, advanced in place
    assert int(out.frame_id) == 2 * CHUNK


def test_kept_clone_survives_next_call(data):
    state, chunks = _start(data, 0, "patches")
    step = _step(data, "patches", None)
    out = step(state, *chunks[0])
    kept = clone(out)
    assert _equal(kept, out)
    step(out, *chunks[1])
    assert int(kept.frame_id) == CHUNK and int(out.frame_id) == 2 * CHUNK
    assert not torch.equal(kept.rng, out.rng)
    # the kept state still steps as it would have: the same chunk from it
    # through the eager loop equals the call that advanced the buffers
    assert _equal(_step(data, "patches", False)(kept, *chunks[1]), out)


def test_caller_state_is_only_read(data):
    state, chunks = _start(data, 0, "patches")
    before = clone(state)
    step = _step(data, "patches", None)
    out = step(state, *chunks[0])
    assert _equal(state, before)
    # a state of the caller's own, with some leaves the step's buffers and
    # some not (as after a refinement sweep), is read and not written
    mine = out._replace(poses=out.poses.clone(), pose=out.pose.clone())
    mine_before = clone(mine)
    step(mine, *chunks[1])
    assert torch.equal(mine.poses, mine_before.poses) and torch.equal(mine.pose, mine_before.pose)


def test_engines_do_not_share_buffers(data):
    _, l0, r0 = data["frames"][0][0]
    engines = [StereoVO(_cfg(), _cam(data["seq"]), chunk=CHUNK, kf_cadence=CADENCE,
                        device="cpu") for _ in range(2)]
    lefts, rights = (torch.from_numpy(x[:CHUNK]) for x in data["u8"][0])
    ptrs = []
    for vo in engines:
        vo.start(l0, r0)
        vo.state = vo._chunk_step(vo.state, lefts, rights)
        ptrs.append({x.untyped_storage().data_ptr() for x in leaves(vo.state)})
    assert not ptrs[0] & ptrs[1]
    assert _equal(engines[0].state, engines[1].state)


def test_donation_copy_stages_aliased_outputs():
    """The copy of a chunk's output leaves into the static leaves: an
    output leaf that is another static leaf (or a view of one) is read
    before any copy writes it, so swapped leaves swap; a leaf that already
    is its buffer is not touched; a shape that does not match raises."""
    a, b, c = torch.arange(4.0), torch.arange(4.0) + 10, torch.zeros(2, 2)
    _copy_into([a, b, c], [b[:], a, c])
    assert torch.equal(a, torch.arange(4.0) + 10) and torch.equal(b, torch.arange(4.0))
    assert torch.equal(c, torch.zeros(2, 2))
    with pytest.raises(ValueError, match="does not match"):
        _copy_into([a], [torch.zeros(3)])


def test_graph_true_needs_the_card(data):
    cam, cfg = _cam(data["seq"]), _cfg()
    with pytest.raises(ValueError, match="CUDA"):
        tfront.make_cadenced_chunk_step(cam, cfg, CHUNK, CADENCE, graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        StereoVO(cfg, cam, chunk=CHUNK, kf_cadence=CADENCE, device="cpu", graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        BatchedStereoVO(cfg, cam, 2, chunk=CHUNK, kf_cadence=CADENCE, device="cpu", graph=True)
    with pytest.raises(ValueError, match="CUDA"):  # the dynamic rule's frame step
        StereoVO(cfg, cam, chunk=CHUNK, device="cpu", graph=True)
    # the window BA's chunk is captured too, one graph per BA schedule
    ba = _cfg(ba=dataclasses.replace(TConfig().ba, enabled=True))
    with pytest.raises(ValueError, match="CUDA"):
        tfront.make_cadenced_chunk_step(cam, ba, CHUNK, CADENCE, graph=True)
    assert isinstance(tfront.make_cadenced_chunk_step(cam, ba, CHUNK, CADENCE), ChunkGraph)
