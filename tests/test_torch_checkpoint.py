"""Checkpoint / resume (svo_tpu_torch/utils/checkpoint.py).

A batched engine (S=2, 96x256, chunks of 6 frames, refine() in the loop)
is saved after two chunks and a sweep and loaded into a FRESH engine; both
then run a chunk, a sweep and another chunk: every leaf of the two states
must be bit-equal, which needs the generator's state in the checkpoint
(a resume without it draws other PnP noise) and a deterministic refine().
A single-stream engine round-trips too. A checkpoint of another Config
raises svo_tpu's message, word for word.
"""

import jax  # noqa: F401  (before torch)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_tpu.utils import checkpoint as jcheckpoint
from svo_tpu_torch.config import Capacity, Config
from svo_tpu_torch.geometry import camera as tcam
from svo_tpu_torch.io.synthetic import SyntheticSequence
from svo_tpu_torch.parallel.batched import BatchedStereoVO
from svo_tpu_torch.pipeline import state as tstate
from svo_tpu_torch.pipeline.odometry import StereoVO
from svo_tpu_torch.utils.checkpoint import load_state, save_state

torch.set_num_threads(2)

S, CHUNK = 2, 6
KW = dict(use_orb=False, image_height=96, image_width=256)
REFINER = dict(n_blocks=3, cams_per_block=5, n_points=256, n_obs=1024, ba_iterations=6, pg_iterations=4)


def _u8(x):
    return np.clip(x, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def data():
    seqs = [SyntheticSequence(n_frames=1 + 4 * CHUNK, shape=(96, 256), fx=120.0, speed=0.12, seed=3 + s)
            for s in range(S)]
    frames = [list(q) for q in seqs]
    first = tuple(np.stack([fr[0][k] for fr in frames]) for k in (1, 2))
    chunks = [
        tuple(np.stack([np.stack([_u8(fr[t][k]) for fr in frames])
                        for t in range(1 + c * CHUNK, 1 + (c + 1) * CHUNK)]) for k in (1, 2))
        for c in range(4)
    ]
    return dict(frames=frames, first=first, chunks=chunks, baseline=seqs[0].baseline)


def _engine(data, cfg=None):
    cam = tcam.from_intrinsics(120.0, 120.0, 128.0, 48.0, data["baseline"])
    bvo = BatchedStereoVO(cfg or Config(**KW), cam, S, chunk=CHUNK, kf_cadence=CHUNK, device="cpu")
    bvo.make_refiner(**REFINER)
    return bvo


def _same_state(a, b):
    for x, y in zip(tstate.leaves(a), tstate.leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.fixture(scope="module")
def saved(data, tmp_path_factory):
    """The engine after two chunks and a sweep, its checkpoint, and the
    state it reaches after a chunk, a sweep and a chunk more."""
    path = str(tmp_path_factory.mktemp("ckpt") / "state.npz")
    bvo = _engine(data)
    bvo.start(*data["first"], seed=5)
    bvo.process_chunk(*data["chunks"][0])
    bvo.process_chunk(*data["chunks"][1])
    bvo.refine()
    at_save = bvo.state
    save_state(path, bvo.state, bvo.generator)
    _tail(bvo, data)
    return dict(path=path, at_save=at_save, final=bvo.state)


def _tail(bvo, data):
    bvo.process_chunk(*data["chunks"][2])
    verdicts = bvo.refine()
    bvo.process_chunk(*data["chunks"][3])
    return verdicts


def test_resume_in_a_fresh_engine_is_bit_equal(data, saved):
    fresh = _engine(data)
    fresh.start(*data["first"], seed=99)            # supplies the structure; another seed
    fresh.state = load_state(saved["path"], fresh.state, fresh.generator)
    _same_state(fresh.state, saved["at_save"])
    verdicts = _tail(fresh, data)
    assert verdicts.shape == (S,)
    _same_state(fresh.state, saved["final"])
    assert int(fresh.state.frame_id[0]) == 4 * CHUNK


def test_resume_without_the_generator_state_diverges(data, saved):
    """The PnP noise is part of the run: a resume that restores the state
    alone is a valid run, but not the one the checkpoint was taken from."""
    fresh = _engine(data)
    fresh.start(*data["first"], seed=99)
    fresh.state = load_state(saved["path"], fresh.state)
    _same_state(fresh.state, saved["at_save"])
    _tail(fresh, data)
    assert not torch.equal(fresh.state.poses, saved["final"].poses)
    assert bool(torch.isfinite(fresh.state.poses).all())


def test_single_stream_round_trip(data, tmp_path):
    cam = tcam.from_intrinsics(120.0, 120.0, 128.0, 48.0, data["baseline"])
    frames = data["frames"][0]
    vo = StereoVO(Config(**KW), cam, seed=3, device="cpu")
    vo.start(*frames[0][1:])
    for _, l, r in frames[1:4]:
        vo.process(l, r)
    path = str(tmp_path / "single.npz")
    save_state(path, vo.state, vo.generator)
    other = StereoVO(Config(**KW), cam, seed=8, device="cpu")
    other.start(*frames[0][1:])
    other.state = load_state(path, other.state, other.generator)
    for _, l, r in frames[4:7]:
        vo.process(l, r)
        other.process(l, r)
    _same_state(vo.state, other.state)
    save_state(path, vo.state)
    with pytest.raises(ValueError, match="no generator state"):
        load_state(path, other.state, other.generator)


def test_wrong_shape_raises_svo_tpus_message(data, saved, tmp_path):
    small = Config(**KW, capacity=Capacity(max_features=64))
    other = _engine(data, small)
    other.start(*data["first"])
    with pytest.raises(ValueError) as port_err:
        load_state(saved["path"], other.state)
    # svo_tpu's loader on a pytree with one leaf of another shape
    jpath = str(tmp_path / "j.npz")
    jcheckpoint.save_state(jpath, {"a": jnp.zeros((2, 128, 2))})
    with pytest.raises(ValueError) as jax_err:
        jcheckpoint.load_state(jpath, {"a": jnp.zeros((2, 64, 2))})
    assert str(port_err.value) == str(jax_err.value)
    assert "was the Config (capacities/image size) changed?" in str(port_err.value)
