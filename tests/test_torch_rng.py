"""svo_tpu's PRNG in the port (svo_tpu_torch/ops/random.py) and the key in
the port's VoState.

(a) prng_key, split and the 32-bit uniform words bit-equal to jax's for
    seeds {0, 1, 7, 2**31-1, 2**32-1} and for a vmapped (3, 2) key stack;
    the Gumbel noise within 1e-6 abs (the same float ops; torch's log and
    XLA's round differently, 4.8e-7 read); the top-6 index sets of the PnP
    sampling identical over 20 keys; Random123's known answers for
    Threefry-2x32-20, through the port's hash and jax's.
(b) split_gumbel on CPU tensors is its plain version and launches nothing;
    it refuses keys of another type or shape.
(c) The port's StereoVO(seed=3) against svo_tpu's StereoVO(seed=3) with no
    noise handed in, 13 frames at 96x256 frame by frame (the dynamic
    rule): keys bit-equal every frame, keyframe flags identical, poses
    within 1e-4.
(d) Checkpoints interchange: svo_tpu's state after 13 frames, written by
    svo_tpu's save_state, resumes in a fresh port engine through the
    port's load_state; the port's, written by its save_state, resumes in
    svo_tpu through svo_tpu's load_state with every leaf's bits (the key's
    included). Each resumed run continues 6 frames beside the other
    package's uninterrupted run: keys bit-equal, keyframe flags identical,
    poses within 1e-4.
(e) BatchedStereoVO(S=3, seed=5) stream s against StereoVO(seed=5+s), in
    the port and in svo_tpu (13 frames at 96x256, chunks of 6, a keyframe
    every 6): keys bit-equal every stream in each package and across the
    packages, poses within 1e-4 (test_torch_batched.py's batched-against-
    single bound) but on a frame whose final PnP pick is a raw 6-point DLT
    hypothesis, which carries rounding to mm (ROADMAP C): at most one such
    frame a stream, held to 2e-3. svo_tpu's own stream 2 reads 1.4e-3 at
    frame 6 against its single run, and 1.3e-6 at frame 7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax._src import prng as jprng
from svo_tpu.config import Config as JConfig
from svo_tpu.geometry import camera as jcam
from svo_tpu.io.synthetic import SyntheticSequence
from svo_tpu.parallel.batched import BatchedStereoVO as JBatched
from svo_tpu.pipeline.odometry import StereoVO as JStereoVO
from svo_tpu.utils import checkpoint as jcheckpoint
from svo_tpu_torch.config import Config as TConfig
from svo_tpu_torch.geometry import camera as tcam
from svo_tpu_torch.ops import random as trandom
from svo_tpu_torch.parallel.batched import BatchedStereoVO as TBatched
from svo_tpu_torch.pipeline import state as tstate
from svo_tpu_torch.pipeline.odometry import StereoVO as TStereoVO
from svo_tpu_torch.utils import checkpoint as tcheckpoint

torch.set_num_threads(2)

SEEDS = (0, 1, 7, 2**31 - 1, 2**32 - 1)
SHAPE = (128, 128)  # (hypotheses, max_features) of Config()
H, W = 96, 256
KW = dict(use_orb=False, image_height=H, image_width=W)
N_RUN, N_MORE = 13, 6  # frames before the checkpoint, frames after it
# Random123's known-answer vectors for threefry2x32_20 (kat_vectors):
# (counter, key) -> output
KAT = (
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x243F6A88, 0x85A308D3), (0x13198A2E, 0x03707344), (0xC4923A9C, 0x483DF7A0)),
)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _key(words) -> torch.Tensor:
    return torch.from_numpy(np.asarray(words, np.uint32).view(np.int32))


# ---------------------------------------------------------------- (a), (b)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_bits_and_gumbel_match_jax(seed):
    key, jkey = trandom.prng_key(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(_u32(key), np.asarray(jkey))
    rng, sub = trandom.split(key)
    jrng, jsub = jax.random.split(jkey)
    np.testing.assert_array_equal(_u32(rng), np.asarray(jrng))
    np.testing.assert_array_equal(_u32(sub), np.asarray(jsub))
    bits = trandom.random_bits(sub, SHAPE).numpy()
    np.testing.assert_array_equal(bits, np.asarray(jax.random.bits(jsub, SHAPE)).astype(np.int64))
    g = trandom.gumbel(sub, SHAPE).numpy()
    assert g.dtype == np.float32 and np.isfinite(g).all()
    np.testing.assert_allclose(g, np.asarray(jax.random.gumbel(jsub, SHAPE)), rtol=0, atol=1e-6)


def test_vmapped_key_stack_matches_jax():
    seeds = np.array([5, 6, 2**32 - 1], np.uint32)
    keys = trandom.prng_key(seeds)
    jkeys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))
    assert tuple(keys.shape) == (3, 2)
    np.testing.assert_array_equal(_u32(keys), np.asarray(jkeys))
    rng, sub = trandom.split(keys)
    jsplit = jax.vmap(jax.random.split)(jkeys)  # (3, 2, 2)
    np.testing.assert_array_equal(_u32(rng), np.asarray(jsplit[:, 0]))
    np.testing.assert_array_equal(_u32(sub), np.asarray(jsplit[:, 1]))
    jsub = jsplit[:, 1]
    np.testing.assert_array_equal(
        trandom.random_bits(sub, SHAPE).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.bits(k, SHAPE))(jsub)).astype(np.int64))
    new, noise = trandom.split_gumbel(keys, SHAPE)
    assert tuple(noise.shape) == (3,) + SHAPE
    np.testing.assert_array_equal(_u32(new), np.asarray(jsplit[:, 0]))
    np.testing.assert_allclose(
        noise.numpy(), np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, SHAPE))(jsub)),
        rtol=0, atol=1e-6)
    # a row of the stack is the key alone
    for s in range(3):
        np.testing.assert_array_equal(noise[s].numpy(),
                                      trandom.split_gumbel(keys[s], SHAPE)[1].numpy())


def test_top6_index_sets_identical():
    """The PnP sampling (svo_tpu/geometry/pnp.py:168-170): Gumbel top-6 over
    the valid slots, for 20 keys, with half the slots dead."""
    valid = np.random.default_rng(0).random(SHAPE[1]) < 0.5
    jkey, key = jax.random.PRNGKey(11), trandom.prng_key(11)
    for _ in range(20):
        jkey, jsub = jax.random.split(jkey)
        key, g = trandom.split_gumbel(key, SHAPE)
        jg = jax.random.gumbel(jsub, SHAPE)
        _, jidx = jax.lax.top_k(jnp.where(jnp.asarray(valid)[None], jg, -jnp.inf), 6)
        idx = torch.topk(torch.where(torch.from_numpy(valid)[None], g, -torch.inf), 6).indices
        np.testing.assert_array_equal(np.sort(idx.numpy(), -1), np.sort(np.asarray(jidx), -1))


@pytest.mark.parametrize("ctr, key, want", KAT, ids=["zeros", "ones", "pi"])
def test_random123_known_answers(ctr, key, want):
    k0, k1, x0, x1 = (torch.tensor(v, dtype=torch.int64) for v in (*key, *ctr))
    got = trandom.threefry2x32_ref(k0, k1, x0, x1)
    assert tuple(int(v) for v in got) == want
    jgot = jprng.threefry_2x32(np.asarray(key, np.uint32), np.asarray(ctr, np.uint32))
    assert tuple(int(v) for v in np.asarray(jgot)) == want


def test_split_gumbel_on_the_cpu_is_the_plain_version():
    keys = trandom.prng_key([3, 4])
    before = trandom.split_gumbel.launches
    new, noise = trandom.split_gumbel(keys, (8, 16))
    assert trandom.split_gumbel.launches == before
    rng, sub = trandom.split(keys)
    assert torch.equal(new, rng) and new.dtype == torch.int32
    assert torch.equal(noise, trandom.gumbel(sub, (8, 16)))
    with pytest.raises(ValueError, match="int32"):
        trandom.split_gumbel(keys.to(torch.int64), (8, 16))
    with pytest.raises(ValueError, match="int32"):
        trandom.split_gumbel(torch.zeros(3, dtype=torch.int32), (8, 16))
    # the key's bits survive the int32 round trip of the state
    words = np.array([0xFFFFFFFF, 0x80000000], np.uint32)
    np.testing.assert_array_equal(_u32(_key(words)), words)


# ------------------------------------------------------------ (c), (d)


@pytest.fixture(scope="module")
def seq():
    sq = SyntheticSequence(n_frames=N_RUN + N_MORE, shape=(H, W), fx=120.0, speed=0.12, seed=3)
    return sq, list(sq)


def _cams(sq):
    args = (sq.K[0, 0], sq.K[1, 1], sq.K[0, 2], sq.K[1, 2], sq.baseline)
    return jcam.from_intrinsics(*args), tcam.from_intrinsics(*args)


def _record(state, f):
    """(key words, keyframe flag, pose) of frame f of a state, as numpy."""
    if isinstance(state, tstate.VoState):
        state = tstate.to_numpy(state)
    return (np.asarray(state.rng).copy(), bool(state.kf_flags[f]),
            np.asarray(state.poses[f]).copy())


def _same_frames(got, want, what):
    for f, ((k, kf, T), (jk, jkf, jT)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(k, jk, err_msg=f"{what}: key of frame {f}")
        assert kf == jkf, f"{what}: keyframe flag of frame {f}"
        np.testing.assert_allclose(T, jT, rtol=0, atol=1e-4, err_msg=f"{what}: pose of frame {f}")


@pytest.fixture(scope="module")
def runs(seq, tmp_path_factory):
    """Both packages' StereoVO(seed=3) over all frames, frame by frame, each
    saving its state after N_RUN frames with its own save_state."""
    sq, frames = seq
    jcam_, tcam_ = _cams(sq)
    tmp = tmp_path_factory.mktemp("rng")
    out = {"svo_tpu_ckpt": str(tmp / "svo_tpu.npz"), "port_ckpt": str(tmp / "port.npz")}
    jv = JStereoVO(JConfig(**KW), jcam_, seed=3)
    tv = TStereoVO(TConfig(**KW), tcam_, seed=3, device="cpu")
    jv.start(*frames[0][1:])
    tv.start(*frames[0][1:])
    out["svo_tpu"], out["port"] = [_record(jv.state, 0)], [_record(tv.state, 0)]
    for f, (_, left, right) in enumerate(frames[1:], start=1):
        if f == N_RUN:
            jcheckpoint.save_state(out["svo_tpu_ckpt"], jv.state)
            tcheckpoint.save_state(out["port_ckpt"], tv.state)
            out["port_at_save"] = tstate.to_numpy(tv.state)
        jv.process(left, right)
        tv.process(left, right)
        out["svo_tpu"].append(_record(jv.state, f))
        out["port"].append(_record(tv.state, f))
    out["jv"] = jv
    return out


def test_stereo_vo_draws_svo_tpus_noise(runs):
    """No noise handed in: the port's own key chain is svo_tpu's."""
    _same_frames(runs["port"][:N_RUN], runs["svo_tpu"][:N_RUN], "port vs svo_tpu")
    kfs = [kf for _, kf, _ in runs["port"][:N_RUN]]
    assert 1 < sum(kfs) < N_RUN  # the dynamic rule decided
    # the key moves every frame
    assert len({tuple(k) for k, _, _ in runs["port"]}) == len(runs["port"])


def test_svo_tpu_checkpoint_resumes_in_the_port(seq, runs):
    sq, frames = seq
    _, tcam_ = _cams(sq)
    fresh = TStereoVO(TConfig(**KW), tcam_, seed=99, device="cpu")
    fresh.start(*frames[0][1:])  # the structure; another key
    fresh.state = tcheckpoint.load_state(runs["svo_tpu_ckpt"], fresh.state)
    assert fresh.state.rng.dtype == torch.int32
    np.testing.assert_array_equal(_u32(fresh.state.rng), runs["svo_tpu"][N_RUN - 1][0])
    got = []
    for f in range(N_RUN, N_RUN + N_MORE):
        fresh.process(*frames[f][1:])
        got.append(_record(fresh.state, f))
    _same_frames(got, runs["svo_tpu"][N_RUN:], "svo_tpu checkpoint resumed in the port")


def test_port_checkpoint_resumes_in_svo_tpu(seq, runs):
    sq, frames = seq
    jv = runs["jv"]
    restored = jcheckpoint.load_state(runs["port_ckpt"], jv.state)
    want = jax.tree.leaves(runs["port_at_save"])
    got = jax.tree.leaves(restored)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), b)
    assert restored.rng.dtype == jnp.uint32
    jcam_, _ = _cams(sq)
    resumed = JStereoVO(JConfig(**KW), jcam_, seed=99)
    resumed.start(*frames[0][1:])
    resumed.state = restored
    got = []
    for f in range(N_RUN, N_RUN + N_MORE):
        resumed.process(*frames[f][1:])
        got.append(_record(resumed.state, f))
    _same_frames(got, runs["port"][N_RUN:], "port checkpoint resumed in svo_tpu")


# --------------------------------------------------------------------- (e)


S_B, SEED_B, CHUNK_B = 3, 5, 6
F_B = 1 + 2 * CHUNK_B


@pytest.fixture(scope="module")
def streams():
    seqs = [SyntheticSequence(n_frames=F_B, shape=(H, W), fx=120.0, speed=0.1 + 0.02 * s,
                              seed=3 + s) for s in range(S_B)]
    frames = [list(sq) for sq in seqs]
    u8 = [[np.clip(f[k], 0, 255).astype(np.uint8) for f in fr] for fr in frames for k in (1, 2)]
    chunks = [
        tuple(np.stack([np.stack([u8[2 * s + k][t] for s in range(S_B)])
                        for t in range(1 + c * CHUNK_B, 1 + (c + 1) * CHUNK_B)]) for k in (0, 1))
        for c in range(2)
    ]
    first = tuple(np.stack([fr[0][k] for fr in frames]) for k in (1, 2))
    return dict(frames=frames, chunks=chunks, first=first, cams=_cams(seqs[0]))


def _batched(pkg, streams):
    jcam_, tcam_ = streams["cams"]
    if pkg == "svo_tpu":
        bvo = JBatched(JConfig(**KW), jcam_, S_B, chunk=CHUNK_B, kf_cadence=CHUNK_B)
    else:
        bvo = TBatched(TConfig(**KW), tcam_, S_B, chunk=CHUNK_B, kf_cadence=CHUNK_B, device="cpu")
    bvo.start(*streams["first"], seed=SEED_B)
    for c in streams["chunks"]:
        bvo.process_chunk(*c)
    st = tstate.to_numpy(bvo.state) if pkg == "port" else jax.tree.map(np.asarray, bvo.state)
    return np.asarray(st.rng), bvo.trajectories(F_B)


def _singles(pkg, streams):
    """StereoVO(seed=SEED_B + s) on stream s's frames, for each s: one
    engine reseeded (the seed is the bootstrap's argument, so svo_tpu
    compiles its steps once)."""
    jcam_, tcam_ = streams["cams"]
    if pkg == "svo_tpu":
        vo = JStereoVO(JConfig(**KW), jcam_, chunk=CHUNK_B, kf_cadence=CHUNK_B)
    else:
        vo = TStereoVO(TConfig(**KW), tcam_, chunk=CHUNK_B, kf_cadence=CHUNK_B, device="cpu")
    out = []
    for s in range(S_B):
        vo.seed = SEED_B + s
        res = vo.run_chunked(streams["frames"][s])
        st = tstate.to_numpy(vo.state) if pkg == "port" else vo.state
        out.append((np.asarray(st.rng), res.poses))
    return out


@pytest.fixture(scope="module")
def batched_runs(streams):
    return {pkg: (_batched(pkg, streams), _singles(pkg, streams)) for pkg in ("svo_tpu", "port")}


def _close_poses(got, want, what):
    """(F, 4, 4) trajectories within 1e-4 on every frame but at most one
    raw-DLT frame, which is held to 2e-3."""
    d = np.abs(got - want).max(axis=(1, 2))
    assert d.max() < 2e-3 and (d > 1e-4).sum() <= 1, f"{what}: pose differences {d}"


@pytest.mark.parametrize("pkg", ["svo_tpu", "port"])
def test_batched_stream_is_the_single_stream_of_its_seed(batched_runs, pkg):
    (keys, trajs), singles = batched_runs[pkg]
    assert keys.dtype == np.uint32 and keys.shape == (S_B, 2)
    for s, (key, poses) in enumerate(singles):
        np.testing.assert_array_equal(keys[s], key, err_msg=f"{pkg} stream {s}")
        _close_poses(trajs[s], poses, f"{pkg} stream {s}")
    assert not np.allclose(trajs[0][:, :3, 3], trajs[1][:, :3, 3], atol=1e-3)


def test_batched_keys_match_across_packages(batched_runs):
    (jkeys, jtrajs), _ = batched_runs["svo_tpu"]
    (tkeys, ttrajs), _ = batched_runs["port"]
    np.testing.assert_array_equal(tkeys, jkeys)
    for s in range(S_B):
        _close_poses(ttrajs[s], jtrajs[s], f"stream {s}, port against svo_tpu")
