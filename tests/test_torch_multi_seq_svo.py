"""The port's MultiStereoVO against svo_tpu's, two streams in one process.

svo_tpu's MultiStereoVO(n_streams=2) runs on 2 XLA CPU devices of this
process (tests/conftest.py gives 8), the port's MultiStereoVO(n_streams=2)
on the CPU in a gloo world of one, over test_multi_seq.py's sequences
(184x320, 6 frames, PnP seed 3). Both packages key stream s with seed + s
and split the key in the state once a frame, so they draw the same
hypotheses with no noise handed in (every stream's key bit-equal at the
end). At this size the
consensus pose hardly depends on the hypotheses drawn (the trajectories
read 8.6e-7 apart, and the same with the streams' noise swapped), so what
the comparison holds is chiefly the stream order: the two streams move
differently (their positions differ by more than 1e-3, the last check),
so a stream put in another slot than svo_tpu's fails the 1e-4 bound.

Held, stream by stream in global stream order: the trajectories within
1e-4 (svo_tpu's own bound between its MultiStereoVO and a lone StereoVO,
tests/test_multi_seq.py), and every step's metrics row within 1e-5
relative (tests/test_torch_pipeline.py's bound for a step's row); in each
package, every step's fleet_health is the sum of its streams' rows taken
in stream order, bit for bit, and the two packages' fleet_health agree
within the rows' bound.
"""

import jax
import numpy as np
import torch

from svo_tpu.config import Config as JConfig
from svo_tpu.geometry import camera as jcam
from svo_tpu.parallel.multi_seq import MultiStereoVO as JMultiStereoVO
from svo_tpu_torch.config import Config
from svo_tpu_torch.geometry import camera as tcam
from svo_tpu_torch.io.synthetic import SyntheticSequence
from svo_tpu_torch.parallel.multi_seq import MultiStereoVO
from torch_dist import world_of_one

torch.set_num_threads(2)

S, F, SEED = 2, 6, 3
SHAPE = (184, 320)


def _stack(frames, t, k):
    return np.stack([fr[t][k] for fr in frames])


def test_two_streams_match_svo_tpus_multi_stereo_vo():
    seqs = [SyntheticSequence(n_frames=F, shape=SHAPE, fx=200.0, speed=0.2 + 0.02 * s, seed=s)
            for s in range(S)]
    frames = [list(sq) for sq in seqs]
    intr = (200.0, 200.0, 160.0, 92.0, seqs[0].baseline)

    jmulti = JMultiStereoVO(JConfig(use_orb=False, image_height=SHAPE[0], image_width=SHAPE[1]),
                            jcam.from_intrinsics(*intr), S, devices=jax.devices()[:S])
    jmulti.start(_stack(frames, 0, 1), _stack(frames, 0, 2), seed=SEED)
    j_health, j_rows = [], []
    for t in range(1, F):
        jmulti.process(_stack(frames, t, 1), _stack(frames, t, 2))
        j_health.append(np.asarray(jmulti.fleet_health))
        metrics, fid = np.asarray(jmulti.state.metrics), np.asarray(jmulti.state.frame_id)
        j_rows.append(np.stack([metrics[s, fid[s]] for s in range(S)]))
    j_trajs = jmulti.trajectories(F)
    j_keys = np.asarray(jmulti.state.rng)

    cfg = Config(use_orb=False, image_height=SHAPE[0], image_width=SHAPE[1])
    with world_of_one():
        multi = MultiStereoVO(cfg, tcam.from_intrinsics(*intr), n_streams=S,
                              devices=["cpu"] * S, device="cpu")
        multi.start(_stack(frames, 0, 1), _stack(frames, 0, 2), seed=SEED)
        t_health, t_rows = [], []
        for t in range(1, F):
            multi.process(_stack(frames, t, 1), _stack(frames, t, 2))
            t_health.append(multi.fleet_health)
            t_rows.append(np.stack([vo.state.metrics[int(vo.state.frame_id)].numpy()
                                    for vo in multi.streams]))
        t_trajs = multi.trajectories(F)
        t_keys = np.stack([vo.state.rng.numpy().view(np.uint32) for vo in multi.streams])

    np.testing.assert_array_equal(t_keys, np.asarray(j_keys))

    assert j_trajs.shape == t_trajs.shape == (S, F, 4, 4)
    for s in range(S):
        np.testing.assert_allclose(t_trajs[s], j_trajs[s], rtol=0, atol=1e-4,
                                   err_msg=f"stream {s}")
    j_rows, t_rows = np.stack(j_rows), np.stack(t_rows)  # (F - 1, S, 5)
    assert (j_rows[:, :, 2] > 40).all()  # every stream tracks
    np.testing.assert_allclose(t_rows, j_rows, rtol=1e-5)
    for health, rows in ((np.stack(j_health), j_rows), (np.stack(t_health), t_rows)):
        want = rows[:, 0].copy()
        for s in range(1, S):
            want = want + rows[:, s]
        np.testing.assert_array_equal(health, want)
    np.testing.assert_allclose(np.stack(t_health), np.stack(j_health), rtol=1e-5)
    # streams with different motion differ, so a swapped order would show
    assert not np.allclose(t_trajs[0][:, :3, 3], t_trajs[1][:, :3, 3], atol=1e-3)
