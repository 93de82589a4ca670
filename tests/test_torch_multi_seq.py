"""The port's data-parallel multi-sequence VO (parallel/multi_seq.py): one
stream per rank of a gloo group, after tests/test_multi_seq.py.

Two gloo processes each run one stream of MultiStereoVO (seed 3: streams 3
and 4 of svo_tpu's keying); stream r must equal, bit for bit,
StereoVO(seed=3+r) on its frames in this process, and fleet_health after
every step must equal the sum of the two single runs' metrics rows. Streams
with different motion differ. A world of one in this process is
StereoVO itself, and a frame stack of the wrong stream count is refused;
its streams' eager steps (graph=False) give what its static-buffer steps
give, trajectories and fleet health bit for bit.
"""

import inspect

import numpy as np
import pytest
import torch

from svo_tpu_torch.config import Config
from svo_tpu_torch.geometry import camera as cam_mod
from svo_tpu_torch.io.synthetic import SyntheticSequence
from svo_tpu_torch.parallel.multi_seq import MultiStereoVO
from svo_tpu_torch.pipeline.odometry import StereoVO
from torch_dist import run_code, world_of_one

torch.set_num_threads(2)

F, SEED = 6, 3


def setup(S, F=6, shape=(184, 320)):
    """S streams of test_multi_seq.py's sequences, their Config and camera."""
    seqs = [SyntheticSequence(n_frames=F, shape=shape, fx=200.0, speed=0.2 + 0.02 * s, seed=s)
            for s in range(S)]
    frames = [list(sq) for sq in seqs]
    cfg = Config(use_orb=False, image_height=shape[0], image_width=shape[1])
    camera = cam_mod.from_intrinsics(200.0, 200.0, 160.0, 92.0, seqs[0].baseline)
    return frames, cfg, camera


# one rank of the fleet, in a fresh interpreter that imports only the port
RANK_CODE = """
import numpy as np, torch
from svo_tpu_torch.config import Config
from svo_tpu_torch.geometry import camera as cam_mod
from svo_tpu_torch.io.synthetic import SyntheticSequence
""" + inspect.getsource(setup) + """
torch.set_num_threads(2)
from svo_tpu_torch.parallel import multihost
from svo_tpu_torch.parallel.multi_seq import MultiStereoVO

multihost.init(f"localhost:{PORT}", WORLD, RANK, backend="gloo", timeout_s=120)
frames, cfg, camera = setup(WORLD)
multi = MultiStereoVO(cfg, camera, device="cpu")
stack = lambda t, k: np.stack([fr[t][k] for fr in frames])
multi.start(stack(0, 1), stack(0, 2), seed=SEED)
health = []
for t in range(1, F):
    multi.process(stack(t, 1), stack(t, 2))
    health.append(multi.fleet_health)
trajs = multi.trajectories(F)
np.savez(OUT.format(RANK), trajs=trajs, health=np.stack(health))
torch.distributed.destroy_process_group()
"""


def test_two_ranks_match_single_streams(tmp_path):
    run_code(RANK_CODE, 2, timeout=240, F=F, SEED=SEED, OUT=str(tmp_path / "ms_{}.npz"))
    frames, cfg, camera = setup(2)
    singles = [StereoVO(cfg, camera, seed=SEED + r, device="cpu").run(frames[r]) for r in range(2)]
    for r in range(2):
        got = np.load(tmp_path / f"ms_{r}.npz")
        assert got["trajs"].shape == (2, F, 4, 4) and got["health"].shape == (F - 1, 5)
        for s in range(2):
            np.testing.assert_array_equal(got["trajs"][s], singles[s].poses[:F])
        np.testing.assert_array_equal(
            got["health"], singles[0].metrics[1:F] + singles[1].metrics[1:F]
        )
        assert got["health"][-1, 2] > 0 and 0.0 <= got["health"][-1, 1] <= 2
    # streams with different motion must differ
    assert not np.allclose(singles[0].poses[:, :3, 3], singles[1].poses[:, :3, 3], atol=1e-3)


def test_world_of_one_is_stereo_vo():
    frames, cfg, camera = setup(1)
    with world_of_one():
        multi = MultiStereoVO(cfg, camera, device="cpu")
        with pytest.raises(ValueError, match="one frame per stream"):
            multi.start(np.stack([frames[0][0][1]] * 2), np.stack([frames[0][0][2]] * 2))
        multi.start(frames[0][0][1][None], frames[0][0][2][None], seed=SEED)
        for t in range(1, F):
            multi.process(frames[0][t][1][None], frames[0][t][2][None])
        trajs = multi.trajectories(F)
        health = multi.fleet_health
    single = StereoVO(cfg, camera, seed=SEED, device="cpu").run(frames[0])
    np.testing.assert_array_equal(trajs[0], single.poses[:F])
    np.testing.assert_array_equal(health, single.metrics[F - 1])


def test_world_of_one_eager_equals_static_steps():
    frames, cfg, camera = setup(1)
    out = {}
    with world_of_one():
        for graph in (None, False):
            multi = MultiStereoVO(cfg, camera, device="cpu", graph=graph)
            assert multi.streams[0].graph is graph
            multi.start(frames[0][0][1][None], frames[0][0][2][None], seed=SEED)
            health = []
            for t in range(1, F):
                multi.process(frames[0][t][1][None], frames[0][t][2][None])
                health.append(multi.fleet_health)
            out[graph] = (multi.trajectories(F), np.stack(health))
    for a, b in zip(out[None], out[False]):
        np.testing.assert_array_equal(a, b)
