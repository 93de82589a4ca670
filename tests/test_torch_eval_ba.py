"""The refinement sweep of the port (svo_tpu_torch/eval_ba.py) against
scripts/eval_ba.py's on svo_tpu, on the CPU.

svo_tpu runs 49 frames at 184x320 (fx 200, speed 0.3, chunk 12, cadence 6);
from its final state (pipeline/state.from_numpy) the port's sweep and
svo_tpu's refine_global run over the same schedule, span ends [21, 42, 48]
(block_span(4, 7) = 22), with the script's sizes (512 points, 2,048
observations, 10 BA and 8 pose-graph iterations), each sweep's map and
trajectory feeding the next. Held: the schedule and each sweep's regime and
verdict identical, cost per observation within 1e-4 relative, the poses
within 5e-3 m, the ATE after the sweep within 1e-3 m. eval_ba.main runs as
a user would, at 25 frames.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_tpu.config import Config as JConfig
from svo_tpu.eval.trajectory import ate_rmse as jate
from svo_tpu.geometry import camera as jcam
from svo_tpu.parallel import global_opt as jglobal_opt
from svo_tpu.pipeline.odometry import StereoVO as JStereoVO
from svo_tpu_torch import eval_ba
from svo_tpu_torch.eval.trajectory import ate_rmse
from svo_tpu_torch.geometry import camera as tcam
from svo_tpu_torch.io.synthetic import SyntheticSequence
from svo_tpu_torch.pipeline.state import from_numpy

torch.set_num_threads(2)

N, SHAPE, FX = 49, (184, 320), 200.0


@pytest.fixture(scope="module")
def svo_run():
    seq = SyntheticSequence(n_frames=N, shape=SHAPE, fx=FX, speed=0.3)
    frames = list(seq)
    cam = jcam.from_intrinsics(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline)
    vo = JStereoVO(JConfig(use_orb=False, image_height=SHAPE[0], image_width=SHAPE[1]), cam,
                   chunk=12, kf_cadence=6)
    res = vo.run_chunked(frames)
    return seq, cam, res, jax.tree.map(np.asarray, vo.state)


def _svo_sweep(cam, state, his):
    """scripts/eval_ba.py's loop (refine_global jitted once for the three
    calls of one shape)."""
    K_mat = jnp.asarray(cam.K)
    bfx = jnp.float32(cam.K[0, 0] * cam.baseline)
    refine = jax.jit(lambda mp, poses, hi: jglobal_opt.refine_global(
        mp, poses, hi, K_mat, bfx, n_blocks=4, cams_per_block=7, **eval_ba.SWEEP))
    mp, poses, verdicts = state.map, state.poses, []
    for hi in his:
        out = refine(mp, poses, jnp.int32(hi))
        mp, poses = out.map, out.poses
        verdicts.append((bool(out.accepted), float(out.cost_per_obs)))
    return np.asarray(poses), verdicts


def test_sweep_matches_svo_tpu(svo_run):
    seq, cam, res, jstate = svo_run
    assert res.n_frames == N
    his = eval_ba.schedule(N, 4, 7)
    assert his == [21, 42, 48]
    want_poses, want = _svo_sweep(cam, jstate, his)

    camera = tcam.from_intrinsics(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2],
                                  seq.baseline)
    st = from_numpy(jstate, "cpu")
    _, poses, got = eval_ba.sweep(st.map, st.poses, camera, his, 4, 7)
    poses = poses.numpy()
    for (acc, cost), (jacc, jcost) in zip(got, want):
        assert acc == jacc
        assert (cost > 10.0) == (jcost > 10.0)  # the regime
        assert abs(cost - jcost) <= 1e-4 * jcost
    d = np.linalg.norm(poses[:N, :3, 3] - want_poses[:N, :3, 3], axis=-1)
    assert d.max() < 5e-3, d
    gt = seq.gt_poses[:N]
    ate_after, want_after = ate_rmse(poses[:N], gt), jate(want_poses[:N], gt)
    assert abs(ate_after - want_after) <= 1e-3
    assert np.isfinite(poses).all()


def test_eval_ba_main(tmp_path):
    out = tmp_path / "ba.json"
    assert eval_ba.main(["--small", "--frames", "25", "--device", "cpu", "--out", str(out)]) == 0
    r = json.loads(out.read_text())
    assert r["frames"] == 25 and r["his"] == [21, 24] and r["sweeps"] == 2
    assert len(r["accepted"]) == len(r["cost_per_obs"]) == 2
    assert r["block_lm_iters"] == 2 * 4 * 10 and r["device"] == "cpu" and r["finite"]
    assert r["ate_after_m"] < 0.05 * r["traveled_m"]
    assert r["steps"] == {"frames": 24, "keyframes": 5}


def test_schedule_is_the_scripts():
    assert eval_ba.schedule(505, 4, 7) == list(range(21, 505, 21))  # 504 = 24 x 21
    assert eval_ba.schedule(97, 4, 7) == [21, 42, 63, 84, 96]
    assert eval_ba.schedule(43, 4, 7) == [21, 42]
    assert eval_ba.schedule(20, 4, 7) == []
