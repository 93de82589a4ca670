"""Long runs of the port: the observation ring wrapping under the running
pipeline, the soak script (svo_tpu_torch/soak.py) and the multi-world suite
(svo_tpu_torch/eval_worlds.py), on the CPU at small size.

The ring test is tests/test_soak_resume.py:53-84 for the port, with
svo_tpu stepping beside it on the same frames and the port given
svo_tpu's PnP noise at every step: after 25 frames with a 1024-slot ring
(wrapped twice), the window extracted at the last frame holds only
in-window rows, and equals svo_tpu's window in its rows, slots and
validity exactly, in its measurements and cameras to 1e-3, and in its
points to 1e-3 plus 1e-4 of their magnitude.
The soak and the suite run through their main(argv) as a user would: the
soak's JSON has the keys of svo_tpu's SOAK_r05.json and resumes bit for bit
after its checkpoint with refinement in the loop; the suite's JSON has a
row per world with finite ATEs (and the reference pipeline's where it ran).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_tpu.ba import window as jwindow
from svo_tpu.config import BaParams as JBaParams
from svo_tpu.config import Config as JConfig
from svo_tpu.geometry import camera as jcam
from svo_tpu.pipeline import frontend as jfront
from svo_tpu_torch.ba import window as twindow
from svo_tpu_torch.config import BaParams as TBaParams
from svo_tpu_torch.config import Config as TConfig
from svo_tpu_torch.eval.trajectory import ate_rmse
from svo_tpu_torch.geometry import camera as tcam
from svo_tpu_torch.io.synthetic import SyntheticSequence
from svo_tpu_torch.pipeline import frontend as tfront
from svo_tpu_torch.pipeline import state as tstate

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (184, 320)


def test_obs_ring_wraparound_keeps_window_consistent():
    n = 25
    seq = SyntheticSequence(n_frames=n, shape=SHAPE, fx=200.0, speed=0.25)
    kw = dict(use_orb=False, image_height=SHAPE[0], image_width=SHAPE[1])
    cfg_j = JConfig(**kw, ba=JBaParams(ring_obs=1024))
    cfg_t = TConfig(**kw, ba=TBaParams(ring_obs=1024))
    intr = (seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline)
    cam_j, cam_t = jcam.from_intrinsics(*intr), tcam.from_intrinsics(*intr)
    frames = list(seq)
    st_j = jfront.make_bootstrap(cam_j, cfg_j)(
        jnp.asarray(frames[0][1]), jnp.asarray(frames[0][2]), jnp.uint32(0))
    st_t = tstate.from_numpy(jax.tree.map(np.asarray, st_j), "cpu")
    step_j = jax.jit(lambda s, l, r: jfront.step_body(s, l, r, cam_j, cfg_j))
    shape = (cfg_j.ransac.num_hypotheses, cfg_j.capacity.max_features)
    for _, l, r in frames[1:]:
        # svo_tpu's hypothesis noise for this step (frontend.py:317)
        noise = np.array(jax.random.gumbel(jax.random.split(st_j.rng)[1], shape))
        st_j = step_j(st_j, jnp.asarray(l), jnp.asarray(r))
        st_t = tfront.step_body(st_t, torch.from_numpy(l), torch.from_numpy(r), cam_t, cfg_t,
                                pnp_noise=torch.from_numpy(noise))
    cursor = int(st_t.map.obs_cursor)
    assert cursor > 2 * 1024, f"ring did not wrap: cursor={cursor}"
    assert cursor == int(st_j.map.obs_cursor)

    fid = int(st_t.frame_id)
    prob, mapping = twindow.extract_window(st_t.map, st_t.poses, st_t.frame_id,
                                           n_cams=6, n_points=512, n_obs=1024)
    ov = prob.obs_valid.numpy()
    assert ov.any(), "window extraction found nothing after wraparound"
    cams = prob.obs_cam.numpy()[ov]
    assert int(mapping.frame_lo) == fid - 5
    assert cams.min() >= 0 and cams.max() <= 5
    traveled = np.linalg.norm(np.diff(seq.gt_poses[:n, :3, 3], axis=0), axis=1).sum()
    ate = ate_rmse(st_t.poses[:n].numpy(), seq.gt_poses[:n])
    assert ate < 0.05 * traveled, f"ATE {ate:.3f} over {traveled:.1f} m"

    jprob, jmap = jax.tree.map(np.asarray, jwindow.extract_window(
        st_j.map, st_j.poses, st_j.frame_id, n_cams=6, n_points=512, n_obs=1024))
    for f in ("obs_valid", "obs_cam", "obs_pnt", "cam_valid", "pnt_valid"):
        np.testing.assert_array_equal(getattr(prob, f).numpy(), getattr(jprob, f), err_msg=f)
    for f in mapping._fields:
        np.testing.assert_array_equal(getattr(mapping, f).numpy(), getattr(jmap, f), err_msg=f)
    for f in ("obs_uv", "T_cw"):
        np.testing.assert_allclose(getattr(prob, f).numpy(), getattr(jprob, f), atol=1e-3, err_msg=f)
    # a point's depth is fixed as 1/z: what rounding leaves open grows with
    # its distance (test_torch_ba.py's rule, 1e-4 of it)
    np.testing.assert_allclose(prob.points.numpy(), jprob.points, rtol=1e-4, atol=1e-3)


def test_soak_main(tmp_path):
    from svo_tpu_torch import soak

    out = tmp_path / "soak.json"
    assert soak.main(["--small", "--frames", "49", "--refine-every", "2", "--resume-chunks", "2",
                      "--device", "cpu", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    with open(os.path.join(REPO, "SOAK_r05.json")) as f:
        want = json.load(f)
    for key in ("capacity", "resume", "health", "refine"):
        assert set(want[key]) <= set(got[key]), key
    assert set(want) <= set(got)
    assert got["frames"] == 49 and got["device"] == "cpu" and got["finite"]
    assert got["resume"]["max_pose_diff"] == 0.0 and got["resume"]["equivalent"]
    assert got["refine"]["calls"] == 2 and got["capacity"]["obs_written"] > 0
    assert got["steps"] == {"frames": 48 + 24, "keyframes": 9 + 5}
    assert 0 < got["ate_pct_of_traveled"] < 5.0


@pytest.mark.parametrize("ref", [False, True], ids=["skip_ref", "with_ref"])
def test_eval_worlds_main(tmp_path, ref):
    from svo_tpu_torch import eval_worlds

    out = tmp_path / "worlds.json"
    argv = ["--small", "--worlds", "corridor-base,box-vfast", "--refine-every", "1",
            "--device", "cpu", "--out", str(out)]
    # with the reference: the first 25 frames of 37-frame sequences
    argv += ["--frames", "37", "--limit", "25"] if ref else ["--frames", "25", "--skip-ref"]
    assert eval_worlds.main(argv) == 0
    got = json.loads(out.read_text())
    assert got["streams"] == 4 and got["frames_per_world"] == 25
    assert got["sequence_frames"] == (37 if ref else 25)
    assert [r["world"] for r in got["worlds"]] == ["corridor-base", "box-vfast"]
    assert got["refine"]["sweeps"] == 2 and len(got["refine"]["accepted_per_stream"]) == 4
    assert got["comparisons"] == (4 if ref else 0)
    for row in got["worlds"]:
        assert row["held_out"] == (row["world"] == "box-vfast")
        for d in ("fwd", "rev"):
            assert np.isfinite(row[f"ate_{d}_m"]) and row[f"finite_{d}"]
            assert row[f"tracked_last_{d}"] > 0
            assert (f"ref_ate_{d}_m" in row) == ref
    corridor = got["worlds"][0]
    assert corridor["ate_fwd_m"] < 0.273 and corridor["ate_rev_m"] < 0.273
