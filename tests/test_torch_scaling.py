"""The port's scaling harness (svo_tpu_torch/scaling_eff.py and its two
workers) and MultiStereoVO with several streams a rank, after
scripts/scaling_eff.py, scripts/scaling_worker.py,
scripts/frontend_scaling_worker.py and svo_tpu/parallel/multi_seq.py.

Held: ba/synthetic.make_problem equal to tests/test_ba.py::make_problem bit
for bit (the problem, the truths and the rng's state after); the BA worker
as 1 and as 2 gloo processes (4 cameras x 256 points, 3 LM iterations, 1
rep): both ranks report the same final cost bit for bit, the arms agree
within 1e-3 relative (1 and 2 point blocks sum the camera system in
another order) and each is within 1e-3 relative of svo_tpu's solve_ba on
the same problem; measure() and result() give SCALING_r05.json's keys plus
the placement's; the frontend worker's two arms at 8 frames give bit-equal
trajectories; scaling_trace reads each arm of the 2-block split (rows,
padding and longest runs as numpy counts them, the whole arm's cost within
1e-3 relative of svo_tpu's solve_ba); --placement cards is refused without
2 cards, and nothing falls back to the CPU. MultiStereoVO(n_streams=2) in a world of one is two
StereoVO(seed + s) bit for bit, every step's fleet_health included;
n_streams=4 over 2 gloo processes equals n_streams=4 in a world of one bit
for bit; n_streams=3 over 2 processes raises.
"""

import inspect
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_tpu.ba.solver import solve_ba as jsolve_ba
from svo_tpu_torch import scaling_eff, scaling_trace
from svo_tpu_torch.ba import synthetic
from svo_tpu_torch.ba.solver import BAProblem
from svo_tpu_torch.config import Config
from svo_tpu_torch.geometry import camera as cam_mod
from svo_tpu_torch.io.synthetic import SyntheticSequence
from svo_tpu_torch.parallel.multi_seq import MultiStereoVO
from svo_tpu_torch.pipeline.odometry import StereoVO
from test_ba import BASELINE, FX, K_MAT, make_problem
from torch_dist import REPO, run_code, world_of_one

torch.set_num_threads(2)

with open(os.path.join(REPO, "SCALING_r05.json")) as _f:
    R05 = json.load(_f)
CAMS, PTS, ITERS = 4, 256, 3
F, SEED = 6, 3


@pytest.mark.parametrize("kw", [
    dict(n_cams=CAMS, n_pts=PTS, noise_px=0.4),
    dict(n_cams=7, n_pts=300, noise_px=0.5, perturb=False, stereo=False, drop_frac=0.25),
], ids=["scaling_size", "no_perturb_mono_dropped"])
def test_make_problem_is_test_bas(kw):
    want_rng, got_rng = np.random.default_rng(42), np.random.default_rng(42)
    want, want_T, want_pts = make_problem(want_rng, **kw)
    got, got_T, got_pts = synthetic.make_problem(got_rng, **kw)
    for f in BAProblem._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    np.testing.assert_array_equal(got_T, want_T)
    np.testing.assert_array_equal(got_pts, want_pts)
    assert got_rng.bit_generator.state == want_rng.bit_generator.state  # the same draws
    assert (synthetic.VGA_FX, synthetic.VGA_FY, synthetic.VGA_BASELINE) == (FX, 500.0, BASELINE)
    np.testing.assert_array_equal(synthetic.VGA_K_MAT, K_MAT)


@pytest.fixture(scope="module")
def ba_arms():
    return scaling_eff.measure(CAMS, PTS, reps=1, iters=ITERS, device="cpu")


@pytest.fixture(scope="module")
def frontend_arms():
    return scaling_eff.measure_frontend(8, device="cpu")


def test_ba_worker_arms_agree_with_each_other_and_svo_tpu(ba_arms):
    _, workers = ba_arms
    (one,), two = workers[1], workers[2]
    assert [w["rank"] for w in two] == [0, 1] and all(w["nprocs"] == 2 for w in two)
    assert two[0]["final_cost"] == two[1]["final_cost"]  # the global cost, bit for bit
    assert abs(two[0]["final_cost"] - one["final_cost"]) <= 1e-3 * one["final_cost"]
    prob, _, _ = make_problem(np.random.default_rng(42), n_cams=CAMS, n_pts=PTS, noise_px=0.4)
    ref = float(jsolve_ba(prob, jnp.asarray(K_MAT), jnp.float32(FX * BASELINE),
                          iterations=ITERS).cost)
    for w in (one, *two):
        assert abs(w["final_cost"] - ref) <= 1e-3 * ref, (w["final_cost"], ref)
        assert w["n_obs"] == int(np.asarray(prob.obs_valid).sum())
        assert (w["cams"], w["pts"], w["iters"], w["reps"]) == (CAMS, PTS, ITERS, 1)
        assert w["backend"] == "gloo" and w["device"] == "cpu"
        assert w["lm_iters_per_s"] == pytest.approx(ITERS / w["wall_s"])


def test_measure_writes_the_sweep_keys(ba_arms):
    point, workers = ba_arms
    assert set(R05["sweep"][0]) <= set(point)
    assert (point["cams"], point["pts"]) == (CAMS, PTS)
    t1, t2 = workers[1][0]["wall_s"], max(w["wall_s"] for w in workers[2])
    assert (point["t1_s"], point["t2_s"]) == (t1, t2)
    assert point["efficiency"] == pytest.approx(t1 / (2 * t2))
    assert point["comm_overhead_ms_per_iter"] == pytest.approx(max(t2 - t1 / 2, 0) / ITERS * 1e3)
    assert point["final_cost_2proc"] == [w["final_cost"] for w in workers[2]]


def test_frontend_arms_give_the_same_trajectories(frontend_arms):
    res, workers, trajs = frontend_arms
    assert trajs.shape == (2, 8, 4, 4) and np.isfinite(trajs).all()
    assert set(R05["frontend"]) - {"metric", "method"} <= set(res)
    assert res["trajectories_bit_equal"] and res["health_finite"]
    assert (res["streams"], res["steps"]) == (2, 8 - 6)
    assert [w["devices"] for w in workers[1]] == [["cpu", "cpu"]]
    assert [w["devices"] for w in workers[2]] == [["cpu"], ["cpu"]]
    # the CPU runs the kernels' plain versions: no launch
    assert res["launches"] == {a: {"klt_patches": 0, "klt_track": 0, "lk_level": 0, "threefry": 0,
                                   "ransac_pnp": 0, "fast_nms": 0}
                               for a in ("1proc", "2proc")}
    assert all(len(w["keyframes"]) == 2 // w["nprocs"] and min(w["keyframes"]) >= 1
               for ws in workers.values() for w in ws)


def test_result_has_the_scaling_keys(ba_arms, frontend_arms):
    point, frontend = ba_arms[0], frontend_arms[0]
    res = scaling_eff.result([point], frontend, scaling_eff.plan("cpu", "cards"), None)
    assert set(R05) | {"placement", "backend", "cards"} <= set(res)
    assert set(R05["frontend"]) <= set(res["frontend"])
    assert (res["placement"], res["backend"], res["cards"]) == ("cpu", "gloo", 0)
    assert res["met"] == (point["efficiency"] >= 0.8) and res["shared_card"] is False
    assert res["headline_problem"] == {"cams": CAMS, "pts": PTS, "n_obs": point["n_obs"]}
    shared = {"placement": "shared", "backend": "gloo", "cards": 1}
    res = scaling_eff.result([point], frontend, shared, "a card")
    assert res["shared_card"] is True and res["met"] is None and res["met_at_scope"] is None


def test_trace_reads_each_arm_of_the_split():
    r = scaling_trace.trace(CAMS, PTS, iters=ITERS, reps=1, device="cpu")
    assert scaling_trace.report(r)[0].startswith(f"BA {CAMS} cams x {PTS} pts")
    prob, _, _ = make_problem(np.random.default_rng(42), n_cams=CAMS, n_pts=PTS, noise_px=0.4)
    cam, pnt = np.asarray(prob.obs_cam), np.asarray(prob.obs_pnt)
    valid = np.asarray(prob.obs_valid)
    assert r["n_obs"] == int(valid.sum()) and r["device"] == "cpu"
    arms = r["arms"]
    assert list(arms) == ["whole", "block_0_of_2", "block_1_of_2"]
    whole = arms["whole"]
    assert (whole["rows"], whole["padding_rows"]) == (cam.size, int((~valid).sum()))
    assert whole["longest_run"] == {"camera": int(np.bincount(cam).max()),
                                    "point": int(np.bincount(pnt).max()),
                                    "camera_point": int(np.bincount(cam * PTS + pnt).max())}
    blocks = [arms[f"block_{b}_of_2"] for b in (0, 1)]
    assert all(b["rows"] == -(-cam.size // 2) for b in blocks)
    assert sum(b["rows"] - b["padding_rows"] for b in blocks) == int(valid.sum())
    for a in arms.values():
        assert a["wall_ms_per_iter"] == a["wall_ms_per_iter_rounds"][-1] > 0
        assert a["device_ms_per_iter"] > 0 and a["by_kind"] and np.isfinite(a["final_cost"])
    ref = float(jsolve_ba(prob, jnp.asarray(K_MAT), jnp.float32(FX * BASELINE),
                          iterations=ITERS).cost)
    assert abs(whole["final_cost"] - ref) <= 1e-3 * ref  # the whole arm is the full solve
    assert r["device_ratio_whole_to_block"] == pytest.approx(
        whole["device_ms_per_iter"] / max(b["device_ms_per_iter"] for b in blocks))


def test_cards_placement_is_refused_without_two_cards(capsys):
    if torch.cuda.is_available():
        pytest.skip("the refusals are read on a machine without a CUDA card")
    assert scaling_eff.parse_args([]).device == "cuda"
    assert scaling_eff.parse_args([]).placement == "cards"
    for argv in ([], ["--placement", "shared"]):
        assert scaling_eff.main(argv) == 1
        out = capsys.readouterr()
        assert out.out == "" and "scaling_eff: --" in out.err
    with pytest.raises(RuntimeError, match="2 CUDA cards"):
        scaling_eff.measure(CAMS, PTS, 1, device="cuda")


def fleet(S, F=6, shape=(184, 320)):
    """S streams of different motion, their Config and camera."""
    seqs = [SyntheticSequence(n_frames=F, shape=shape, fx=200.0, speed=0.2 + 0.02 * s, seed=s)
            for s in range(S)]
    frames = [list(sq) for sq in seqs]
    cfg = Config(use_orb=False, image_height=shape[0], image_width=shape[1])
    camera = cam_mod.from_intrinsics(200.0, 200.0, 160.0, 92.0, seqs[0].baseline)
    return frames, cfg, camera


def _drive(multi, frames):
    stack = lambda t, k: np.stack([fr[t][k] for fr in frames])  # noqa: E731
    multi.start(stack(0, 1), stack(0, 2), seed=SEED)
    health = []
    for t in range(1, F):
        multi.process(stack(t, 1), stack(t, 2))
        health.append(multi.fleet_health)
    return multi.trajectories(F), np.stack(health)


def test_two_streams_in_one_process_are_two_stereo_vos():
    frames, cfg, camera = fleet(2)
    with world_of_one():
        with pytest.raises(ValueError, match="2 devices"):
            MultiStereoVO(cfg, camera, n_streams=2, devices=["cpu"], device="cpu")
        multi = MultiStereoVO(cfg, camera, n_streams=2, devices=["cpu", "cpu"], device="cpu")
        trajs, health = _drive(multi, frames)
    singles = [StereoVO(cfg, camera, seed=SEED + s, device="cpu").run(frames[s]) for s in range(2)]
    assert trajs.shape == (2, F, 4, 4) and health.shape == (F - 1, 5)
    for s in range(2):
        np.testing.assert_array_equal(trajs[s], singles[s].poses)
    np.testing.assert_array_equal(health, singles[0].metrics[1:] + singles[1].metrics[1:])
    assert not np.allclose(trajs[0][:, :3, 3], trajs[1][:, :3, 3], atol=1e-3)


# two streams a rank, in a fresh interpreter that imports only the port
RANK_CODE = """
import numpy as np, pytest, torch
from svo_tpu_torch.config import Config
from svo_tpu_torch.geometry import camera as cam_mod
from svo_tpu_torch.io.synthetic import SyntheticSequence
""" + inspect.getsource(fleet) + inspect.getsource(_drive) + """
torch.set_num_threads(2)
from svo_tpu_torch.parallel import multihost
from svo_tpu_torch.parallel.multi_seq import MultiStereoVO

multihost.init(f"localhost:{PORT}", WORLD, RANK, backend="gloo", timeout_s=120)
frames, cfg, camera = fleet(4)
with pytest.raises(ValueError, match="3 streams do not split evenly over 2 ranks"):
    MultiStereoVO(cfg, camera, n_streams=3, device="cpu")
trajs, health = _drive(MultiStereoVO(cfg, camera, n_streams=4, device="cpu"), frames)
np.savez(OUT.format(RANK), trajs=trajs, health=health)
torch.distributed.destroy_process_group()
"""


def test_four_streams_over_two_ranks_are_four_in_one(tmp_path):
    run_code(RANK_CODE, 2, timeout=240, F=F, SEED=SEED, OUT=str(tmp_path / "ms_{}.npz"))
    frames, cfg, camera = fleet(4)
    with world_of_one():
        trajs, health = _drive(MultiStereoVO(cfg, camera, n_streams=4, device="cpu"), frames)
    assert trajs.shape == (4, F, 4, 4)
    for r in range(2):
        got = np.load(tmp_path / f"ms_{r}.npz")
        np.testing.assert_array_equal(got["trajs"], trajs)
        np.testing.assert_array_equal(got["health"], health)
