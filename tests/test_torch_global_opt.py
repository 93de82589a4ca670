"""The port's global refinement (svo_tpu_torch/parallel/global_opt.py)
against svo_tpu's on the fixtures of tests/test_global_opt.py: the drifted
span (aggressive regime: block BA, chain re-init, pose-graph consensus), the
exact span and the noisy near-GT span (conservative regime).

Held: `accepted`, `frame_lo` and the regime identical; which blocks
improved identical; poses within 1e-3 m (measured 1.4e-4); the costs of the
incoming state (ba_cost0, span_cost0, cost_per_obs) 1e-4 relative, the
blocks' final costs and the conservative span cost 1e-3, the aggressive
regime's refined span cost 1e-2 (a 100x drop, read 0.3% apart) and its
pose-graph costs 5e-2: those are sums of squared residuals of a few mm
between poses that agree to 0.14 mm, read 0.4% and 1.7% apart. The zeros
of a skipped branch are exact. On the exact fixture every cost is ~1e-7,
the rounding of a zero, and the 10% gate on it is a coin toss (svo_tpu
accepts, the port does not, each moving points by ~1e-5 m): `accepted` is
not compared there. Points: ids that one block alone holds
within 2e-3 m; an id that two overlapping blocks hold must agree with
svo_tpu's value OR lie within 2e-3 m of one of the port's own per-block
candidates for it (svo_tpu leaves the winner of that scatter to XLA; the
port's rule, the later block, is held on its own). S states stacked
through the port's refiner equal S single calls bit for bit, with healthy
and drifted streams mixed in one stack.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_tpu.parallel import global_opt as jglobal
from svo_tpu_torch.parallel import global_opt as tglobal
from svo_tpu_torch.pipeline.state import MapState as TMapState
from svo_tpu_torch.pipeline.state import tensor
from test_global_opt import BASE, FX, K_MAT, make_drifted_state

torch.set_num_threads(2)

N = jglobal.block_span(4, 7)  # 22
KW = dict(n_blocks=4, cams_per_block=7, n_points=512, n_obs=2048, ba_iterations=14, pg_iterations=10)
K_T = torch.tensor(K_MAT)
BFX = FX * BASE

FIXTURES = {
    "drifted": dict(),
    "exact": dict(drift_rot=0.0, drift_trans=0.0, obs_noise=0.0, pnt_noise=0.0),
    "near_gt": dict(drift_rot=0.0, drift_trans=0.0),
}


def _tmap(mp) -> TMapState:
    return TMapState(*(tensor(np.asarray(getattr(mp, f))) for f in TMapState._fields))


def _ate(poses, gt):
    return float(np.sqrt(np.mean(np.sum((poses[:, :3, 3] - gt[:, :3, 3]) ** 2, axis=-1))))


@pytest.fixture(scope="module")
def cases():
    """Each fixture once through svo_tpu (one compile) and once through the
    port, the port's per-block point candidates recorded on the way."""
    out = {}
    for i, (name, kw) in enumerate(FIXTURES.items()):
        mp, poses, gt, est = make_drifted_state(np.random.default_rng(42 + i), n_frames=N, **kw)
        rj = jglobal.refine_global(mp, poses, jnp.int32(N - 1), jnp.asarray(K_MAT), jnp.float32(BFX), **KW)
        rj = jax.tree.map(np.asarray, rj)
        tm, tp = _tmap(mp), torch.tensor(np.asarray(poses))
        seen = {}
        orig = tglobal._write_block_points

        def record(points, pid, pts_corr, seen=seen, orig=orig):
            seen["pid"], seen["pts"] = pid, pts_corr
            return orig(points, pid, pts_corr)

        tglobal._write_block_points = record
        try:
            rt = tglobal.refine_global(tm, tp, torch.tensor(N - 1, dtype=torch.int32), K_T, BFX, **KW)
        finally:
            tglobal._write_block_points = orig
        out[name] = dict(mp=tm, poses=tp, gt=gt, est=est, rj=rj, rt=rt, seen=seen)
    return out


COST_RTOL = {"ba_cost0": 1e-4, "span_cost0": 1e-4, "cost_per_obs": 1e-4, "ba_cost": 1e-3,
             "span_cost": 1e-3, "pg_cost0": 5e-2, "pg_cost": 5e-2}


def _close(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return bool(np.all(np.abs(a - b) <= rtol * np.abs(a) + 1e-6))


@pytest.mark.parametrize("name", FIXTURES)
def test_refine_global_decisions_costs_and_poses(cases, name):
    c = cases[name]
    rj, rt = c["rj"], c["rt"]
    if name != "exact":
        assert bool(rt.accepted) == bool(rj.accepted)
    assert int(rt.frame_lo) == int(rj.frame_lo) == 0
    aggressive = float(rt.cost_per_obs) > 10.0
    assert aggressive == (float(rj.cost_per_obs) > 10.0) == (name == "drifted")
    for f, rtol in COST_RTOL.items():
        if f == "span_cost" and aggressive:
            rtol = 1e-2
        assert _close(getattr(rj, f), getattr(rt, f).numpy(), rtol), (f, getattr(rj, f), getattr(rt, f))
    assert np.array_equal(rj.ba_cost <= rj.ba_cost0, (rt.ba_cost <= rt.ba_cost0).numpy())
    if not aggressive:  # the skipped branch's outputs, exactly
        assert not rt.ba_cost0.any() and not rt.ba_cost.any()
        assert float(rt.pg_cost0) == 0.0 and float(rt.pg_cost) == 0.0
        assert torch.equal(rt.poses, c["poses"])  # poses never move in this regime
    np.testing.assert_allclose(rt.poses.numpy()[:, :3, 3], rj.poses[:, :3, 3], atol=1e-3)
    np.testing.assert_allclose(rt.poses.numpy(), rj.poses, atol=1e-3)
    # what tests/test_global_opt.py asks of svo_tpu holds for the port
    ate0, ate1 = _ate(c["est"][:N], c["gt"][:N]), _ate(rt.poses.numpy()[:N], c["gt"][:N])
    if name == "drifted":
        assert bool(rt.accepted) and ate0 > 0.05 and ate1 < 0.2 * ate0
    elif name == "exact":
        assert ate1 < 2e-4
    else:
        assert ate1 < 2e-2


@pytest.mark.parametrize("name", FIXTURES)
def test_refine_global_points(cases, name):
    c = cases[name]
    pj, pt = c["rj"].map.points, c["rt"].map.points.numpy()
    diff = np.abs(pj - pt).max(axis=-1)
    if "pid" not in c["seen"]:  # conservative regime: no block scatter at all
        assert diff.max() < 2e-3
        assert bool(c["rt"].accepted) == bool((pt != c["mp"].points.numpy()).any())
        return
    pid, cand = c["seen"]["pid"].numpy(), c["seen"]["pts"].numpy()   # (B, P), (B, P, 3)
    held_by = np.bincount(pid[pid >= 0], minlength=len(pt))
    assert (held_by > 1).sum() > 20, "the fixture has no overlap-shared points to test"
    assert diff[held_by <= 1].max() < 2e-3
    for m in np.nonzero(held_by > 1)[0]:
        mine = cand[pid == m]                                         # this id's candidates
        assert diff[m] < 2e-3 or np.abs(mine - pj[m]).max(axis=-1).min() < 2e-3, m
        # the port's rule: the later block's candidate is what the map holds
        assert np.array_equal(pt[m], mine[-1])


def _stacked_call(cases, names):
    mp = TMapState(*(torch.stack(xs) for xs in zip(*(cases[n]["mp"] for n in names))))
    poses = torch.stack([cases[n]["poses"] for n in names])
    hi = torch.full((len(names),), N - 1, dtype=torch.int32)
    return tglobal.refine_global(mp, poses, hi, K_T, BFX, **KW)


@pytest.mark.parametrize("names", [("exact", "near_gt"), ("near_gt", "drifted", "exact")],
                         ids=["all_healthy", "mixed"])
def test_stacked_states_equal_single_calls(cases, names):
    """One batched call, the aggressive branch taken when ANY stream needs
    it and selected per stream: each stream gets, bit for bit, what it gets
    alone (its own skipped branch's zeros and infs included)."""
    whole = _stacked_call(cases, names)
    assert whole.accepted.shape == (len(names),) and whole.ba_cost.shape == (len(names), 4)
    for i, n in enumerate(names):
        alone = cases[n]["rt"]
        assert torch.equal(whole.map.points[i], alone.map.points)
        for f in tglobal.RefineResult._fields[1:]:
            assert torch.equal(getattr(whole, f)[i], getattr(alone, f)), (n, f)


def test_refine_global_is_repeatable(cases):
    again = _stacked_call(cases, ("near_gt", "drifted", "exact"))
    first = _stacked_call(cases, ("near_gt", "drifted", "exact"))
    assert torch.equal(first.map.points, again.map.points)
    for f in tglobal.RefineResult._fields[1:]:
        assert torch.equal(getattr(first, f), getattr(again, f))


def test_extract_blocks(cases):
    c = cases["drifted"]
    hi = torch.tensor(N - 1, dtype=torch.int32)
    probs, maps = tglobal.extract_blocks(c["mp"], c["poses"], hi, 4, 7, 512, 2048)
    assert probs.T_cw.shape == (4, 7, 4, 4) and maps.slot_to_pid.shape == (4, 512)
    assert maps.frame_lo.tolist() == [0, 5, 10, 15]
    from svo_tpu_torch.ba.window import extract_window
    for b in range(4):
        one, one_map = extract_window(
            c["mp"], c["poses"], torch.tensor(6 + 5 * b, dtype=torch.int32), n_cams=7, n_points=512, n_obs=2048)
        for g, w in zip(tuple(probs) + tuple(maps), tuple(one) + tuple(one_map)):
            assert torch.equal(g[b], w)


SHARD_KW = dict(cams_per_block=7, n_points=512, n_obs=2048, ba_iterations=8, pg_iterations=8)

# one rank of refine_global_sharded, in a fresh interpreter that imports only the port
SHARDED_RANK = """
import numpy as np, torch
torch.set_num_threads(2)
from svo_tpu_torch.parallel import global_opt, multihost
from svo_tpu_torch.pipeline.state import MapState

multihost.init(f"localhost:{PORT}", WORLD, RANK, backend="gloo", timeout_s=120)
d = np.load(IN)
mp = MapState(*(torch.from_numpy(d[f]) for f in MapState._fields))
res = global_opt.refine_global_sharded(
    mp, torch.from_numpy(d["poses"]), torch.tensor(N - 1, dtype=torch.int32),
    torch.tensor(K), BFX, n_blocks=4, **KW)
np.savez(OUT.format(RANK), poses=res.poses.numpy(), points=res.map.points.numpy(),
         accepted=res.accepted.numpy(), ba_cost=res.ba_cost.numpy())
torch.distributed.destroy_process_group()
"""


def test_refine_global_sharded_over_two_ranks(tmp_path):
    """refine_global_sharded with 4 blocks of 7 cameras over 2 gloo ranks
    (2 blocks each) on svo_tpu's drifted fixture of
    test_refine_sharded_matches_vmapped: both ranks return the same bits,
    the world of one's, and these equal the port's refine_global (within
    test_global_opt.py's 1e-4 they are bit-equal). Against svo_tpu's
    refine_global_sharded on a 4-device mesh, poses are held to this file's
    1e-3 between the two packages (the port's refine_global and svo_tpu's
    differ by 1.4e-4 on this fixture at 8 iterations, as svo_tpu's two
    refiners differ by 6e-6), the ATE within 1e-3 and the verdict equal."""
    from jax.sharding import Mesh

    from torch_dist import run_code, world_of_one

    mp, poses, gt, _ = make_drifted_state(np.random.default_rng(42), n_frames=N)
    arrays = {f: np.asarray(getattr(mp, f)) for f in TMapState._fields}
    np.savez(tmp_path / "in.npz", poses=np.asarray(poses), **arrays)
    run_code(SHARDED_RANK, 2, timeout=240, IN=str(tmp_path / "in.npz"),
             OUT=str(tmp_path / "sh_{}.npz"), N=N, K=K_MAT.tolist(), BFX=BFX, KW=SHARD_KW)
    ranks = [np.load(tmp_path / f"sh_{r}.npz") for r in range(2)]
    for k in ("poses", "points", "accepted", "ba_cost"):
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])

    tm, tp, hi = _tmap(mp), torch.tensor(np.asarray(poses)), torch.tensor(N - 1, dtype=torch.int32)
    with world_of_one():
        one = tglobal.refine_global_sharded(tm, tp, hi, K_T, BFX, n_blocks=4, **SHARD_KW)
    np.testing.assert_array_equal(ranks[0]["poses"], one.poses.numpy())
    np.testing.assert_array_equal(ranks[0]["points"], one.map.points.numpy())

    ref = tglobal.refine_global(tm, tp, hi, K_T, BFX, n_blocks=4, **SHARD_KW)
    np.testing.assert_array_equal(ranks[0]["poses"], ref.poses.numpy())
    np.testing.assert_array_equal(ranks[0]["points"], ref.map.points.numpy())
    mesh = Mesh(np.array(jax.devices()[:4]), axis_names=("ba_block",))
    jsh = jglobal.refine_global_sharded(mp, poses, jnp.int32(N - 1), jnp.asarray(K_MAT),
                                        jnp.float32(BFX), mesh=mesh, **SHARD_KW)
    got, want = ranks[0]["poses"][:N], np.asarray(jsh.poses[:N])
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert abs(_ate(got, gt) - _ate(want, gt)) < 1e-3
    assert bool(ranks[0]["accepted"]) == bool(ref.accepted) == bool(jsh.accepted)
