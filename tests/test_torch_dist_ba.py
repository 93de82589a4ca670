"""The port's distributed bundle adjustment (svo_tpu_torch/parallel/ba.py,
ba/solver.py's distributed mode) against the single solve and against
svo_tpu's distributed solve on its 8 virtual CPU devices, on the problems
of tests/test_dist_ba.py.

Held: shard_problem equal to svo_tpu's bit for bit; the 8-shard solve on a
gloo world of one within test_dist_ba.py's bounds of the port's single
solve and of svo_tpu's distributed solve (cameras 5e-4, points 5e-2,
cost 1e-3 relative: shards sum the reduced camera system in another order
than one problem does), every shard carrying the same cameras and costs;
and the same shards split 2 x 4 over two ranks of a group give the 8-on-1
bits (tests/test_torch_multihost.py does it across processes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from svo_tpu.parallel import ba as jdist
from svo_tpu_torch.ba.solver import BAProblem, solve_ba
from svo_tpu_torch.parallel import ba as tdist
from test_ba import BASELINE, FX, K_MAT, make_problem
from torch_dist import world_of_one

torch.set_num_threads(2)

BFX = FX * BASELINE
K_T = torch.tensor(K_MAT)
PROBLEMS = {
    "matches_single": dict(seed=42, n_cams=6, n_pts=128, noise_px=0.3),
    "scaling_smoke": dict(seed=42, n_cams=8, n_pts=512, noise_px=0.5),
}


def _problem(seed, **kw):
    prob, T_true, _ = make_problem(np.random.default_rng(seed), **kw)
    return jax.tree.map(np.asarray, prob), T_true


@pytest.fixture(scope="module")
def world():
    with world_of_one() as group:
        yield group


@pytest.mark.parametrize("n_shards", [2, 8])
def test_shard_problem_is_svo_tpus(n_shards):
    prob, _ = _problem(**PROBLEMS["matches_single"])
    want = jax.tree.map(np.asarray, jdist.shard_problem(jax.tree.map(jnp.asarray, prob), n_shards))
    got = tdist.shard_problem(BAProblem.from_numpy(prob), n_shards)
    for f in BAProblem._fields:
        w, g = getattr(want, f), getattr(got, f).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert int(got.obs_valid.sum()) == int(prob.obs_valid.sum())  # nothing dropped
    with pytest.raises(ValueError, match="divide"):
        tdist.shard_problem(BAProblem.from_numpy(prob), 3)


@pytest.mark.parametrize("name", PROBLEMS)
def test_sharded_solve_matches_single_and_svo_tpu(world, name):
    prob, T_true = _problem(**PROBLEMS[name])
    it = 12 if name == "matches_single" else 10
    single = solve_ba(BAProblem.from_numpy(prob), K_T, BFX, iterations=it)
    sharded = tdist.shard_problem(BAProblem.from_numpy(prob), 8)
    res = tdist.solve_ba_distributed(sharded, K_T, BFX, iterations=it)
    assert res.T_cw.shape == (8, prob.T_cw.shape[0], 4, 4)
    for s in range(8):  # every shard carries the shared cameras and costs
        assert torch.equal(res.T_cw[s], res.T_cw[0])
        assert torch.equal(res.cost[s], res.cost[0]) and torch.equal(res.cost0[s], res.cost0[0])
    assert int(res.n_obs[0]) == int(single.n_obs)
    np.testing.assert_allclose(res.T_cw[0].numpy(), single.T_cw.numpy(), atol=5e-4)
    np.testing.assert_allclose(res.points.reshape(-1, 3).numpy(), single.points.numpy(), atol=5e-2)
    np.testing.assert_allclose(float(res.cost[0]), float(single.cost), rtol=1e-3)
    assert float(res.cost[0]) < float(res.cost0[0])

    mesh = jdist.make_mesh(8)
    jres = jdist.solve_ba_distributed(
        jdist.shard_problem(jax.tree.map(jnp.asarray, prob), 8), jnp.asarray(K_MAT),
        jnp.float32(BFX), mesh, iterations=it,
    )
    np.testing.assert_allclose(res.T_cw.numpy(), np.asarray(jres.T_cw), atol=5e-4)
    np.testing.assert_allclose(res.points.numpy(), np.asarray(jres.points), atol=5e-2)
    np.testing.assert_allclose(res.cost.numpy(), np.asarray(jres.cost), rtol=1e-3)
    assert int(jres.n_obs[0]) == int(res.n_obs[0])
    # and near the truth, as test_dist_ba.py asks of svo_tpu's
    T_wc = np.linalg.inv(res.T_cw[0].numpy().astype(np.float64))
    trans = np.linalg.norm(T_wc[:, :3, 3] - np.linalg.inv(T_true)[:, :3, 3], axis=-1)
    assert trans.max() < (0.05 if name == "matches_single" else 0.1)


def test_split_over_ranks_is_bit_equal(world):
    """A rank's shards are solved alike whatever their count: the terms of
    shards 0-3 and 4-7 computed as two ranks would (each its own stack)
    and folded in shard order equal the 8-shard stack's, so the solve of a
    2-rank group is the world of one's bit for bit. Checked here on the
    first LM iteration's camera system, which is all that crosses."""
    from svo_tpu_torch.parallel import collective

    prob, _ = _problem(**PROBLEMS["matches_single"])
    sharded = tdist.shard_problem(BAProblem.from_numpy(prob), 8)
    seen = []
    orig = collective.sum_over_shards

    def record(x, group=None):
        seen.append(x.clone())
        return orig(x, group)

    import svo_tpu_torch.ba.solver as tsolver

    tsolver.sum_over_shards = record
    try:
        tdist.solve_ba_distributed(sharded, K_T, BFX, iterations=1)
        whole = seen[1]  # [cost0, the camera system, the new cost, n_obs]
        seen.clear()
        for half in (slice(0, 4), slice(4, 8)):
            solve_ba(BAProblem(*(x[half] for x in sharded)), K_T, BFX, iterations=1,
                     group=dist.group.WORLD)
        halves = torch.cat([seen[1], seen[5]])
    finally:
        tsolver.sum_over_shards = orig
    assert torch.equal(halves, whole)
    assert torch.equal(collective.fold(halves), collective.fold(whole))
