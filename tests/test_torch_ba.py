"""The port's bundle adjustment (svo_tpu_torch/ba/solver.py) against
svo_tpu's on the same seeded problems (the generator of tests/test_ba.py).

Tolerances: residuals, Jacobians, weights and the initial cost 1e-5
relative; the final cost 1e-3 relative; cameras 1e-4 absolute; points 1e-3
absolute after refine_alternate, and after solve_ba 1e-4 of their
distance from the origin (1 mm at 10 m: a point's depth is determined as
1/z, so what rounding leaves open grows with its distance). XLA and
PyTorch add the f32 sums in other orders, so late in a converged solve an
LM step at the accept edge can fall the other way and weakly constrained
points (far, few observations) then differ by millimetres at the same
cost: poses, points and costs are held after the 4 iterations in which
the solve converges, and after 10 iterations the cost and the cameras at
the same bounds with 98% of the points at 1e-3 of their distance (a point
whose observations all lie past the reject threshold has a flat cost and
stays where the last accepted step left it: 18 cm apart in the outlier
problem). The per-iteration damping is not held. Decisions that do not depend on
rounding are held exactly: n_obs, a fixed camera bit-equal to its input, a
problem with a NaN measurement returned as it came.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_tpu.ba import solver as jsolver
from svo_tpu.ops import linalg as jlinalg
from svo_tpu_torch.ba import solver as tsolver
from svo_tpu_torch.ops import index as tindex
from svo_tpu_torch.ops import linalg as tlinalg
from test_ba import BASELINE, FX, K_MAT, make_problem

torch.set_num_threads(2)

BFX = FX * BASELINE
K_J, K_T = jnp.asarray(K_MAT), torch.tensor(K_MAT)


def _pair(seed, outliers=False, **kw):
    """One seeded problem as svo_tpu's tuple and as the port's."""
    rng = np.random.default_rng(seed)
    prob, _, _ = make_problem(rng, **kw)
    if outliers:
        uv = np.asarray(prob.obs_uv).copy()
        valid = np.nonzero(np.asarray(prob.obs_valid))[0]
        idx = rng.choice(valid, len(valid) // 10, replace=False)
        uv[idx, :2] += rng.uniform(40, 120, (len(idx), 2)).astype(np.float32)
        prob = prob._replace(obs_uv=jnp.asarray(uv))
    return prob, tsolver.BAProblem.from_numpy(jax.tree.map(np.asarray, prob))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _absdiff(a, b):
    return float(np.abs(np.asarray(a) - b.numpy()).max())


PROBLEMS = {
    "perturbed": dict(seed=0, noise_px=0.5),
    "noisy": dict(seed=1, noise_px=1.0, drop_frac=0.2),
    "outliers": dict(seed=2, noise_px=0.3, outliers=True),
}


@pytest.mark.parametrize("name", PROBLEMS)
def test_residuals_and_weights(name):
    pj, pt = _pair(**PROBLEMS[name])
    rj = jsolver._residuals(K_J, jnp.float32(BFX), pj.T_cw, pj.points, pj.obs_cam, pj.obs_pnt, pj.obs_uv)
    rt = tsolver._residuals(K_T, BFX, pt.T_cw, pt.points, pt.obs_cam, pt.obs_pnt, pt.obs_uv)
    for a, b in zip(rj, rt):
        assert _rel(a, b.numpy()) < 1e-5
    wj, cj = jsolver._robust_weights(rj[0], pj.obs_valid, 5.0, 20.0)
    wt, ct = tsolver._robust_weights(rt[0], pt.obs_valid, 5.0, 20.0)
    assert _rel(wj, wt.numpy()) < 1e-5 and _rel(cj, ct.numpy()) < 1e-5
    assert int((np.asarray(wj) == 0).sum()) == int((wt == 0).sum())


@pytest.mark.parametrize("iterations,pts_tol", [(4, 1e-4), (10, 1e-3)])
@pytest.mark.parametrize("name", PROBLEMS)
def test_solve_ba(name, iterations, pts_tol):
    pj, pt = _pair(**PROBLEMS[name])
    a = jsolver.solve_ba(pj, K_J, jnp.float32(BFX), iterations=iterations)
    b = tsolver.solve_ba(pt, K_T, BFX, iterations=iterations)
    assert int(a.n_obs) == int(b.n_obs)
    assert _rel(a.cost0, b.cost0.numpy()) < 1e-5
    assert _rel(a.cost, b.cost.numpy()) < 1e-3
    assert float(b.cost) < 0.5 * float(b.cost0)
    assert _absdiff(a.T_cw, b.T_cw) < 1e-4
    dist = np.linalg.norm(np.asarray(a.points), axis=-1, keepdims=True)
    err = (np.abs(np.asarray(a.points) - b.points.numpy()) / dist).max(axis=-1)
    assert float(err.max() if iterations == 4 else np.quantile(err, 0.98)) < pts_tol


@pytest.mark.parametrize("points_only", [True, False])
@pytest.mark.parametrize("name", PROBLEMS)
def test_refine_alternate(name, points_only):
    pj, pt = _pair(**PROBLEMS[name])
    a = jsolver.refine_alternate(pj, K_J, jnp.float32(BFX), rounds=6, points_only=points_only)
    b = tsolver.refine_alternate(pt, K_T, BFX, rounds=6, points_only=points_only)
    assert int(a.n_obs) == int(b.n_obs)
    assert _rel(a.cost0, b.cost0.numpy()) < 1e-5
    assert _rel(a.cost, b.cost.numpy()) < 1e-3
    assert float(b.cost) < float(b.cost0)
    assert _absdiff(a.T_cw, b.T_cw) < 1e-4
    assert _absdiff(a.points, b.points) < 1e-3
    if points_only:
        assert torch.equal(b.T_cw, pt.T_cw)


def test_polish_gate_by_observation_span():
    """max_polish_span freezes the points seen across many cameras (the
    scatter-min / scatter-max of the first and last observing camera)."""
    pj, pt = _pair(seed=3, n_cams=6, noise_px=0.5)
    a = jsolver.refine_alternate(pj, K_J, jnp.float32(BFX), rounds=3, max_polish_span=2, points_only=True)
    b = tsolver.refine_alternate(pt, K_T, BFX, rounds=3, max_polish_span=2, points_only=True)
    moved_j = np.any(np.asarray(a.points) != np.asarray(pj.points), axis=-1)
    moved_t = torch.any(b.points != pt.points, dim=-1).numpy()
    assert 0 < moved_t.sum() < len(moved_t)
    assert np.array_equal(moved_j, moved_t)
    assert _absdiff(a.points, b.points) < 1e-3


def test_fixed_camera_is_bit_equal_to_its_input():
    pj, pt = _pair(seed=4)
    b = tsolver.solve_ba(pt, K_T, BFX, iterations=5, n_fixed=2)
    assert torch.equal(b.T_cw[:2], pt.T_cw[:2])
    assert not torch.equal(b.T_cw[2:], pt.T_cw[2:])
    a = jsolver.solve_ba(pj, K_J, jnp.float32(BFX), iterations=5, n_fixed=2)
    assert _absdiff(a.T_cw, b.T_cw) < 1e-4


def test_non_finite_system_returns_the_input():
    """A NaN measurement on a valid row makes every sum, the reduced system
    and the cost non-finite. svo_tpu's solve then returns inf/NaN and its
    guard zeroes the step; torch.linalg.solve would raise (and sync), so the
    port solves with solve_ex: no exception, and the input comes back."""
    pj, pt = _pair(seed=5)
    uv = pt.obs_uv.clone()
    uv[int(torch.nonzero(pt.obs_valid)[0]), 0] = torch.nan
    pt = pt._replace(obs_uv=uv)
    pj = pj._replace(obs_uv=jnp.asarray(uv.numpy()))
    for fn_j, fn_t in ((jsolver.solve_ba, tsolver.solve_ba),
                       (jsolver.refine_alternate, tsolver.refine_alternate)):
        a, b = fn_j(pj, K_J, jnp.float32(BFX)), fn_t(pt, K_T, BFX)
        assert torch.equal(b.T_cw, pt.T_cw) and torch.equal(b.points, pt.points)
        assert np.array_equal(np.asarray(a.T_cw), pt.T_cw.numpy())
        assert not np.isfinite(float(b.cost)) and not np.isfinite(float(a.cost))


@pytest.mark.parametrize("n", [3, 6])
def test_solve_spd(n):
    rng = np.random.default_rng(n)
    lead = (5,) if n == 3 else ()  # jnp.linalg.solve takes a stack of vectors only as (..., n, 1)
    M = rng.normal(size=lead + (n, n)).astype(np.float32)
    A = M @ np.swapaxes(M, -1, -2) + np.eye(n, dtype=np.float32)
    b = rng.normal(size=lead + (n,)).astype(np.float32)
    for damp in (0.0, 0.5):
        want = np.asarray(jlinalg.solve_spd(jnp.asarray(A), jnp.asarray(b), damp))
        got = tlinalg.solve_spd(torch.tensor(A), torch.tensor(b), damp).numpy()
        assert _rel(want, got) < 1e-5
    singular = tlinalg.solve_spd(torch.zeros(2, n, n), torch.ones(2, n))  # must not raise
    assert singular.shape == (2, n)
    if n != 3:  # the closed form clamps its determinant instead
        assert not torch.isfinite(singular).all()


def test_stacked_problems_equal_single_solves():
    """Leading axes: a (2, 2) stack of four different problems of one shape
    gives each problem, bit for bit, what it gets alone."""
    probs = [_pair(seed=10 + i, n_pts=80)[1] for i in range(4)]
    O = max(p.obs_cam.shape[0] for p in probs)

    def pad(p):
        k = O - p.obs_cam.shape[0]
        return p._replace(
            obs_cam=torch.nn.functional.pad(p.obs_cam, (0, k)),
            obs_pnt=torch.nn.functional.pad(p.obs_pnt, (0, k)),
            obs_uv=torch.nn.functional.pad(p.obs_uv, (0, 0, 0, k)),
            obs_valid=torch.nn.functional.pad(p.obs_valid, (0, k)),
        )

    probs = [pad(p) for p in probs]
    stacked = tsolver.BAProblem(*(torch.stack(xs).reshape((2, 2) + xs[0].shape) for xs in zip(*probs)))
    for fn, kw in ((tsolver.solve_ba, dict(iterations=4)),
                   (tsolver.refine_alternate, dict(rounds=3)),
                   (tsolver.refine_alternate, dict(rounds=3, points_only=True))):
        whole = fn(stacked, K_T, BFX, **kw)
        assert whole.cost.shape == (2, 2) and whole.T_cw.shape[:2] == (2, 2)
        for i, p in enumerate(probs):
            alone = fn(p, K_T, BFX, **kw)
            for x, y in zip(whole, alone):
                assert torch.equal(x[i // 2, i % 2], y)


def test_distributed_mode_with_one_shard_is_the_single_solve():
    """solve_ba(group=...) on a gloo world of one holding the whole problem
    as one shard adds nothing across shards: it is the single solve bit
    for bit (tests/test_torch_dist_ba.py holds 8 shards). It takes exactly
    one leading axis of shards."""
    from torch_dist import world_of_one

    _, pt = _pair(seed=0)
    alone = tsolver.solve_ba(pt, K_T, BFX, iterations=6)
    with world_of_one() as group:
        sharded = tsolver.solve_ba(tsolver.BAProblem(*(x[None] for x in pt)), K_T, BFX,
                                   iterations=6, group=group)
        with pytest.raises(ValueError, match="one leading axis"):
            tsolver.solve_ba(pt, K_T, BFX, group=group)
    for x, y in zip(sharded, alone):
        assert torch.equal(x[0], y)


def test_segment_sum():
    """Sums over sorted runs equal index_add_ (to rounding: another order),
    empty segments are zero, every leading index has its own segments, and
    a second call gives the same bits."""
    rng = np.random.default_rng(0)
    keys = torch.tensor(rng.integers(0, 7, (3, 2, 500)).astype(np.int32))
    keys[keys == 4] = 5  # segment 4 stays empty
    vals = torch.tensor(rng.normal(size=(3, 2, 500, 4, 2)).astype(np.float32))
    seg = tindex.segments(keys, 7)
    got = tindex.segment_sum(vals, seg)
    assert got.shape == (3, 2, 7, 4, 2)
    want = torch.zeros(3, 2, 7, 4, 2, dtype=torch.float64)
    for i in range(3):
        for j in range(2):
            want[i, j].index_add_(0, keys[i, j].long(), vals[i, j].double())
    assert float((got.double() - want).abs().max()) < 1e-4
    assert not got[:, :, 4].any()
    assert torch.equal(got, tindex.segment_sum(vals, tindex.segments(keys, 7)))
    # a run is added front to back in the rows' own order
    first = torch.zeros(7, 4, 2)
    for o in range(500):
        first[int(keys[0, 0, o])] += vals[0, 0, o]
    assert torch.equal(got[0, 0], first)
