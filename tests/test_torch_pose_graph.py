"""The port's pose-graph optimiser (svo_tpu_torch/ba/pose_graph.py) against
svo_tpu's on the graphs of tests/test_pose_graph.py: a consistent chain, a
drifted chain pulled back by a loop closure, zero-weight edges with a
corrupt measurement (a pi rotation, whose log is huge, and a NaN matrix),
invalid nodes. Poses within 1e-4 over the 3 iterations in which these
graphs converge (the first step takes the cost from 1.2 to ~1e-5), and
within 1e-3 after 25, when steps at the rounding floor are accepted by one
package and not the other (measured: 0.85 mm); costs 1e-3 relative, or both under 1e-4
of the initial cost (a converged graph's cost is the rounding of its
residuals, ~1e-5 here); residuals (where the edge has weight), weights
and the adjoint 1e-5. A stack of graphs gives each graph what it gets alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from svo_tpu.ba import pose_graph as jpg
from svo_tpu_torch.ba import pose_graph as tpg
from test_pose_graph import chain

torch.set_num_threads(2)


def _drifted(n, seed):
    """A chain whose estimates drift while its edges measure the TRUE
    relative motions, closed by a strong edge from node 0 to the last."""
    rng = np.random.default_rng(seed)
    T_true = chain(n)
    T_est = T_true.copy()
    for i in range(1, n):
        T_est[i, :3, 3] += np.array([0.05, 0.02, 0.0]) * i + rng.normal(0, 0.005, 3)
        T_est[i, :3, :3] = Rotation.from_euler("z", 0.004 * i).as_matrix() @ T_est[i, :3, :3]
    ei = np.arange(n - 1, dtype=np.int32)
    rel = np.linalg.inv(T_true[:-1]) @ T_true[1:]
    closure = (np.linalg.inv(T_true[0]) @ T_true[n - 1])[None]
    return jpg.PoseGraph(
        T_wc=jnp.asarray(T_est),
        node_valid=jnp.ones(n, bool),
        edge_i=jnp.asarray(np.concatenate([ei, [0]]).astype(np.int32)),
        edge_j=jnp.asarray(np.concatenate([ei + 1, [n - 1]]).astype(np.int32)),
        edge_T=jnp.asarray(np.concatenate([rel, closure]).astype(np.float32)),
        edge_w=jnp.asarray(np.concatenate([np.ones(n - 1), [5.0]]).astype(np.float32)),
    )


def _graphs():
    g = _drifted(10, 0)
    flip = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)  # a pi rotation: se3.log blows up
    dead = g._replace(
        edge_T=g.edge_T.at[3].set(jnp.asarray(flip)).at[6].set(jnp.nan),
        edge_w=g.edge_w.at[3].set(0.0).at[6].set(0.0),
    )
    invalid = g._replace(node_valid=g.node_valid.at[6].set(False))
    consistent = jpg.odometry_graph(jnp.asarray(chain(8)), jnp.ones(8, bool))
    return {"drifted": g, "dead_nan_edge": dead, "invalid_node": invalid, "consistent": consistent}


GRAPHS = _graphs()


def _close_cost(a, b, floor=1e-8):
    a, b = float(a), float(b)
    return (a < floor and b < floor) or abs(a - b) <= 1e-3 * abs(a)


@pytest.mark.parametrize("name", GRAPHS)
def test_edge_residuals_and_adjoint(name):
    gj = GRAPHS[name]
    gt = tpg.PoseGraph.from_numpy(jax.tree.map(np.asarray, gj))
    rj, wj = jpg._edge_residuals(gj.T_wc, gj)
    rt, wt = tpg._edge_residuals(gt.T_wc, gt)
    assert np.isfinite(rt.numpy()).all() and np.isfinite(np.asarray(rj)).all()
    live = (wt > 0).numpy()
    np.testing.assert_allclose(rt.numpy()[live], np.asarray(rj)[live], atol=1e-5)
    if name == "dead_nan_edge":  # the NaN edge is zeroed with its weight
        assert not rt[6].any() and not np.asarray(rj)[6].any() and float(wt[6]) == 0.0
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=0)
    np.testing.assert_allclose(
        tpg._adjoint(gt.T_wc).numpy(), np.asarray(jpg._adjoint(gj.T_wc)), atol=1e-5)
    assert _close_cost(tpg.graph_cost(gt.T_wc, gt), jnp.sum(wj * jnp.sum(rj * rj, -1)))


@pytest.mark.parametrize("iterations", [3, 25])
@pytest.mark.parametrize("name", GRAPHS)
def test_optimize_pose_graph(name, iterations):
    gj = GRAPHS[name]
    gt = tpg.PoseGraph.from_numpy(jax.tree.map(np.asarray, gj))
    a = jpg.optimize_pose_graph(gj, iterations=iterations)
    b = tpg.optimize_pose_graph(gt, iterations=iterations)
    assert _close_cost(a.cost0, b.cost0)
    assert _close_cost(a.cost, b.cost, floor=max(1e-8, 1e-4 * float(a.cost0)))
    np.testing.assert_allclose(
        b.T_wc.numpy(), np.asarray(a.T_wc), atol=1e-4 if iterations == 3 else 1e-3)
    assert torch.equal(b.T_wc[0], gt.T_wc[0])  # the anchor
    if name == "consistent":
        np.testing.assert_allclose(b.T_wc.numpy(), np.asarray(gj.T_wc), atol=1e-6)
    elif iterations == 25:
        assert float(b.cost) < 1e-2 * float(b.cost0)
    if name == "invalid_node":
        assert torch.equal(b.T_wc[6], gt.T_wc[6])


def test_odometry_graph():
    rng = np.random.default_rng(1)
    poses = chain(9)
    poses[:, :3, 3] += rng.normal(0, 0.1, (9, 3)).astype(np.float32)
    valid = np.ones(9, bool)
    valid[4] = False
    extra = (np.array([0, 2], np.int32), np.array([8, 7], np.int32),
             np.stack([np.linalg.inv(poses[0]) @ poses[8], np.linalg.inv(poses[2]) @ poses[7]]))
    for xe in (None, extra):
        gj = jpg.odometry_graph(
            jnp.asarray(poses), jnp.asarray(valid),
            None if xe is None else tuple(jnp.asarray(x) for x in xe), odom_weight=0.5)
        gt = tpg.odometry_graph(
            torch.tensor(poses), torch.tensor(valid),
            None if xe is None else tuple(torch.tensor(x) for x in xe), odom_weight=0.5)
        for name, t, j in zip(gt._fields, gt, gj):
            j = np.asarray(j)
            assert t.numpy().dtype == j.dtype and t.shape == j.shape, name
            np.testing.assert_allclose(t.numpy(), j, atol=1e-6, err_msg=name)


def test_singular_graph_does_not_raise():
    """All weights zero: every free block of the normal matrix is the
    damping floor alone; nothing moves and nothing raises."""
    g = tpg.PoseGraph.from_numpy(jax.tree.map(np.asarray, GRAPHS["drifted"]))
    g = g._replace(edge_w=torch.zeros_like(g.edge_w))
    res = tpg.optimize_pose_graph(g, iterations=3)
    assert float(res.cost0) == 0.0 and torch.equal(res.T_wc, g.T_wc)


def test_stacked_graphs_equal_single_ones():
    names = ["drifted", "dead_nan_edge", "invalid_node"]
    graphs = [tpg.PoseGraph.from_numpy(jax.tree.map(np.asarray, GRAPHS[n])) for n in names]
    stacked = tpg.PoseGraph(*(torch.stack(xs) for xs in zip(*graphs)))
    whole = tpg.optimize_pose_graph(stacked, iterations=6)
    assert whole.cost.shape == (3,)
    for i, g in enumerate(graphs):
        alone = tpg.optimize_pose_graph(g, iterations=6)
        for x, y in zip(whole, alone):
            assert torch.equal(x[i], y)
