"""Pose-graph optimisation over SE(3) relative-motion constraints.

Port of svo_tpu/ba/pose_graph.py: the cross-block layer above the block BA.
Nodes are keyframe poses, edges are relative-pose measurements (odometry
links, block-boundary constraints, loop closures), each with a scalar
information weight.

Residual per edge (i, j): r = log( Z_ij^-1 · T_i^-1 · T_j ) in se(3),
minimised by Levenberg-Marquardt with right-multiplicative twist updates
on every non-anchored node. Fixed-shape edge table (COO + mask), dense
6N x 6N solve (windows and partition boundaries are small).

Every leaf of a PoseGraph may carry the same leading axes (streams): each
leading index is its own graph. svo_tpu adds the four blocks of every edge
into an (N, N, 6, 6) table with .at[i, j].add; here the four lists of
blocks are laid end to end and summed by their (i, j) key in sorted runs
(ops/index.segment_sum), in the order svo_tpu adds them, so that the
result does not depend on the order of the card's atomics.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.geometry import se3
from vobench.reference.ops.index import segment_sum, segments, take_rows


class PoseGraph(NamedTuple):
    T_wc: torch.Tensor        # (N,4,4) node poses (camera-to-world)
    node_valid: torch.Tensor  # (N,) bool
    edge_i: torch.Tensor      # (E,) i32 source node
    edge_j: torch.Tensor      # (E,) i32 target node
    edge_T: torch.Tensor      # (E,4,4) measured T_i^-1 @ T_j
    edge_w: torch.Tensor      # (E,) f32 information weight (0 disables)

class PoseGraphResult(NamedTuple):
    T_wc: torch.Tensor
    cost0: torch.Tensor
    cost: torch.Tensor


def _edge_residuals(T_wc, graph: PoseGraph):
    """(..., E, 6) residuals and the (..., E) validity weights.

    Non-finite residuals (se3.log blows up near a pi rotation, which a
    degenerate measurement on a ZERO-WEIGHT edge can legitimately produce)
    are zeroed with their weight: otherwise w * r^2 yields 0 * nan = nan
    and one dead edge poisons the whole graph cost."""
    Ti = take_rows(T_wc, graph.edge_i)
    Tj = take_rows(T_wc, graph.edge_j)
    pred = se3.compose(se3.inverse(Ti), Tj)
    err = se3.compose(se3.inverse(graph.edge_T), pred)
    r = se3.log(err)
    valid = graph.node_valid.to(graph.edge_w.dtype)
    w = graph.edge_w * torch.gather(valid, -1, graph.edge_i.long())
    w = w * torch.gather(valid, -1, graph.edge_j.long())
    finite = torch.all(torch.isfinite(r), dim=-1)
    w = w * finite.to(w.dtype)
    r = torch.where(finite[..., None], r, 0.0)
    return r, w


def graph_cost(T_wc, graph: PoseGraph) -> torch.Tensor:
    """The weighted squared edge residuals of `graph` at the node poses T_wc."""
    r, w = _edge_residuals(T_wc, graph)
    return torch.sum(w * torch.sum(r * r, dim=-1), dim=-1)


def _adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint for twist order [v, w]: Adj = [[R, [t]x R], [0, R]]."""
    R = se3.rotation(T)
    tx = se3.hat(se3.translation(T))
    top = torch.cat([R, tx @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def optimize_pose_graph(
    graph: PoseGraph,
    iterations: int = 10,
    n_fixed: int = 1,
    init_lambda: float = 1e-3,
) -> PoseGraphResult:
    """Levenberg-Marquardt on the pose graph. The first n_fixed nodes are
    anchored.

    Linearisation (right-multiplicative updates T <- T exp(delta), residual
    r = log(Z^-1 Ti^-1 Tj)): r_new ~ r + J_j dj + J_i di with J_j ~ I and
    J_i = -Adj(Tj^-1 Ti). The block-sparse normal system is assembled into
    an (N, N, 6, 6) table and solved dense. A singular system moves nothing
    (solve_ex returns inf/NaN without raising; the step is zeroed).

    Damping is adaptive (multiplicative on the diagonal, halved on accepted
    steps, grown 8x on rejections): a chain graph's normal matrix has weak
    long-lever modes along which a pure GN step overshoots far outside the
    linearisation basin."""
    lead = tuple(graph.node_valid.shape[:-1])
    g = PoseGraph(*(x.reshape((-1,) + x.shape[len(lead):]) for x in graph))
    B, N = g.node_valid.shape
    f32, dev = g.T_wc.dtype, g.T_wc.device
    fixed = (torch.arange(N, device=dev) < n_fixed) | ~g.node_valid   # (B,N)
    fixed6 = fixed.repeat_interleave(6, dim=-1)
    fixed66 = fixed6[:, :, None] | fixed6[:, None, :]
    ei, ej = g.edge_i.long(), g.edge_j.long()
    # the four block lists of svo_tpu's four .add calls, in that order
    seg_H = segments(torch.cat([ei * N + ei, ej * N + ej, ei * N + ej, ej * N + ei], dim=-1), N * N)
    seg_b = segments(torch.cat([ei, ej], dim=-1), N)
    eye6 = torch.eye(6, dtype=f32, device=dev)

    T = g.T_wc
    cost0 = cost = graph_cost(T, g)
    lam = torch.full((B,), init_lambda, dtype=f32, device=dev)
    for _ in range(iterations):
        r, w = _edge_residuals(T, g)                                  # (B,E,6), (B,E)
        Ti, Tj = take_rows(T, g.edge_i), take_rows(T, g.edge_j)
        Ji = -_adjoint(se3.compose(se3.inverse(Tj), Ti))              # (B,E,6,6); J_j = I
        wJi = Ji * w[..., None, None]
        Hij = wJi.mT
        H = segment_sum(
            torch.cat([Ji.mT @ wJi, eye6 * w[..., None, None], Hij, Hij.mT], dim=1), seg_H
        ).reshape(B, N, N, 6, 6)
        b = segment_sum(
            torch.cat([(wJi.mT @ r[..., None])[..., 0], w[..., None] * r], dim=1), seg_b
        )

        # gauge + adaptive damping, flatten to (6N, 6N)
        Hf = H.permute(0, 1, 3, 2, 4).reshape(B, N * 6, N * 6)
        Hf = torch.where(fixed66, 0.0, Hf)
        diag = Hf.diagonal(dim1=-2, dim2=-1)
        Hf = Hf + torch.diag_embed(torch.where(fixed6, 1.0, lam[:, None] * (diag + 1e-8) + 1e-9))
        bf = torch.where(fixed6, 0.0, b.reshape(B, N * 6))
        delta = -torch.linalg.solve_ex(Hf, bf[..., None], check_errors=False)[0].reshape(B, N, 6)
        finite = torch.isfinite(delta).flatten(1).all(dim=-1)
        delta = torch.where(finite[:, None, None], delta, 0.0)

        T_new = se3.compose(T, se3.exp(delta))
        T_new = torch.where(fixed[..., None, None], T, T_new)
        cost_new = graph_cost(T_new, g)
        accept = torch.isfinite(cost_new) & (cost_new <= cost)
        T = torch.where(accept[:, None, None, None], T_new, T)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.where(accept, lam * 0.5, lam * 8.0)
    return PoseGraphResult(
        T_wc=T.reshape(lead + T.shape[1:]), cost0=cost0.reshape(lead), cost=cost.reshape(lead)
    )

