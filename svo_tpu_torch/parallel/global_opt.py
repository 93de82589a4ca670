"""Global refinement driven from LIVE pipeline state: keyframe-block
partitioned BA + pose-graph consensus across block boundaries.

Port of svo_tpu/parallel/global_opt.py. The trailing span of the trajectory
is partitioned into contiguous keyframe blocks, per-block windowed BA runs
independently, and a pose graph over the union of block cameras reconciles
the solutions.

Block geometry: consecutive blocks OVERLAP BY TWO frames (stride = C-2).
Each block's first camera is its BA gauge anchor and keeps whatever
absolute drift the trajectory had, so the relative edge (anchor -> cam1)
measured from the block solution is contaminated by that drift, while edges
between two FREE cameras are clean. The two-frame overlap guarantees that
every consecutive-frame pair is covered by at least one clean edge, letting
the graph drop every non-first block's anchor edge.

Leading axes: the state may carry a leading (S,) of streams on every leaf
(frame_hi then is (S,)); blocks ride a second axis behind it. Streams and
blocks share every launch; nothing loops over them. svo_tpu maps its
refiner over the streams with lax.map so that a healthy stream skips the
aggressive branch under its lax.cond; here the conservative candidate is
computed for all streams at once, `aggressive.any()` is read on the host
ONCE per sweep, and the aggressive branch runs (for all streams, selected
per stream afterwards) only when some stream needs it. Each stream gets
what lax.map gives it, the zeros in ba_cost* / pg_cost* and the inf in the
aggressive span costs of a healthy stream included.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from svo_tpu_torch.ba.pose_graph import PoseGraph, graph_cost, optimize_pose_graph
from svo_tpu_torch.ba.solver import BAProblem, BAResult, refine_alternate, solve_ba
from svo_tpu_torch.ba.window import WindowMapping, extract_window, write_back
from svo_tpu_torch.geometry import se3
from svo_tpu_torch.ops.index import scatter_drop, take_rows
from svo_tpu_torch.parallel.collective import gather_rows
from svo_tpu_torch.pipeline.state import MapState


class RefineResult(NamedTuple):
    map: MapState
    poses: torch.Tensor       # (F,4,4) updated trajectory
    frame_lo: torch.Tensor    # first frame refined
    ba_cost0: torch.Tensor    # (B,) per-block initial robust cost
    ba_cost: torch.Tensor     # (B,) per-block final robust cost
    pg_cost0: torch.Tensor    # pose-graph cost before consensus
    pg_cost: torch.Tensor     # pose-graph cost after consensus
    accepted: torch.Tensor    # bool, the span-wide cost gate's verdict
    span_cost0: torch.Tensor  # span reprojection cost before refinement
    span_cost: torch.Tensor   # span reprojection cost of the refined state
    cost_per_obs: torch.Tensor  # mean initial robust cost per valid observation


def block_span(n_blocks: int, cams_per_block: int) -> int:
    """Frames covered by n_blocks blocks overlapping by two frames."""
    return (n_blocks - 1) * (cams_per_block - 2) + cams_per_block


def extract_blocks(
    mp: MapState,
    poses_wc: torch.Tensor,
    frame_hi: torch.Tensor,
    n_blocks: int,
    cams_per_block: int,
    n_points: int,
    n_obs: int,
) -> tuple[BAProblem, WindowMapping]:
    """Partition the trailing trajectory window into B keyframe blocks.

    Block b covers frames [hi_b - cams_per_block + 1, hi_b] with
    hi_b = frame_hi - (B-1-b)*(cams_per_block-2): consecutive blocks share
    two boundary frames. The windowed extraction runs once over a block
    axis placed behind frame_hi's own axes; the map and the trajectory are
    broadcast along it as views."""
    stride = cams_per_block - 2
    back = stride * torch.arange(
        n_blocks - 1, -1, -1, dtype=frame_hi.dtype, device=frame_hi.device
    )
    nl = frame_hi.dim()

    def per_block(x):
        return x.unsqueeze(nl).expand(x.shape[:nl] + (n_blocks,) + x.shape[nl:])

    return extract_window(
        MapState(*(per_block(x) for x in mp)), per_block(poses_wc), frame_hi[..., None] - back,
        n_cams=cams_per_block, n_points=n_points, n_obs=n_obs,
    )


def refine_global(
    mp: MapState,
    poses_wc: torch.Tensor,
    frame_hi: torch.Tensor,
    K_mat: torch.Tensor,
    baseline_fx,
    n_blocks: int = 4,
    cams_per_block: int = 7,
    n_points: int = 512,
    n_obs: int = 2048,
    ba_iterations: int = 12,
    pg_iterations: int = 10,
    huber_delta: float = 5.0,
    reject_threshold: float = 100.0,
    recover_cost_per_obs: float = 10.0,
    alt_points_only: bool = True,
) -> RefineResult:
    """Two-regime global refinement on the live state.

    CONSERVATIVE regime (the default, when the span is self-consistent: mean
    initial robust cost per observation <= recover_cost_per_obs): points-only
    alternation over the WHOLE span (ba.solver.refine_alternate) against the
    unmoved shipped poses, accepted only on a >= 10% relative span-cost
    improvement, so that marginal polish of an already-good span is a no-op
    and not a noise-floor perturbation of future PnP. Poses never move.

    AGGRESSIVE regime (localisation failure: large reprojection errors
    against the span's own map): keyframe-block partitioned BA + chained
    re-init + pose-graph consensus, which can rebuild a heavily drifted span
    that local descent cannot reach. It is skipped when no stream needs it
    (one host read per call, see the module docstring).

    reject_threshold defaults WIDER than the in-pipeline window BA (100 px
    against 20): recovery runs on broken spans whose reprojection errors
    legitimately exceed the online outlier cutoff. The conservative path
    uses the tighter min(reject, 20)."""
    if frame_hi.dim() == 0:
        # one stream is a stack of one: the same batched products, so that a
        # stream gets the same bits alone and in a stack (a 2-D matmul and a
        # batched one may add in different orders)
        res = refine_global(
            MapState(*(x[None] for x in mp)), poses_wc[None], frame_hi[None], K_mat, baseline_fx,
            n_blocks, cams_per_block, n_points, n_obs, ba_iterations, pg_iterations,
            huber_delta, reject_threshold, recover_cost_per_obs, alt_points_only,
        )
        return RefineResult(MapState(*(x[0] for x in res.map)), *(x[0] for x in res[1:]))
    frame_lo = frame_hi - (block_span(n_blocks, cams_per_block) - 1)
    span_cost, cons_points, aggressive, cost_per_obs = _conservative(
        mp, poses_wc, frame_hi, K_mat, baseline_fx, n_blocks, cams_per_block, n_points, n_obs,
        ba_iterations, huber_delta, reject_threshold, recover_cost_per_obs, alt_points_only,
    )

    # --- aggressive candidate: block BA + consensus, skipped when every
    #     span is healthy ---
    zero = torch.zeros_like(cost_per_obs)
    zero_b = torch.zeros(tuple(frame_hi.shape) + (n_blocks,), dtype=zero.dtype, device=zero.device)
    agg = (None, None, zero_b, zero_b, zero, zero)
    if bool(aggressive.any()):
        problems, mappings = extract_blocks(
            mp, poses_wc, frame_hi, n_blocks, cams_per_block, n_points, n_obs
        )
        res = solve_ba(
            problems, K_mat, baseline_fx,
            iterations=ba_iterations, n_fixed=1, huber_delta=huber_delta,
            reject_threshold=reject_threshold,
        )
        agg_mp, agg_poses, _, pg = _consensus_and_writeback(
            mp, poses_wc, frame_hi, problems, mappings, res,
            n_blocks, cams_per_block, pg_iterations,
        )
        # a healthy stream keeps what svo_tpu's skipped branch returns
        agg = (
            torch.where(aggressive[..., None, None], agg_mp.points, mp.points),
            torch.where(aggressive[..., None, None, None], agg_poses, poses_wc),
            torch.where(aggressive[..., None], res.cost0, zero_b),
            torch.where(aggressive[..., None], res.cost, zero_b),
            torch.where(aggressive, pg.cost0, zero),
            torch.where(aggressive, pg.cost, zero),
        )
    return _gated_result(
        mp, poses_wc, frame_lo, span_cost, cons_points, aggressive, cost_per_obs, *agg
    )


def refine_global_sharded(
    mp: MapState,
    poses_wc: torch.Tensor,
    frame_hi: torch.Tensor,
    K_mat: torch.Tensor,
    baseline_fx,
    group=None,
    n_blocks: int | None = None,
    cams_per_block: int = 7,
    n_points: int = 512,
    n_obs: int = 2048,
    ba_iterations: int = 12,
    pg_iterations: int = 10,
    huber_delta: float = 5.0,
    reject_threshold: float = 100.0,
    recover_cost_per_obs: float = 10.0,
) -> RefineResult:
    """The process-group variant: the keyframe blocks' BA is split over the
    ranks of `group` (None: the default world), contiguous blocks per rank
    in rank order; n_blocks defaults to one block per rank, as svo_tpu's
    one block per device. The blocks' BAResults are gathered in block order
    (parallel/collective.py). The conservative full-span alternation (points
    only), the pose-graph consensus, the write-back and the gate run alike
    on every rank, so every rank returns the same result. As in svo_tpu,
    the block BA runs whatever the regime; the gate (_gated_result) is
    refine_global's."""
    if frame_hi.dim() == 0:
        res = refine_global_sharded(
            MapState(*(x[None] for x in mp)), poses_wc[None], frame_hi[None], K_mat, baseline_fx,
            group, n_blocks, cams_per_block, n_points, n_obs, ba_iterations, pg_iterations,
            huber_delta, reject_threshold, recover_cost_per_obs,
        )
        return RefineResult(MapState(*(x[0] for x in res.map)), *(x[0] for x in res[1:]))
    group = dist.group.WORLD if group is None else group
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    n_blocks = world if n_blocks is None else n_blocks
    if n_blocks % world:
        raise ValueError(f"{n_blocks} blocks do not split evenly over {world} ranks")
    C = cams_per_block
    frame_lo = frame_hi - (block_span(n_blocks, C) - 1)
    span_cost, cons_points, aggressive, cost_per_obs = _conservative(
        mp, poses_wc, frame_hi, K_mat, baseline_fx, n_blocks, C, n_points, n_obs,
        ba_iterations, huber_delta, reject_threshold, recover_cost_per_obs, True,
    )

    # this rank's blocks, solved here; every block's result, in block order
    problems, mappings = extract_blocks(mp, poses_wc, frame_hi, n_blocks, C, n_points, n_obs)
    bd = frame_hi.dim()  # the block axis
    per = n_blocks // world
    mine = BAProblem(*(x.narrow(bd, rank * per, per) for x in problems))
    res = solve_ba(
        mine, K_mat, baseline_fx, iterations=ba_iterations, n_fixed=1,
        huber_delta=huber_delta, reject_threshold=reject_threshold,
    )
    res = BAResult(*(gather_rows(x.movedim(bd, 0), group).movedim(0, bd) for x in res))
    agg_mp, agg_poses, _, pg = _consensus_and_writeback(
        mp, poses_wc, frame_hi, problems, mappings, res, n_blocks, C, pg_iterations,
    )
    return _gated_result(
        mp, poses_wc, frame_lo, span_cost, cons_points, aggressive, cost_per_obs,
        agg_mp.points, agg_poses, res.cost0, res.cost, pg.cost0, pg.cost,
    )


def _conservative(
    mp, poses_wc, frame_hi, K_mat, baseline_fx, n_blocks, cams_per_block, n_points, n_obs,
    ba_iterations, huber_delta, reject_threshold, recover_cost_per_obs, points_only,
):
    """The conservative candidate over the whole span (a points-only or
    joint alternation against the shipped poses, written back where it did
    not raise the cost) and the regime of each stream. Returns the span's
    pricing function span_cost(points, poses), the candidate's map points,
    `aggressive` and the mean initial cost per observation."""
    full_prob, full_map = extract_window(
        mp, poses_wc, frame_hi, n_cams=block_span(n_blocks, cams_per_block),
        n_points=n_points * n_blocks, n_obs=n_obs * n_blocks,
    )
    alt = refine_alternate(
        full_prob, K_mat, baseline_fx, rounds=ba_iterations // 2 + 2,
        n_fixed=1, huber_delta=huber_delta,
        reject_threshold=min(reject_threshold, 20.0),
        points_only=points_only,
    )
    alt_ok = torch.isfinite(alt.cost) & (alt.cost <= alt.cost0)
    cons_mp, _ = write_back(
        mp, poses_wc, full_map, full_prob.T_cw,
        torch.where(alt_ok[..., None, None], alt.points, full_prob.points),
        full_prob.pnt_valid, full_prob.cam_valid,
    )

    def span_cost(points, poses):
        return _span_cost(
            full_prob, full_map, points, poses, K_mat, baseline_fx, huber_delta, reject_threshold
        )

    # --- regime selection: is the span consistent with its own map? ---
    n_obs_f = torch.clamp(alt.n_obs, min=1).to(alt.cost0.dtype)
    return span_cost, cons_mp.points, alt.cost0 > recover_cost_per_obs * n_obs_f, alt.cost0 / n_obs_f


def _gated_result(
    mp, poses_wc, frame_lo, span_cost, cons_points, aggressive, cost_per_obs,
    agg_points, agg_poses, ba_cost0, ba_cost, pg_cost0, pg_cost, cons_margin: float = 0.9,
) -> RefineResult:
    """The acceptance gate shared by refine_global and
    refine_global_sharded. span_cost(points, poses) prices a candidate over
    the refined span; agg_points is None where no aggressive candidate was
    computed.

    AGGRESSIVE regime: both span-cost checks must pass: (a) the BA
    objective must not regress, cost(agg poses, agg points) <= cost(orig);
    (b) the anti-gauge-slide check, cost(agg poses, ORIGINAL points) <=
    2 x cost(orig). A block re-solve can transport poses and points
    coherently along weakly observable modes, the cost staying low while
    the trajectory walks away from truth; scoring the candidate poses
    against the unmoved map breaks that coherence.

    CONSERVATIVE regime: the points-only polish applies iff it improves the
    span cost by a real margin (>= 1 - cons_margin relative): a polish
    within the noise floor is a no-op, not a perturbation of future PnP.
    Poses never move in this regime."""
    cost0 = span_cost(mp.points, poses_wc)
    cost_pp = span_cost(cons_points, poses_wc)
    inf = torch.full_like(cost0, torch.inf)
    if agg_points is None:
        agg_points, agg_poses = mp.points, poses_wc
        cost1 = cost1b = inf
    else:
        cost1 = torch.where(aggressive, span_cost(agg_points, agg_poses), inf)
        cost1b = torch.where(aggressive, span_cost(mp.points, agg_poses), inf)
    joint = (
        torch.isfinite(cost1) & (cost1 <= cost0)
        & torch.isfinite(cost1b) & (cost1b <= 2.0 * cost0)
    )
    acc_cons = torch.isfinite(cost_pp) & (cost_pp <= cons_margin * cost0)
    acc_pts = torch.where(aggressive, joint, acc_cons)
    acc_pose = aggressive & joint

    cand_points = torch.where(aggressive[..., None, None], agg_points, cons_points)
    return RefineResult(
        map=mp._replace(points=torch.where(acc_pts[..., None, None], cand_points, mp.points)),
        poses=torch.where(acc_pose[..., None, None, None], agg_poses, poses_wc),
        frame_lo=frame_lo,
        ba_cost0=ba_cost0,
        ba_cost=ba_cost,
        pg_cost0=pg_cost0,
        pg_cost=pg_cost,
        accepted=acc_pts | acc_pose,
        span_cost0=cost0,
        span_cost=torch.where(aggressive, cost1, cost_pp),
        cost_per_obs=cost_per_obs,
    )


def _span_cost(
    prob: BAProblem, mapping: WindowMapping, points, poses_wc, K_mat, baseline_fx,
    huber_delta, reject_threshold,
):
    """Robust reprojection cost of (poses, points) over the whole refined
    span's observations: the BA objective itself, the acceptance metric of a
    sweep. svo_tpu extracts the span's window anew for every candidate; the
    observation rows and the slot tables depend on the ring and on frame_hi
    alone, so here the one extracted problem is re-read with the candidate's
    cameras and points: the same numbers for a fifth of the launches."""
    n_cams = prob.T_cw.shape[-3]
    cam_ids = mapping.frame_lo[..., None] + torch.arange(
        n_cams, dtype=torch.int32, device=points.device
    )
    T_wc = take_rows(poses_wc, cam_ids.clamp(0, poses_wc.shape[-3] - 1))
    pts = take_rows(points, mapping.slot_to_pid.clamp(min=0)) * prob.pnt_valid[..., None]
    return solve_ba(
        prob._replace(T_cw=se3.inverse(T_wc), points=pts), K_mat, baseline_fx, iterations=0,
        huber_delta=huber_delta, reject_threshold=reject_threshold,
    ).cost0


def _write_block_points(points, pid, pts_corr):
    """The blocks' corrected points (..., B, P, 3) into the map at their
    global ids pid (..., B, P; -1 where a slot holds none). Two overlapping
    blocks may both hold a point, and svo_tpu's one scatter leaves the
    winner to XLA. The rule here: the LATER block wins. Blocks are written
    one after the other, each with ids that do not repeat, so the outcome
    is the same on every run and device."""
    for b in range(pid.shape[-2]):
        points = scatter_drop(points, pid[..., b, :], pts_corr[..., b, :, :])
    return points


def _consensus_and_writeback(
    mp, poses_wc, frame_hi, problems, mappings, res,
    n_blocks, cams_per_block, pg_iterations,
):
    B, C = n_blocks, cams_per_block
    stride = C - 2
    n_nodes = block_span(B, C)
    dev = poses_wc.device
    lead = tuple(frame_hi.shape)
    frame_lo = frame_hi - (n_nodes - 1)

    improved = res.cost <= res.cost0
    T_cw_blk = torch.where(improved[..., None, None, None], res.T_cw, problems.T_cw)
    pts_blk = torch.where(improved[..., None, None], res.points, problems.points)
    T_wc_blk = se3.inverse(T_cw_blk)                        # (..., B, C, 4, 4)

    # --- pose graph over the union of block cameras ---
    # node k = frame frame_lo + k; block b camera i -> node b*stride + i.
    # Edges: consecutive-camera relative poses measured from each block's
    # optimised solution. Anchor edges (i = 0) of non-first blocks are
    # contaminated by the anchor's absolute drift and get weight 0; the
    # two-frame overlap means the previous block supplies a clean edge for
    # that same frame pair.
    node_frames = frame_lo[..., None] + torch.arange(n_nodes, dtype=torch.int32, device=dev)
    node_T = take_rows(poses_wc, node_frames.clamp(0, poses_wc.shape[-3] - 1))
    node_valid = node_frames >= 0

    bb = torch.arange(B, device=dev).repeat_interleave(C - 1)
    ii = torch.arange(C - 1, device=dev).repeat(B)
    edge_i = bb * stride + ii
    edge_T = se3.compose(
        se3.inverse(T_wc_blk[..., bb, ii, :, :]), T_wc_blk[..., bb, ii + 1, :, :]
    )
    clean = (bb == 0) | (ii >= 1)
    edge_w = (
        problems.cam_valid[..., bb, ii] & problems.cam_valid[..., bb, ii + 1] & clean
    ).to(torch.float32)

    # Odometry-prior edges from the ORIGINAL trajectory (down-weighted):
    # where the block evidence is strong it dominates, where it is weak the
    # prior keeps the span near the front-end solution instead of letting
    # unobservable gauge modes wander.
    ks = torch.arange(n_nodes - 1, device=dev)
    prior_T = se3.compose(se3.inverse(node_T[..., :-1, :, :]), node_T[..., 1:, :, :])
    prior_w = 0.5 * node_valid[..., :-1].to(torch.float32)
    edge_i = torch.cat([edge_i, ks]).to(torch.int32).expand(lead + (-1,))
    edge_j = edge_i + 1
    edge_T = torch.cat([edge_T, prior_T], dim=-3)
    edge_w = torch.cat([edge_w, prior_w], dim=-1)

    # --- candidate init #2: CHAIN the clean edges from the gauge node.
    # LM alone cannot travel from a heavily drifted init to the corrected
    # chain in a few damped steps; the chain composition is the exact
    # minimiser of the odometry-only graph. For pair (k, k+1), block
    # b = (k-1)//stride supplies the clean edge (i = k - b*stride falls in
    # [1, C-2]); pair 0 uses block 0's anchor edge, clean by gauge
    # definition. ---
    chain_b = torch.where(ks == 0, 0, (ks - 1) // stride)
    chain_i = ks - chain_b * stride
    chain_rel = se3.compose(
        se3.inverse(T_wc_blk[..., chain_b, chain_i, :, :]),
        T_wc_blk[..., chain_b, chain_i + 1, :, :],
    )
    chained = [node_T[..., 0, :, :]]
    for k in range(n_nodes - 1):
        chained.append(se3.compose(chained[-1], chain_rel[..., k, :, :]))
    chain_T = torch.stack(chained, dim=-3)

    # Init SELECTION: the chain exactly fits the block edges, so on an
    # already-good trajectory it re-injects every block solve's noise,
    # compounded over the span. Start LM from whichever init has the lower
    # GRAPH cost (block edges + down-weighted odometry priors): a good
    # incoming trajectory wins and LM only polishes it; a heavily drifted
    # one loses to the chain.
    def graph_at(T):
        return PoseGraph(
            T_wc=T, node_valid=node_valid,
            edge_i=edge_i, edge_j=edge_j, edge_T=edge_T, edge_w=edge_w,
        )

    use_chain = graph_cost(chain_T, graph_at(chain_T)) < graph_cost(node_T, graph_at(node_T))
    init_T = torch.where(use_chain[..., None, None, None], chain_T, node_T)

    pg = optimize_pose_graph(graph_at(init_T), iterations=pg_iterations, n_fixed=1)
    pg_ok = pg.cost <= pg.cost0
    node_T_new = torch.where(pg_ok[..., None, None, None], pg.T_wc, init_T)

    # --- write back poses ---
    poses_out = scatter_drop(poses_wc, torch.where(node_valid, node_frames, -1), node_T_new)

    # --- write back points, carried by each block's rigid correction,
    #     referenced at cam1 (the first FREE camera: the anchor is
    #     deliberately left at its drifted absolute pose) ---
    ref_nodes = torch.arange(B, device=dev) * stride + 1
    C_b = se3.compose(node_T_new[..., ref_nodes, :, :], se3.inverse(T_wc_blk[..., :, 1, :, :]))
    pts_corr = se3.transform(C_b, pts_blk)
    pid = torch.where(problems.pnt_valid & (mappings.slot_to_pid >= 0), mappings.slot_to_pid, -1)
    points = _write_block_points(mp.points, pid, pts_corr)
    return mp._replace(points=points), poses_out, frame_lo, pg
