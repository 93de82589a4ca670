"""Distributed bundle adjustment over the ranks of a process group.

Port of svo_tpu/parallel/ba.py. The map is partitioned into point blocks:
each shard owns one block's points and ALL observations of those points,
cameras are replicated. Per LM iteration the only cross-rank traffic is the
Schur-reduced camera system, a (K,K,6,6) block, a (K,6) right-hand side,
and the robust cost (ba/solver.py, distributed mode). Point
marginalisation and back-substitution never leave the owning shard.

svo_tpu places one shard on each device of a mesh. Here a rank holds any
number of shards along the problem's leading axis, contiguous in rank
order, so 8 shards run on 1, 2, 4 or 8 ranks; the sums across shards are
folded in global shard order (parallel/collective.py), which gives the
same bits for every split.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from svo_tpu_torch.ba.solver import BAProblem, BAResult, solve_ba
from svo_tpu_torch.pipeline.state import tensor


def shard_problem(problem: BAProblem, n_shards: int) -> BAProblem:
    """Repartition a single problem into n_shards point blocks, on the host
    (numpy), as svo_tpu's shard_problem does, bit for bit.

    Shard s owns point slots [s*P/n, (s+1)*P/n); every observation follows
    its point. Shapes stay static: each shard gets P/n point slots and
    ceil(O/n) observation slots (rows past a shard's capacity are dropped,
    so size capacities accordingly). Every leaf gains a leading shard axis;
    the result is on the CPU."""
    P_tot = problem.points.shape[0]
    O_tot = problem.obs_cam.shape[0]
    if P_tot % n_shards:
        raise ValueError(f"{P_tot} point slots do not divide into {n_shards} shards")
    P_loc = P_tot // n_shards
    O_loc = -(-O_tot // n_shards)

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    pnt, cam, uv, ok = (host(getattr(problem, f)) for f in ("obs_pnt", "obs_cam", "obs_uv", "obs_valid"))
    out = {
        "T_cw": np.tile(host(problem.T_cw)[None], (n_shards, 1, 1, 1)),
        "cam_valid": np.tile(host(problem.cam_valid)[None], (n_shards, 1)),
        "points": host(problem.points).reshape(n_shards, P_loc, 3),
        "pnt_valid": host(problem.pnt_valid).reshape(n_shards, P_loc),
        "obs_cam": np.zeros((n_shards, O_loc), np.int32),
        "obs_pnt": np.zeros((n_shards, O_loc), np.int32),
        "obs_uv": np.zeros((n_shards, O_loc, 3), np.float32),
        "obs_valid": np.zeros((n_shards, O_loc), bool),
    }
    for s in range(n_shards):
        idx = np.nonzero(ok & (pnt // P_loc == s))[0][:O_loc]
        n = len(idx)
        out["obs_cam"][s, :n] = cam[idx]
        out["obs_pnt"][s, :n] = pnt[idx] - s * P_loc
        out["obs_uv"][s, :n] = uv[idx]
        out["obs_valid"][s, :n] = True
    return BAProblem(**{k: tensor(v) for k, v in out.items()})


def local_shards(tree, group=None):
    """This rank's rows of every leaf of a tree whose leading axis is the
    global shard count, split evenly over the group's ranks in rank order
    (other ranks' rows are dropped)."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    n = tree[0].shape[0]
    if n % world:
        raise ValueError(f"{n} shards do not split evenly over {world} ranks")
    per = n // world

    def rows(x):
        if x.shape[0] != n:
            raise ValueError(f"leading axes differ: {x.shape[0]} against {n}")
        return x[rank * per:(rank + 1) * per]

    return type(tree)(*(rows(x) for x in tree))


def solve_ba_on_mesh(K_mat, baseline_fx, group=None, iterations: int = 10, n_fixed: int = 1, **kw):
    """The distributed solve over `group` (None: the default world) as a
    function of this rank's shards: fn(local_problem) -> BAResult with the
    same leading axis. Single-process (solve_ba_distributed) and
    multi-process (parallel.multihost.solve_ba_multihost) callers both drive
    it; the caller owns data placement."""
    group = dist.group.WORLD if group is None else group

    def fn(local: BAProblem) -> BAResult:
        return solve_ba(local, K_mat, baseline_fx, iterations=iterations, n_fixed=n_fixed,
                        group=group, **kw)

    return fn


def solve_ba_distributed(sharded: BAProblem, K_mat, baseline_fx, group=None,
                         iterations: int = 10, n_fixed: int = 1, **kw) -> BAResult:
    """Solve a shard_problem()-shaped problem (leading axis: all shards)
    over `group` (None: the default world; a world of one holds every
    shard). Returns this rank's shards' results, each with the shared
    cameras and the global costs."""
    fn = solve_ba_on_mesh(K_mat, baseline_fx, group, iterations=iterations, n_fixed=n_fixed, **kw)
    return fn(local_shards(sharded, group))
