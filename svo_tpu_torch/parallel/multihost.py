"""Multi-process execution: the distributed BA across processes.

Port of svo_tpu/parallel/multihost.py. svo_tpu joins processes with
jax.distributed and builds one global device mesh; here the processes join
one torch.distributed process group over TCP, and the group plays the
mesh. Each process feeds only the shards it owns (put_sharded): for VO,
each process reads its own keyframe blocks' observations, and nothing is
gathered to one process. The same code runs as gloo processes on the CPU
(tests/test_torch_multihost.py), as gloo processes sharing one card, and
as one NCCL process per card.
"""

from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist

from svo_tpu_torch.ba.solver import BAProblem, BAResult
from svo_tpu_torch.parallel.ba import local_shards, solve_ba_on_mesh


def init(coordinator_address: str, num_processes: int, process_id: int,
         backend: str = "nccl", timeout_s: float = 300.0) -> None:
    """Join the process group: every process calls this once, with the same
    `host:port` of process 0 and its own id. backend "nccl" (the default)
    for one card per process, "gloo" for processes on the CPU or sharing a
    card. A process that does not hear from the others in timeout_s
    raises."""
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=timedelta(seconds=timeout_s),
    )


def global_mesh():
    """The group of all processes, in process order."""
    return dist.group.WORLD


def put_sharded(tree, n_shards: int, group=None, device: str | torch.device = "cuda"):
    """This process's shards on `device`. Every leaf has a leading shard
    axis: either the global count n_shards (split evenly over the ranks in
    rank order; the rows of other processes are ignored) or this process's
    share of it, n_shards / world rows. A process cannot tell the two
    apart from its own rows, so the global count is the caller's to give;
    any other leading axis raises."""
    world = dist.get_world_size(group)
    if n_shards % world:
        raise ValueError(f"{n_shards} shards do not split evenly over {world} processes")
    n = tree[0].shape[0]
    if n == n_shards:
        tree = local_shards(tree, group)
    elif n != n_shards // world:
        raise ValueError(f"leading axis {n} is neither the global {n_shards} shards nor this "
                         f"process's {n_shards // world}")
    return type(tree)(*(x.to(device) for x in tree))


def solve_ba_multihost(sharded_local: BAProblem, K_mat, baseline_fx, n_shards: int, group=None,
                       device: str | torch.device = "cuda", iterations: int = 10,
                       n_fixed: int = 1, **kw) -> BAResult:
    """The distributed BA across all processes of `group` (None: the
    default world) over n_shards shards in all. sharded_local: a
    shard_problem()-shaped problem whose leading axis is n_shards or this
    process's share of them (put_sharded). The same solve as
    parallel.ba.solve_ba_distributed, with a process-local data plane.
    Returns this process's shards' results."""
    group = global_mesh() if group is None else group
    fn = solve_ba_on_mesh(K_mat.to(device), baseline_fx, group, iterations=iterations,
                          n_fixed=n_fixed, **kw)
    return fn(put_sharded(sharded_local, n_shards, group, device))
