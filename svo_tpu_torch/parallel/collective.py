"""The one cross-rank exchange of the distributed paths, in a fixed order.

svo_tpu sums across devices with lax.psum, whose order XLA fixes per
program. An all-reduce over torch.distributed leaves its order to the
backend (NCCL picks ring or tree by size and topology), so a sum could
differ in its last bits between runs and between world sizes. The port
never all-reduces a float: every rank all-gathers the per-shard terms and
folds them in global shard order, front to back. The same shards then give
the same bits whether they sit on one rank or on eight.

Gloo and CUDA tensors: the exchange of a gloo group always goes through
host memory. A CUDA tensor is copied to the host, gathered there and
copied back, on every call; NCCL gathers on the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """(L, ...) rows of this rank -> (world * L, ...) rows of every rank in
    rank order, on x's device. Every rank must hold the same L."""
    world = dist.get_world_size(group)
    staged = x.cpu() if x.is_cuda and dist.get_backend(group) == "gloo" else x
    parts = [torch.empty_like(staged) for _ in range(world)]
    dist.all_gather(parts, staged.contiguous(), group=group)
    return torch.cat(parts).to(x.device)


def fold(rows: torch.Tensor) -> torch.Tensor:
    """rows[0] + rows[1] + ... added front to back."""
    acc = rows[0]
    for r in rows[1:]:
        acc = acc + r
    return acc


def sum_over_shards(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over every rank's shards (the rows of x on each rank) in
    global shard order, with a leading axis of 1."""
    return fold(gather_rows(x, group))[None]
