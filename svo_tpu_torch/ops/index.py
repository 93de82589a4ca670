"""Gathers and scatters that carry leading stream axes.

svo_tpu batches its frame step over streams with jax.vmap, which turns
x[idx] into a per-stream gather by itself. The port writes the stream axis
out: every function here takes any number of leading axes, shared by all
its arguments, so one body serves one stream and S streams.
"""

from __future__ import annotations

import torch


def take_rows(x: torch.Tensor, idx: torch.Tensor, k: int = 1) -> torch.Tensor:
    """x[idx] per leading index. idx is (..., *K) with K its last k axes,
    integer in [0, N); x is (..., N, *rest) -> (..., *K, *rest)."""
    row = idx.dim() - k
    rest = x.shape[row + 1:]
    flat = idx.reshape(idx.shape[:row] + (-1,) + (1,) * len(rest)).long()
    out = torch.gather(x, row, flat.expand(flat.shape[: row + 1] + rest))
    return out.reshape(idx.shape + rest)


def gather_hw(img: torch.Tensor, r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """img[r, c] per leading index: img (..., H, W), r and c int64, in
    range and broadcastable to (..., *K) -> (..., *K)."""
    lead = img.shape[:-2]
    idx = r * img.shape[-1] + c
    flat = torch.gather(img.reshape(lead + (-1,)), -1, idx.reshape(lead + (-1,)))
    return flat.reshape(idx.shape)


def scatter_drop(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """dst with dst[idx[i]] = src[i] per leading index (a new tensor): dst
    (..., n, *rest), idx (..., K), src (..., K, *rest). Rows whose idx lies
    outside [0, n) are dropped, as jax's .at[].set(mode="drop"): they go to
    a spare row that is then cut off. In-range indices must not repeat."""
    row = idx.dim() - 1
    n = dst.shape[row]
    ok = (idx >= 0) & (idx < n)
    out = torch.cat([dst, dst.narrow(row, 0, 1)], dim=row)
    where = torch.where(ok, idx, n).long()
    where = where.reshape(where.shape + (1,) * (dst.dim() - row - 1)).expand(src.shape)
    out.scatter_(row, where, src)
    return out.narrow(row, 0, n)
