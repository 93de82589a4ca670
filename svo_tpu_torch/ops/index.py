"""Gathers and scatters that carry leading stream axes.

svo_tpu batches its frame step over streams with jax.vmap, which turns
x[idx] into a per-stream gather by itself. The port writes the stream axis
out: every function here takes any number of leading axes, shared by all
its arguments, so one body serves one stream and S streams.
"""

from __future__ import annotations

from typing import NamedTuple

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


class Segments(NamedTuple):
    """The sorted runs of one table of segment keys (see segments)."""
    order: torch.Tensor    # (B*O,) i64: rows of the flattened table, by key, stably
    offsets: torch.Tensor  # (B*n + 1,) i64: where each segment's run starts in `order`
    shape: tuple           # the key table's shape (..., O)
    n: int                 # segments per leading index


def segments(keys: torch.Tensor, n: int) -> Segments:
    """Sort a (..., O) table of segment keys in [0, n) once, so that any
    number of segment_sum calls can reuse it. Each leading index has its
    own n segments."""
    B = keys[..., 0].numel()
    base = torch.arange(B, device=keys.device)[:, None] * n
    flat = (keys.reshape(B, -1).long() + base).reshape(-1)
    sorted_keys, order = torch.sort(flat, stable=True)
    bounds = torch.arange(B * n + 1, device=keys.device)
    return Segments(order, torch.searchsorted(sorted_keys, bounds), tuple(keys.shape), n)


def segment_sum(values: torch.Tensor, seg: Segments) -> torch.Tensor:
    """out[..., k, :] = the sum of values[..., o, :] over the rows o whose key
    is k: values (..., O, *rest) -> (..., n, *rest). What jax writes as
    zeros.at[keys].add(values).

    Deterministic: the rows are gathered into key order (a stable sort, done
    once per key table) and each run is added up front to back by one
    thread, so two calls give the same bits, where index_add_ and
    scatter_add_ on the card add with atomics in an order that changes from
    run to run. The cost is the gather and one pass over the values; the
    sort is shared by every call on the same keys."""
    rest = values.shape[len(seg.shape):]
    rows = values.reshape((len(seg.order), -1))[seg.order]
    out = torch.segment_reduce(rows, "sum", offsets=seg.offsets, axis=0, unsafe=True)
    return out.reshape(seg.shape[:-1] + (seg.n,) + rest)
