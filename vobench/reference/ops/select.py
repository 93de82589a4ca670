"""Grid-bucketed feature selection as dense per-cell top-k.

Port of svo_tpu/ops/select.py (_topk_rounds, bucketed_topk, global_topk,
global_topk_signed).
jax.lax.top_k breaks ties by taking the lower index first, and the keys
here tie a lot (int32 tier keys, zero scores); torch.topk promises no
order among ties, so the port selects with a stable descending sort
(`_topk_stable`), which keeps the lower index first.
"""

from __future__ import annotations

import torch

_INT32_MIN = torch.iinfo(torch.int32).min


def _topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with lax.top_k's tie rule (lower index
    first among equal values)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _topk_rounds(cells: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k per row via k rounds of (row max, first argmax, mask out).

    Same contract as svo_tpu's: ties go to the first index, and once a row
    has fewer than k entries above -inf, every remaining round returns the
    SAME index (the row's first -inf slot) with value -inf, so callers
    filter by value, not by index uniqueness."""
    P = cells.shape[-1]
    iota = torch.arange(P, dtype=torch.int64, device=cells.device).expand(cells.shape)
    work = cells
    vals, idxs = [], []
    for _ in range(k):
        m = work.amax(dim=-1)
        i = torch.where(work == m[..., None], iota, P).amin(dim=-1)
        vals.append(m)
        idxs.append(torch.clamp(i, max=P - 1))
        work = torch.where(iota == i[..., None], -torch.inf, work)
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def bucketed_topk(
    score: torch.Tensor,
    bucket_size: int,
    per_bucket: int,
    max_out: int,
    strong_gap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Select up to max_out features, at most per_bucket per grid cell.

    Candidates (score > 0) are ordered by the int32 composite key
    (tier, within-cell rank, golden-ratio cell spread) of svo_tpu: strong
    (score > strong_gap) before weak, every cell's best before any cell's
    second best, cells in a spatially spread order. Returns pos (max_out, 2)
    f32 (x, y), score (max_out,), valid (max_out,). A score map
    (..., H, W) selects per leading index, each with its own sort."""
    H, W = score.shape[-2:]
    lead = score.shape[:-2]
    B = bucket_size
    Hp = -(-H // B) * B
    Wp = -(-W // B) * B
    s = torch.nn.functional.pad(score, (0, Wp - W, 0, Hp - H))
    hc, wc = Hp // B, Wp // B
    cells = s.reshape(lead + (hc, B, wc, B)).transpose(-3, -2).reshape(lead + (hc * wc, B * B))

    k = min(per_bucket, B * B)
    cell_scores, cell_idx = _topk_rounds(cells, k)  # (C, k)

    C = hc * wc
    dev = score.device
    cell = torch.arange(C, device=dev)
    py = (cell // wc)[:, None] * B + cell_idx // B
    px = (cell % wc)[:, None] * B + cell_idx % B
    flat_scores = cell_scores.reshape(lead + (-1,))
    flat_x = px.reshape(lead + (-1,))
    flat_y = py.reshape(lead + (-1,))

    rank = torch.arange(k, dtype=torch.int32, device=dev)[None, :].expand(C, k).reshape(-1)
    cell_of = torch.arange(C, dtype=torch.float32, device=dev)
    spread = torch.floor(((cell_of * 0.6180339887) % 1.0) * C).to(torch.int32)
    spread = spread[:, None].expand(C, k).reshape(-1)
    weak = (flat_scores <= strong_gap).to(torch.int32) if strong_gap > 0 else 0
    prio = (weak * k + rank) * (C + 1) + spread  # ascending = better first
    key = torch.where(flat_scores > 0.0, -prio, _INT32_MIN)
    top_key, top_i = _topk_stable(key, min(max_out, key.shape[-1]))
    top_scores = torch.gather(flat_scores, -1, top_i)
    out_x = torch.gather(flat_x, -1, top_i).to(torch.float32)
    out_y = torch.gather(flat_y, -1, top_i).to(torch.float32)
    valid = (top_key > _INT32_MIN) & (top_scores > 0.0)

    pad = max_out - top_scores.shape[-1]
    if pad > 0:
        out_x, out_y, top_scores, valid = (
            torch.cat([a, a.new_zeros(lead + (pad,))], dim=-1)
            for a in (out_x, out_y, top_scores, valid)
        )
    return torch.stack([out_x, out_y], dim=-1), top_scores, valid


def global_topk(
    score: torch.Tensor, max_out: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain global top-k from a score map (bucketing disabled). Scores
    <= 0 are not candidates. (..., H, W) selects per leading index."""
    W = score.shape[-1]
    top_scores, top_i = _topk_stable(score.reshape(score.shape[:-2] + (-1,)), max_out)
    pos = torch.stack(
        [(top_i % W).to(torch.float32), (top_i // W).to(torch.float32)], dim=-1
    )
    return pos, top_scores, top_scores > 0.0


def global_topk_signed(
    score: torch.Tensor, max_out: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k where scores may be negative (the Harris response); -inf marks
    non-candidates, and most keys are -inf, so the tie rule decides which
    non-candidates fill the tail. (..., H, W) selects per leading index,
    along that index's flattened H*W keys."""
    W = score.shape[-1]
    top_scores, top_i = _topk_stable(score.reshape(score.shape[:-2] + (-1,)), max_out)
    pos = torch.stack(
        [(top_i % W).to(torch.float32), (top_i // W).to(torch.float32)], dim=-1
    )
    return pos, top_scores, torch.isfinite(top_scores)
