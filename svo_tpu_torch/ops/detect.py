"""Feature detection: dense FAST with bucketed selection, or ORB-style
multi-scale FAST ranked by Harris, with suppression of existing tracks.

Port of svo_tpu/ops/detect.py (detect, detect_fast, detect_orb). Every
function takes an (S, H, W) stack of images as S streams, each selected on
its own keys.
"""

from __future__ import annotations

import numpy as np
import torch

from svo_tpu_torch.config import Config
from svo_tpu_torch.ops import fast, harris, nms, select
from svo_tpu_torch.ops.pyramid import scale_pyramid
from svo_tpu_torch.ops.select import _topk_stable


def detect_fast(
    img: torch.Tensor,
    threshold: float,
    suppress: torch.Tensor | None,
    cfg: Config,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-scale FAST detection -> (pos (D,2), score (D,), valid (D,));
    an (S, H, W) stack of images detects per stream, (S, D, ...).

    Detects at FastParams.min_threshold and splits candidates into a strong
    tier (margin above `threshold`) and a weak tier that only claims
    leftover slots (select.bucketed_topk strong_gap)."""
    low = min(float(cfg.fast_params.min_threshold), threshold)
    score = fast.fast_nms(img, low, suppress)
    if cfg.bucket.enabled:
        return select.bucketed_topk(
            score,
            cfg.bucket.bucket_size,
            cfg.bucket.features_per_bucket,
            cfg.capacity.max_detections,
            strong_gap=threshold - low,
        )
    return select.global_topk(score, cfg.capacity.max_detections)


def orb_quotas(cfg: Config) -> list[int]:
    """Candidates kept per pyramid level, proportional to the level's area
    (factor 1/s^2), OpenCV ORB's nfeatures-per-level distribution."""
    op = cfg.orb_params
    inv_areas = [op.scale_factor ** (-2.0 * lvl) for lvl in range(op.pyr_levels)]
    total = sum(inv_areas)
    return [max(8, int(round(op.nfeatures * a / total))) for a in inv_areas]


def orb_candidates(img: torch.Tensor, cfg: Config) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Per scale_pyramid level, that level's quota of best candidates:
    FAST at orb_params.fast_treshold and 3x3 NMS, ranked by the Harris
    response where FAST fired (-inf elsewhere, and on the slots no
    candidate fills). Returns [(pos (..., quota, 2) in level-0 pixels
    (x 1.2**l), score (..., quota))] in level order."""
    op = cfg.orb_params
    levels = scale_pyramid(img, op.pyr_levels, op.scale_factor)
    out = []
    for lvl, (lv_img, quota) in enumerate(zip(levels, orb_quotas(cfg))):
        s = fast.fast_nms(lv_img, float(op.fast_treshold))
        ranked = torch.where(s > 0, harris.harris_response(lv_img), -torch.inf)
        pos, scores, valid = select.global_topk_signed(ranked, quota)
        out.append((pos * (float(op.scale_factor) ** lvl), torch.where(valid, scores, -torch.inf)))
    return out


def detect_orb(
    img: torch.Tensor,
    suppress: torch.Tensor | None,
    cfg: Config,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ORB-style multi-scale detection -> (pos (D,2), score (D,), valid
    (D,)); (S, D, ...) for an (S, H, W) stack.

    The candidates of every level (orb_candidates), suppression looked up
    at the truncated level-0 position, then one stable descending merge
    over the levels in level order (lax.top_k's lower-index-first rule),
    valid where the score is finite, padded to max_detections."""
    cands = orb_candidates(img, cfg)
    pos = torch.cat([p for p, _ in cands], dim=-2)
    scores = torch.cat([s for _, s in cands], dim=-1)

    H, W = img.shape[-2:]
    if suppress is not None:
        xi = torch.clamp(pos[..., 0].to(torch.int32), 0, W - 1).long()
        yi = torch.clamp(pos[..., 1].to(torch.int32), 0, H - 1).long()
        hit = torch.gather(suppress.reshape(suppress.shape[:-2] + (H * W,)), -1, yi * W + xi)
        scores = torch.where(hit, -torch.inf, scores)

    D = cfg.capacity.max_detections
    k = min(D, scores.shape[-1])
    top_scores, top_i = _topk_stable(scores, k)
    out_pos = torch.gather(pos, -2, top_i[..., None].expand(top_i.shape + (2,)))
    valid = torch.isfinite(top_scores)
    if k < D:
        lead = top_scores.shape[:-1]
        out_pos = torch.cat([out_pos, out_pos.new_zeros(lead + (D - k, 2))], dim=-2)
        top_scores = torch.cat([top_scores, top_scores.new_zeros(lead + (D - k,))], dim=-1)
        valid = torch.cat([valid, valid.new_zeros(lead + (D - k,))], dim=-1)
    return out_pos, top_scores, valid


def compare_orb(ref, got, cutoffs, tol: float) -> dict:
    """Two ORB detections of one image, (pos, score, valid) as numpy, held
    as multisets of valid positions (two levels may map a corner to one
    level-0 position): the Harris response is not bit-reproducible
    across implementations (prefix sums and matrix products add in other
    orders), so a near-tie at a cut-off may flip. Returns the valid counts,
    the candidates in one set only ("flipped") and, over those, the largest
    distance of a flipped candidate's score to the nearest cut-off score in
    `cutoffs` (each level's quota cut-off and the merge's). The stated rule
    is `ok`: at most 2% of the valid slots flipped, each within `tol` of a
    cut-off (tol = 1e-4 of max |Harris| in the callers)."""
    sides = []
    for pos, score, valid in (ref, got):
        side: dict[tuple, list[float]] = {}
        for p, sc, v in zip(pos, score, valid):
            if v:
                side.setdefault(tuple(p), []).append(float(sc))
        sides.append(side)
    a, b = sides
    flipped = []
    for key in set(a) | set(b):
        sa, sb = a.get(key, []), b.get(key, [])
        flipped += (sa if len(sa) > len(sb) else sb)[min(len(sa), len(sb)):]
    cut = np.asarray([c for c in cutoffs if np.isfinite(c)], np.float64)
    worst = max((float(np.abs(cut - sc).min()) if cut.size else float("inf")
                 for sc in flipped), default=0.0)
    n_a, n_b = (sum(map(len, x.values())) for x in (a, b))
    return dict(n_ref=n_a, n_got=n_b, flipped=len(flipped), worst=worst,
                ok=len(flipped) <= 0.02 * max(n_a, n_b) and worst <= tol)


def detect(
    img: torch.Tensor,
    prev_pos: torch.Tensor,
    prev_valid: torch.Tensor,
    cfg: Config,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Suppress around the previous frame's features, then detect (ORB
    where cfg.use_orb, else FAST)."""
    suppress = nms.suppression_mask(
        tuple(img.shape[-2:]), prev_pos, prev_valid, cfg.mask_halfwidth
    )
    if cfg.use_orb:
        return detect_orb(img, suppress, cfg)
    return detect_fast(img, float(cfg.fast_params.threshold), suppress, cfg)
