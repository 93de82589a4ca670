"""Feature detection: dense FAST with suppression of existing tracks and
bucketed selection.

Port of svo_tpu/ops/detect.py (detect, detect_fast). The ORB-style
multi-scale detector is not ported yet (ROADMAP item A11).
"""

from __future__ import annotations

import torch

from svo_tpu_torch.config import Config
from svo_tpu_torch.ops import fast, nms, select


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
    score = nms.nms3x3(fast.fast_score(img, low))
    if suppress is not None:
        score = torch.where(suppress, 0.0, score)
    if cfg.bucket.enabled:
        return select.bucketed_topk(
            score,
            cfg.bucket.bucket_size,
            cfg.bucket.features_per_bucket,
            cfg.capacity.max_detections,
            strong_gap=threshold - low,
        )
    return select.global_topk(score, cfg.capacity.max_detections)


def detect(
    img: torch.Tensor,
    prev_pos: torch.Tensor,
    prev_valid: torch.Tensor,
    cfg: Config,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Suppress around the previous frame's features, then detect."""
    if cfg.use_orb:
        raise NotImplementedError(
            "use_orb=True: the ORB detector is not ported yet (ROADMAP item "
            "A11); use Config(use_orb=False)"
        )
    suppress = nms.suppression_mask(
        tuple(img.shape[-2:]), prev_pos, prev_valid, cfg.mask_halfwidth
    )
    return detect_fast(img, float(cfg.fast_params.threshold), suppress, cfg)
