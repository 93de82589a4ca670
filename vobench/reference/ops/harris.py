"""Dense Harris corner response, the ranking score of the ORB detector.

Port of svo_tpu/ops/harris.py: a 7x7 block sum of Sobel-gradient products
with k = 0.04, as OpenCV's ORB HARRIS_SCORE, computed densely.
"""

from __future__ import annotations

import torch

from vobench.reference.ops.pyramid import box_filter, sobel_gradients

HARRIS_K = 0.04
BLOCK = 7


def harris_response(img: torch.Tensor, block: int = BLOCK, k: float = HARRIS_K) -> torch.Tensor:
    """(..., H, W) Harris response: det(M) - k*tr(M)^2 over a block window."""
    ix, iy = sobel_gradients(img)
    sxx = box_filter(ix * ix, block)
    syy = box_filter(iy * iy, block)
    sxy = box_filter(ix * iy, block)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr
