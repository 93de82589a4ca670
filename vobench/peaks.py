"""The card's published peaks and the least time of the port's kernels.

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
The lk_level bound is PERF.md's count (chip_smoke.py::bound_lk_level,
copied): each live window read once, each output written once; the larger
of its bytes over the memory rate and its operations over the float32 rate.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound_lk_level_ms(n_slots: int, live: int, window: int, mx: int, my: int,
                      iters: int) -> tuple[float, str]:
    """Least ms for one fused LK level over n_slots feature slots of which
    `live` are live. Bytes: a live slot reads three (w+3)^2 template windows
    and one (w+2my+1)x(w+2mx+1) current window; every slot reads pos,
    guess, valid and writes 8 floats. Operations: per live slot, 3 bilinear
    samples (7 flop) and 3 products into G per window pixel, then per
    iteration a sample, a difference and two multiply-adds per pixel."""
    tw = window + 3
    nbytes = live * (3 * tw * tw + (window + 2 * my + 1) * (window + 2 * mx + 1)) * 4
    nbytes += n_slots * (8 + 8 + 1 + 32)
    flop = live * window * window * (3 * 7 + 6 + iters * (7 + 1 + 4))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flop = flop / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flop else (t_flop, "operations")
