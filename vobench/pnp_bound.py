"""The least time of the port's RANSAC-PnP kernel (csrc/ransac_pnp.cu), for
the per-layer metric pnp_roofline.dense.

The count is chip_smoke.py::bound_pnp's, copied as peaks.py copied
bound_lk_level: a call's inputs read and outputs written once, its float
operations at the 32-bit rate outside the tensor cores (vobench/peaks.py);
the least time is the larger of the two.
"""

from __future__ import annotations

from vobench.peaks import F32_FLOP_PER_S, HBM_BYTES_PER_S


def bound_pnp_ms(S: int, N: int, H: int, P: int) -> tuple[float, str]:
    """Least ms for one ransac_pnp call of S streams of N slots, H
    hypotheses and P priors. Bytes: K, each stream's points (12 B), pixels
    (8 B), valid (1 B), noise (4 H B a slot) and priors read once, its pose,
    inliers, ratio and ok written once. Operations: a hypothesis's A^T A
    (1,872), 12x12 Cholesky (~650), 8 inverse iterations (8 x 312), polar
    (8 x ~120) and 25 a residual over N slots; an LO chain (2 P + 1 a
    stream): 2 rounds of a gate (25 N) and 4 Gauss-Newton steps (~150 N for
    the terms and their sums, ~600 for the 6x6 solve and the update), and
    its strict consensus (25 N)."""
    nbytes = 36 + S * (N * (12 + 8 + 1) + H * N * 4 + P * 64) + S * (64 + N + 4 + 1)
    hyp = 1872 + 650 + 8 * 312 + 8 * 120 + 25 * N
    chain = 2 * (25 * N + 4 * (150 * N + 600)) + 25 * N
    ops = S * ((H + P) * hyp + (2 * P + 1) * chain)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pnp_activities(rec: dict) -> list:
    """The profiled slice's activities of the PnP kernel's launches (its
    hypotheses and its selection kernels, narrow or wide), by name."""
    from vobench.trace import step_activities

    return [a for a in step_activities(rec)
            if "pnp_hypotheses" in a[0] or "pnp_select" in a[0]]


def cell_shape(rec: dict) -> tuple[int, int, int, int]:
    """(S, N, H, P) of the cell's frame step: its streams, max_features,
    RANSAC hypotheses and the one prior (the motion prior's pose)."""
    from svo_tpu_torch.config import Config
    from vobench import spec

    cell = spec.load_cell(rec["cell"])
    cfg = spec.with_overrides(Config(), cell.config["pipeline"])
    return (cell.traffic["streams"], cfg.capacity.max_features, cfg.ransac.num_hypotheses, 1)
