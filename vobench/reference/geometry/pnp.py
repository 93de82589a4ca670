"""RANSAC-PnP: batched-hypothesis robust 3D->2D pose estimation.

Port of svo_tpu/geometry/pnp.py::ransac_pnp: H index sets of 6 valid
correspondences drawn by Gumbel top-6, a 6-point DLT per set, MSAC
scoring, locally optimised (LO) Gauss-Newton refinement from the MSAC
winner and the prior pose, and the annealed rescue from the prior.

The Gumbel noise is an argument: the frame step (pipeline/frontend.py)
draws it from the state's key with ops/random.py, svo_tpu's
jax.random.gumbel, and a test can hand in the noise jax drew.

The stream axis: svo_tpu batches the solve with jax.vmap; here every
argument may carry leading axes (Xw (..., N, 3), noise (..., H, N), T_init
(..., 4, 4)), and all hypotheses of all streams go through the same ops, so
S streams cost the launches of one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.config import RansacParams
from vobench.reference.geometry import se3
from vobench.reference.ops import linalg
from vobench.reference.ops.index import take_rows


class PnPResult(NamedTuple):
    T_wc: torch.Tensor          # (..., 4, 4) camera-to-world pose
    inliers: torch.Tensor       # (..., N) bool, subset of `valid`
    inlier_ratio: torch.Tensor  # (...,) |inliers| / |valid|
    ok: torch.Tensor            # (...,) bool, solution sanity


def _normalize_pixels(K: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """K^-1 applied to pixels: (...,2) -> (...,2) normalised coordinates."""
    return torch.stack(
        [(uv[..., 0] - K[0, 2]) / K[0, 0], (uv[..., 1] - K[1, 2]) / K[1, 1]], dim=-1
    )


def _dlt6(Xw: torch.Tensor, xn: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Minimal 6-point DLT pose, batched: world points (...,6,3) and
    normalised image points (...,6,2) -> (R (...,3,3), t (...,3))."""
    Xh = torch.cat([Xw, torch.ones_like(Xw[..., :1])], dim=-1)  # (...,6,4)
    z = torch.zeros_like(Xh)
    # rows [X 0 -u X ; 0 X -v X] for P stacked as a row-major 12-vector
    r1 = torch.cat([Xh, z, -xn[..., 0:1] * Xh], dim=-1)
    r2 = torch.cat([z, Xh, -xn[..., 1:2] * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (...,12,12)
    A = A / (torch.linalg.norm(A, dim=-1, keepdim=True) + 1e-12)
    p = linalg.smallest_eigvec_psd(A.transpose(-1, -2) @ A)
    P = p.reshape(p.shape[:-1] + (3, 4))
    # cheirality: make the sample points' depths positive
    depths = (Xh @ P[..., 2, :, None])[..., 0]
    flip = torch.sum(torch.sign(depths), dim=-1) < 0
    P = P * torch.where(flip, -1.0, 1.0)[..., None, None]
    M = P[..., :3]
    R = linalg.polar3x3(M)
    # scale: |M| projected onto R (trace(R^T M) / 3); sign already fixed
    scale = torch.sum(R * M, dim=(-1, -2)) / 3.0
    scale = torch.where(torch.abs(scale) < 1e-12, 1e-12, scale)
    return R, P[..., 3] / scale[..., None]


def _reproj_errors(K, T_cw, Xw, uv):
    """Squared pixel reprojection errors and camera-frame depths of
    (..., N, 3) points under T_cw (..., 4, 4) -> (..., N); T_cw may carry
    one more axis, of hypotheses, (..., H, 4, 4) -> (..., H, N)."""
    if T_cw.dim() == Xw.dim() + 1:
        Xw, uv = Xw[..., None, :, :], uv[..., None, :, :]
    Xc = Xw @ se3.rotation(T_cw).transpose(-1, -2) + se3.translation(T_cw)[..., None, :]
    z = Xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = K[0, 0] * Xc[..., 0] / zs + K[0, 2]
    v = K[1, 1] * Xc[..., 1] / zs + K[1, 2]
    return (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2, z


def _gn_refine(K, T_cw, Xw, uv, weight, iters: int):
    """Masked Gauss-Newton on reprojection error over se(3), left update
    T <- exp(delta) @ T; weight is an (..., N) 0/1 inlier mask."""
    fx, fy = K[0, 0], K[1, 1]
    eye3 = torch.eye(3, dtype=Xw.dtype, device=Xw.device)
    eye6 = torch.eye(6, dtype=Xw.dtype, device=Xw.device)
    w = weight[..., None, None]
    T = T_cw
    for _ in range(iters):
        Xc = se3.transform(T, Xw)
        x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
        inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        u = fx * x * inv_z + K[0, 2]
        v = fy * y * inv_z + K[1, 2]
        r = torch.stack([u - uv[..., 0], v - uv[..., 1]], dim=-1)  # (N,2)
        zero = torch.zeros_like(x)
        Jpi = torch.stack(
            [
                torch.stack([fx * inv_z, zero, -fx * x * inv_z * inv_z], dim=-1),
                torch.stack([zero, fy * inv_z, -fy * y * inv_z * inv_z], dim=-1),
            ],
            dim=-2,
        )  # (N,2,3)
        Jx = torch.cat([eye3.expand(Xc.shape[:-1] + (3, 3)), -se3.hat(Xc)], dim=-1)
        J = Jpi @ Jx  # (N,2,6)
        Jt = J.transpose(-1, -2)
        H = torch.sum(Jt @ (J * w), dim=-3) + 1e-6 * eye6
        g = torch.sum(Jt @ (r[..., None] * w), dim=-3)[..., 0]
        delta = -linalg.cho_solve_unrolled(linalg.cholesky_unrolled(H), g)
        # guard against divergent steps on degenerate systems
        delta = torch.where(torch.all(torch.isfinite(delta), dim=-1, keepdim=True), delta, 0.0)
        T = se3.compose(se3.exp(delta), T)
    return T


def ransac_pnp(
    K: torch.Tensor,
    Xw: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    noise: torch.Tensor,
    params: RansacParams,
    T_init: torch.Tensor | None = None,
) -> PnPResult:
    """Robust pose from N (masked) 3D->2D correspondences.

    Args:
        K: (3,3) intrinsics.
        Xw: (N,3) world points.
        uv: (N,2) observed pixels in the current left image.
        valid: (N,) bool mask of live correspondences.
        noise: (params.num_hypotheses, N) Gumbel noise for the sampling.
        params: RansacParams.
        T_init: optional (4,4) prior world-to-camera pose, or (P,4,4)
            priors, refined as extra starts (and the annealed rescue's).
    Every tensor but K may carry the same leading axes (S streams): Xw
    (S,N,3), noise (S,H,N), T_init (S,4,4) or (S,P,4,4); each stream is
    solved for itself and every result gains the leading S.
    Returns:
        PnPResult with T_wc (camera-to-world).
    """
    H = params.num_hypotheses
    N = Xw.shape[-2]
    lead = Xw.shape[:-2]
    if tuple(noise.shape) != tuple(lead) + (H, N):
        raise ValueError(
            f"noise must be (..., H, N) = {tuple(lead) + (H, N)}, got {tuple(noise.shape)}"
        )
    validf = valid.to(torch.float32)
    valid_h = valid[..., None, :]

    # --- 1. hypothesis index sets: Gumbel top-6 over valid slots (a stable
    #     sort keeps lax.top_k's lower-index-first rule among -inf ties) ---
    scores = torch.where(valid_h, noise, -torch.inf)
    idx = torch.sort(scores, dim=-1, descending=True, stable=True)[1][..., :6]

    xn = _normalize_pixels(K, uv)
    # --- 2. batched minimal solves ---
    Rs, ts = _dlt6(take_rows(Xw, idx, 2), take_rows(xn, idx, 2))  # (...,H,3,3), (...,H,3)
    T_h = se3.from_rt(Rs, ts)         # (...,H,4,4) world->camera
    if T_init is not None:
        if T_init.dim() == len(lead) + 2:
            T_init = T_init[..., None, :, :]
        T_h = torch.cat([T_h, T_init], dim=-3)
        H = H + T_init.shape[-3]

    # --- 3. score all hypotheses (MSAC: truncated squared residual) ---
    thr2 = params.reproj_threshold ** 2
    err2, z = _reproj_errors(K, T_h, Xw, uv)  # (...,H,N)
    finite = torch.all(torch.isfinite(T_h.flatten(-2)), dim=-1)
    inl = (err2 < thr2) & (z > 0) & valid_h
    res2 = torch.where(z > 0, torch.clamp(err2, max=thr2), thr2)
    msac = torch.sum(torch.where(valid_h, res2, 0.0), dim=-1)
    msac = torch.where(finite, msac, torch.inf)
    best = torch.argmin(msac, dim=-1)  # first index among ties, as jnp.argmin
    T_best = take_rows(T_h, best[..., None])[..., 0, :, :]
    inliers0 = take_rows(inl, best[..., None])[..., 0, :]

    # --- 4. LO refinement from the MSAC winner and from every prior pose,
    #     judged by final strict consensus; the annealed LO from each prior
    #     is adopted only when it beats that by rescue_margin (see svo_tpu's
    #     geometry/pnp.py for the failure modes behind each rule) ---
    def inliers_of(T, mult: float = 1.0):
        err2_f, z_f = _reproj_errors(K, T, Xw, uv)
        inl_f = (err2_f < thr2 * (mult * mult)) & (z_f > 0) & valid
        res2_f = torch.where(z_f > 0, torch.clamp(err2_f, max=thr2), thr2)
        return inl_f, torch.sum(torch.where(valid, res2_f, 0.0), dim=-1)

    def lo_from(T0, schedule):
        T_ref = T0
        for mult in schedule:
            sel, _ = inliers_of(T_ref, mult)
            T_ref = _gn_refine(K, T_ref, Xw, uv, sel.to(torch.float32), params.refine_iters)
        return T_ref, inliers_of(T_ref)[0]

    def finite_pose(T):
        return torch.all(torch.isfinite(T.flatten(-2)), dim=-1)

    strict = (1.0,) * params.lo_rounds
    finals = [(T_best, inliers0), lo_from(T_best, strict)]
    rescues = []
    if T_init is not None:
        for i in range(T_init.shape[-3]):
            finals.append(lo_from(T_init[..., i, :, :], strict))
            rescues.append(lo_from(T_init[..., i, :, :], tuple(params.lo_anneal)))

    T_final, inliers = finals[0]
    best_count = torch.sum(inliers, dim=-1)
    best_score = inliers_of(T_final)[1]
    for T_c, inl_c in finals[1:]:
        cnt = torch.sum(inl_c, dim=-1)
        score = inliers_of(T_c)[1]
        better = finite_pose(T_c) & (
            (cnt > best_count) | ((cnt == best_count) & (score < best_score))
        )
        T_final = torch.where(better[..., None, None], T_c, T_final)
        inliers = torch.where(better[..., None], inl_c, inliers)
        best_count = torch.where(better, cnt, best_count)
        best_score = torch.where(better, score, best_score)

    for T_c, inl_c in rescues:
        cnt = torch.sum(inl_c, dim=-1)
        better = finite_pose(T_c) & (
            cnt.to(torch.float32)
            >= params.rescue_margin * best_count.to(torch.float32) + 2.0
        )
        T_final = torch.where(better[..., None, None], T_c, T_final)
        inliers = torch.where(better[..., None], inl_c, inliers)
        best_count = torch.where(better, cnt, best_count)

    n_inl = torch.sum(inliers.to(torch.float32), dim=-1)
    n_valid = torch.sum(validf, dim=-1)
    ratio = n_inl / torch.clamp(n_valid, min=1.0)
    # judge the final consensus; the floor scales with the live count
    floor = torch.clamp(0.1 * n_valid, min=6.0)
    ok = (n_inl >= floor) & finite_pose(T_final)
    return PnPResult(T_wc=se3.inverse(T_final), inliers=inliers, inlier_ratio=ratio, ok=ok)
