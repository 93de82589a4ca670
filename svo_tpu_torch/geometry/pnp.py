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

ransac_pnp on a CUDA tensor launches the hand-written kernel
csrc/ransac_pnp.cu twice (hypotheses and the prior chains, then the
winner's chain and the choice) for all streams, at 6 to 2,048
correspondences a stream; on a CPU tensor it runs ransac_pnp_ref, the plain
version (the CPU tests' path, and what the card tests hold the kernel
against).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from svo_tpu_torch import _build
from svo_tpu_torch.config import RansacParams
from svo_tpu_torch.geometry import se3
from svo_tpu_torch.ops import linalg
from svo_tpu_torch.ops.index import take_rows


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


def ransac_pnp_ref(
    K: torch.Tensor,
    Xw: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    noise: torch.Tensor,
    params: RansacParams,
    T_init: torch.Tensor | None = None,
) -> PnPResult:
    """Robust pose from N (masked) 3D->2D correspondences: the plain
    version of ransac_pnp.

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


# The kernel's limits (csrc/ransac_pnp.cu's kMaxWideN, kMaxSchedule,
# kMaxParts): correspondences a stream (up to NARROW_N, 4 slots a lane of a
# warp; past it the wide path); the LO schedules it holds; streams a grid
# column; the threads of a Gauss-Newton sum it repeats.
KERNEL_MAX_N = 2048
NARROW_N = 128
KERNEL_MAX_SCHEDULE = 8
KERNEL_MAX_STREAMS = 65535
KERNEL_MAX_PARTS = 128


class KernelParams(NamedTuple):
    """RansacParams as the kernel takes them: each float32 as the plain
    path compares or multiplies it (a Python float against a float32
    tensor is cast to float32)."""
    thr2: float            # the strict gate and the MSAC clamp, px^2
    strict: tuple          # each strict LO round's inlier gate, px^2
    anneal: tuple          # each annealed LO round's gate, px^2
    margin: float          # rescue_margin
    iters: int             # Gauss-Newton iterations a round


def kernel_params(params: RansacParams) -> KernelParams:
    """The kernel's arguments from `params`: inliers_of's gate
    thr2 * (mult * mult) computed in Python floats as the plain path
    computes it, then rounded to float32, once for each round of the strict
    schedule ((1.0,) * lo_rounds) and of lo_anneal."""
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    thr2 = params.reproj_threshold ** 2
    return KernelParams(
        thr2=f32(thr2),
        strict=tuple(f32(thr2 * (1.0 * 1.0)) for _ in range(params.lo_rounds)),
        anneal=tuple(f32(thr2 * (m * m)) for m in params.lo_anneal),
        margin=f32(params.rescue_margin),
        iters=int(params.refine_iters),
    )


# The H100 SXM's multiprocessors and threads a multiprocessor: a reduction
# over enough points spans blocks by them (gn_plan)
H100_SMS = 132
_THREADS_PER_SM = 2048


def _block_dims(dim0: int, dim1: int, threads: int) -> tuple[int, int]:
    """ReduceConfig::set_block_dimension: (block_width, block_height) of a
    block of at most `threads` over dim0 x dim1."""
    def pow2(n):
        return 1 << (max(n, 1).bit_length() - 1) if n < threads else threads

    width = min(pow2(dim0), 32)
    height = min(pow2(dim1), threads // width)
    return min(pow2(dim0), threads // height), height


def gn_plan(S: int, N: int, c: int, sms: int = H100_SMS) -> tuple[int, int]:
    """How PyTorch's CUDA reduction splits each output of _gn_refine's sum
    over the points: (threads a block along the points, blocks). The sum
    of (S, N, *) terms into (S, c) outputs over dim -3, c = 36 for H and 6
    for g (setReduceConfig in ATen/native/cuda/Reduce.cuh, read for this
    shape: the outputs are the fastest axis, vectorised by v; a block of
    512 / v threads; the points are split among block_height threads when
    each would otherwise add min(16 block_height, 256) of them or more, and
    among blocks as well when each thread would still add 256 or more and
    the grid is small against the card's `sms` multiprocessors). (1, 1):
    one thread adds all N. The kernel sums in the same order
    (csrc/ransac_pnp.cu column_sum, wide_gn_sum)."""
    v = 4
    while c % v:
        v //= 2
    threads = 512 // v
    outputs = S * c // v
    width, height = _block_dims(outputs, N, threads)
    if N < min(16 * height, 256):
        return 1, 1
    per = -(-N // height)
    grid = -(-outputs // width)
    target = sms * (_THREADS_PER_SM // (width * height))
    if per >= 256 and grid <= target:
        ctas = max(min(-(-target // grid), -(-per // 16)), -(-per // 256))
        return height, ctas
    return height, 1


def gn_split(S: int, N: int, c: int) -> int:
    """Threads along the points of each block of _gn_refine's sum (gn_plan);
    up to N = 128 one block holds them all."""
    return gn_plan(S, N, c)[0]


def sum_width(outputs: int, N: int) -> int:
    """The threads among which PyTorch's CUDA reduction splits each output
    of a torch.sum over the contiguous last axis of a float32 (outputs, N),
    N >= 128 (setReduceConfig: the input vectorised by 4, the threads along
    it a block_width); the plain path's MSAC scores sum (S, H + P, N) this
    way, a chain's score (S, N). ValueError where the sum would also be
    split among warps (a thread adding min(16 block_height, 256) values or
    more), which the kernel does not repeat."""
    width, height = _block_dims(N // 4, outputs, 512)
    if -(-N // width) >= min(16 * height, 256):
        raise ValueError(f"a sum of {N} slots into {outputs} outputs splits among warps")
    return width


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_split(S: int, N: int, H: int, P: int, sms: int = H100_SMS) -> tuple:
    """The kernel's reduction arguments: (bh_H, bh_g, ct_H, ct_g, bw_h,
    bw_s), the Gauss-Newton sums' threads and blocks (gn_plan) and, past
    NARROW_N, the sums over the slots' widths (sum_width; 32 unused up to
    it). ValueError for a split the kernel does not repeat."""
    (bh_H, ct_H), (bh_g, ct_g) = gn_plan(S, N, 36, sms), gn_plan(S, N, 6, sms)
    if N <= NARROW_N:
        return bh_H, bh_g, 1, 1, 32, 32
    for bh, ct in ((bh_H, ct_H), (bh_g, ct_g)):
        if bh * ct > KERNEL_MAX_PARTS or (ct > 1 and bh > 8):
            raise ValueError(f"a Gauss-Newton sum of {S} x {N} points splits {bh} x {ct} ways")
    return bh_H, bh_g, ct_H, ct_g, sum_width(S * (H + P), N), sum_width(S, N)


def kernel_shapes(K, Xw, uv, valid, noise, params: RansacParams, T_init=None):
    """(S, N, H, P) of a kernel call, or ValueError naming the limit the
    call passes: float32 and bool inputs of one leading shape, 6 <= N <=
    2048, at most 8 rounds in either LO schedule, 1 to 65535 streams."""
    H = params.num_hypotheses
    lead = tuple(Xw.shape[:-2])
    N = Xw.shape[-2] if Xw.dim() >= 2 else 0
    S = math.prod(lead)
    want = {"Xw": (Xw, lead + (N, 3)), "uv": (uv, lead + (N, 2)), "valid": (valid, lead + (N,)),
            "noise": (noise, lead + (H, N)), "K": (K, (3, 3))}
    P = 0
    if T_init is not None:
        many = T_init.dim() == len(lead) + 3  # (..., P, 4, 4), else one prior (..., 4, 4)
        P = T_init.shape[-3] if many else 1
        want["T_init"] = (T_init, lead + ((P,) if many else ()) + (4, 4))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != (torch.bool if name == "valid" else torch.float32):
            raise ValueError(f"{name}: the kernel takes float32 (valid: bool), got {t.dtype}")
    if not 6 <= N <= KERNEL_MAX_N:
        raise ValueError(f"the kernel takes 6 <= N <= {KERNEL_MAX_N} correspondences, got {N}")
    if not 1 <= S <= KERNEL_MAX_STREAMS:
        raise ValueError(f"the kernel takes 1 to {KERNEL_MAX_STREAMS} streams, got {S}")
    if H < 1:
        raise ValueError(f"num_hypotheses must be at least 1, got {H}")
    if params.refine_iters < 0:
        raise ValueError(f"refine_iters must be >= 0, got {params.refine_iters}")
    for name, n in (("lo_rounds", params.lo_rounds), ("lo_anneal", len(params.lo_anneal))):
        if not 0 <= n <= KERNEL_MAX_SCHEDULE:
            raise ValueError(f"the kernel takes at most {KERNEL_MAX_SCHEDULE} {name}, got {n}")
    kernel_split(S, N, H, P)
    return S, N, H, P


class KernelStages(NamedTuple):
    """What a kernel call keeps besides its result, per stream: each
    hypothesis's index set, every scored pose (H DLT poses, then the P
    priors) with its MSAC score, the winner, and every LO chain's pose,
    strict count, score and inlier mask (prior i strict at 2i, annealed at
    2i + 1, the winner's at 2P)."""
    idx: torch.Tensor      # (..., H, 6) int32
    T_h: torch.Tensor      # (..., H + P, 4, 4) world->camera
    msac: torch.Tensor     # (..., H + P)
    best: torch.Tensor     # (...,) int32
    T_lo: torch.Tensor     # (..., 2P + 1, 4, 4)
    count_lo: torch.Tensor  # (..., 2P + 1) float32, whole numbers
    score_lo: torch.Tensor  # (..., 2P + 1)
    inliers_lo: torch.Tensor  # (..., 2P + 1, N) bool


_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the LO gates: host arrays of C floats
_fp = ctypes.POINTER(_f)
# counted: its launches and the correspondence slots handed to it (S x N a call)
_RANSAC_PNP = _build.entry("svo_ransac_pnp", [
    _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _fp, _i, _fp, _i, _f, _f, _i, _i, _i, _i, _i, _i,
    _p, _p, _p, _p, _p, _p, _p, _p, _p, _p,
], "ransac_pnp", counts=("launches", "slots"))


def ransac_pnp_kernel(K, Xw, uv, valid, noise, params: RansacParams, T_init=None,
                      stages: bool = False):
    """ransac_pnp on CUDA tensors through csrc/ransac_pnp.cu: two launches
    for all streams, on the current stream, with no host read (so a CUDA
    graph captures it). A shape the kernel does not take raises ValueError
    before anything is built or launched. stages=True also returns the
    KernelStages, to check the kernel stage by stage."""
    S, N, H, P = kernel_shapes(K, Xw, uv, valid, noise, params, T_init)
    dev = Xw.device
    for name, t in (("K", K), ("uv", uv), ("valid", valid), ("noise", noise), ("T_init", T_init)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, Xw on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on a CUDA device, not {dev}")
    kp = kernel_params(params)
    split = kernel_split(S, N, H, P, _sms(dev.index if dev.index is not None
                                          else torch.cuda.current_device()))
    lead = tuple(Xw.shape[:-2])
    K, Xw, uv, valid, noise = (t.contiguous() for t in (K, Xw, uv, valid, noise))
    T0 = T_init.contiguous() if P else None
    f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
    hyp = torch.empty((S, H + P, 17), **f32)
    chain = torch.empty((S, 2 * P + 1, 18), **f32)
    cmask = torch.empty((S, 2 * P + 1, N), dtype=torch.bool, device=dev)
    best = torch.empty((S,), **i32)
    idx = torch.empty((S, H, 6), **i32)
    T_wc = torch.empty(lead + (4, 4), **f32)
    inliers = torch.empty(lead + (N,), dtype=torch.bool, device=dev)
    ratio = torch.empty(lead, **f32)
    ok = torch.empty(lead, dtype=torch.bool, device=dev)
    floats = lambda v: (ctypes.c_float * max(len(v), 1))(*v)  # noqa: E731
    _build.launch(
        _RANSAC_PNP, dev,
        K.data_ptr(), Xw.data_ptr(), uv.data_ptr(), valid.data_ptr(), noise.data_ptr(),
        T0.data_ptr() if P else None, S, N, H, P, kp.iters,
        floats(kp.strict), len(kp.strict), floats(kp.anneal), len(kp.anneal),
        kp.thr2, kp.margin, *split, hyp.data_ptr(), chain.data_ptr(), cmask.data_ptr(),
        best.data_ptr(), idx.data_ptr(), T_wc.data_ptr(), inliers.data_ptr(),
        ratio.data_ptr(), ok.data_ptr(), launches=2,
    )
    _build.count("ransac_pnp.slots", S * N)
    result = PnPResult(T_wc=T_wc, inliers=inliers, inlier_ratio=ratio, ok=ok)
    if not stages:
        return result
    return result, KernelStages(
        idx=idx.reshape(lead + (H, 6)),
        T_h=hyp[..., :16].reshape(lead + (H + P, 4, 4)),
        msac=hyp[..., 16].reshape(lead + (H + P,)),
        best=best.reshape(lead),
        T_lo=chain[..., :16].reshape(lead + (2 * P + 1, 4, 4)),
        count_lo=chain[..., 16].reshape(lead + (2 * P + 1,)),
        score_lo=chain[..., 17].reshape(lead + (2 * P + 1,)),
        inliers_lo=cmask.reshape(lead + (2 * P + 1, N)),
    )


def ransac_pnp(
    K: torch.Tensor,
    Xw: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    noise: torch.Tensor,
    params: RansacParams,
    T_init: torch.Tensor | None = None,
) -> PnPResult:
    """Robust pose from N (masked) 3D->2D correspondences (ransac_pnp_ref
    states the contract). Xw's device picks the path: the kernel on a CUDA
    tensor (a shape it does not take raises ValueError, never a fall back
    to the plain path), the plain version on a CPU tensor."""
    if Xw.device.type == "cpu":
        return ransac_pnp_ref(K, Xw, uv, valid, noise, params, T_init)
    if Xw.device.type != "cuda":
        raise ValueError(f"unsupported device {Xw.device}")
    return ransac_pnp_kernel(K, Xw, uv, valid, noise, params, T_init)
