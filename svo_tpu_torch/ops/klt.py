"""Batched pyramidal Lucas-Kanade optical flow.

Port of svo_tpu/ops/klt.py (KltTracker, _track_impl, _corners, _blend) on
its default path: per pyramid level (_patch_level), one rectangular patch
per feature and image is extracted (template + its two gradients at the
feature's integer corner, current image at the flow-predicted corner) by
ops/klt_patches.extract_klt_patches; then all LK iterations run densely on
the (N, PY, PX) patches with bilinear sampling and a per-feature
convergence mask (converged features stop moving, as cv2's eps exit). That
composition, with the glue between levels (ops/klt_track.klt_track_chain),
is the plain path; on the card the whole call is ONE launch of
ops/klt_track.klt_track (csrc/klt_track.cu), bit-equal to it.

engine="fused" runs svo_tpu's other engine, the fused LK level
(ops/lk_fused.py, svo_tpu/ops/lk_pallas.py). Which levels take it is
svo_tpu's rule (_fused_level_ok). The maximal run of consecutive levels
that ends at level 0 and passes the rule is ONE call of
lk_fused.lk_track_pyramid, so one kernel launch on the card: extraction,
template sampling, all iterations of every level of the run and the glue
between levels, returning the level-0 flow, min_eig and status only. At
376x1241 every level is in the run, so a temporal or a stereo call is one
launch and the level-0 forward-backward call another. Levels above the run
(small top levels that fail the rule, as L3 at 128x384) go one by one: the
patch path's one-level launch (klt_track.klt_track_level), or
lk_fused.lk_track_level for a level that passes the rule with a failing
one below it. A tracker call on the card is bound by the
host's launches, not by bytes or operations, which is why the level loop
lives in the kernel.

One difference to the CPU path of svo_tpu: that path slices dead slots'
patches like live ones, while the extraction kernel (here, and svo_tpu's
TPU kernel) zeroes them, so a dead feature's position stops moving. Only
positions whose status is True carry meaning in either.

The stream axis: every function takes leading axes before the feature axis
(pos (..., N, 2), valid (..., N), pyramid levels (..., H, W)), so S streams
are tracked by the same ops as one, and each tracker call (or fused run)
is one kernel launch for all of them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svo_tpu_torch.config import KltParams
from svo_tpu_torch.ops import klt_track, lk_fused
from svo_tpu_torch.ops.klt_patches import extract_klt_patches
from svo_tpu_torch.ops.pyramid import klt_pyramid, pad_replicate, scharr_gradients


class KltResult(NamedTuple):
    pos: torch.Tensor     # (N, 2) tracked positions (x, y) in the new image
    status: torch.Tensor  # (N,) bool — survived tracking
    err: torch.Tensor     # (N,) min eigenvalue at level 0


# Pyramid levels are edge-replicate padded at build time, so a feature
# anywhere in the true image has a full patch around it.
_PAD_Y = 24
_PAD_X = 32
_MY = 6  # rows of upward iteration travel before the patch clamp binds
ENGINES = ("patches", "fused")


def _patch_rows(window: int) -> int:
    """Patch rows: window + y margin + up to 7 rows of corner alignment + 1
    bilinear slack, rounded up to 8."""
    return ((window + _MY + 9 + 7) // 8) * 8


def _level_rows(window: int, H: int) -> int:
    """Patch rows for a level of height H: the full budget when it fits,
    else the largest multiple of 8 that still holds a valid template; 0 if
    the level is too small (the caller skips it)."""
    py = _patch_rows(window)
    while py > H - 1:
        py -= 8
    if py < window + _MY + 9:
        return 0
    return py


def _patch_cols(window: int, margin_x: int) -> int:
    """Patch cols: window + left margin + ~12 px of positive-x travel +
    bilinear slack, rounded up to 8."""
    return ((window + margin_x + 13 + 7) // 8) * 8


def _fused_level_ok(H: int, W: int, py: int, window: int, margin_x: int) -> bool:
    """svo_tpu's per-level rule for the fused engine (svo_tpu/ops/klt.py:
    262-267) without its TPU and environment terms. W > 128 is the TPU
    kernel's two-lane-tile read, which the CUDA kernel does not need; the
    rule is kept so that a level picks the engine svo_tpu picks."""
    return (
        W > 128
        and H >= py
        and py >= window + 2 * _MY
        and lk_fused.PX >= window + 2 * margin_x + 1
    )


def _inside(pt: torch.Tensor, W: int, H: int) -> torch.Tensor:
    return (pt[..., 0] >= 0) & (pt[..., 0] < W) & (pt[..., 1] >= 0) & (pt[..., 1] < H)


def _corners(pos, guess, H: int, W: int, py: int, px: int, w: int, mx: int):
    """Integer patch corners for the template (at pos) and current (at
    pos+guess) patches: the window's top-left minus a margin. y corners
    are aligned down to a multiple of 8, as svo_tpu aligns them for the
    TPU's sublanes; the fractional offsets downstream absorb the shift, so
    the port keeps it to stay numerically equal."""
    hw = (w - 1) // 2

    def corner(p):
        y0 = torch.clamp(
            torch.floor(p[..., 1]).to(torch.int32) - hw - _MY, 0, max(H - py, 0)
        )
        y0 = torch.div(y0, 8, rounding_mode="floor") * 8
        x0 = torch.clamp(
            torch.floor(p[..., 0]).to(torch.int32) - hw - mx, 0, max(W - px, 0)
        )
        return y0, x0

    ty0, tx0 = corner(pos)
    cy0, cx0 = corner(pos + guess)
    return ty0, tx0, cy0, cx0


def _blend(patches: torch.Tensor, offset: torch.Tensor, window: int) -> torch.Tensor:
    """Bilinear sample of (..., N, window, window) at fractional offset
    (..., N, 2) (x, y) inside (..., N, PY, PX) patches; the offset must lie
    in [0, P - window - 1] per axis. Rows blend first, then columns, as
    svo_tpu's two one-hot contractions S_y @ patch @ S_x^T; this gathers the
    four taps instead of multiplying by one-hot matrices."""
    PY, PX = patches.shape[-2:]
    w = window
    ox, oy = offset[..., 0], offset[..., 1]
    # clamp after the cast as well: a NaN offset must not index out of range
    ix = torch.floor(ox).long().clamp(0, PX - w - 1)
    iy = torch.floor(oy).long().clamp(0, PY - w - 1)
    fx = (ox - ix)[..., None, None]
    fy = (oy - iy)[..., None, None]
    ar = torch.arange(w, device=patches.device)
    base = (
        (iy[..., None, None] + ar[:, None]) * PX + (ix[..., None, None] + ar[None, :])
    ).flatten(-2)                        # (..., N, w*w) into each feature's patch
    flat = patches.flatten(-2)           # (..., N, PY*PX)

    def tap(shift: int):
        return torch.gather(flat, -1, base + shift).unflatten(-1, (w, w))

    p00, p01 = tap(0), tap(1)
    p10, p11 = tap(PX), tap(PX + 1)
    left = p00 * (1.0 - fy) + p10 * fy
    right = p01 * (1.0 - fy) + p11 * fy
    return left * (1.0 - fx) + right * fx


def _in_box(off: torch.Tensor, max_x: float, max_y: float, lo: float = 0.0):
    return (
        (off[..., 0] >= lo)
        & (off[..., 0] <= max_x - lo)
        & (off[..., 1] >= lo)
        & (off[..., 1] <= max_y - lo)
    )


def _clip_off(off: torch.Tensor, max_x: float, max_y: float) -> torch.Tensor:
    return torch.stack(
        [torch.clamp(off[..., 0], 0.0, max_x), torch.clamp(off[..., 1], 0.0, max_y)],
        dim=-1,
    )


def _patch_level(
    img_prev, gx, gy, img_curr, p_lvl, p_pad, guess, status, *, w: int, py: int, px: int,
    margin_x: int, iters: int, eps2: float, min_eig_threshold: float,
):
    """One level of the patches engine: extraction, template blend, the 2x2
    system and `iters` masked updates. Returns (d, status, min_eig)."""
    H, W = img_prev.shape[-2:]     # padded dims (see build_pyramid)
    Ht, Wt = H - 2 * _PAD_Y, W - 2 * _PAD_X  # true level dims
    half = (w - 1) / 2.0
    max_off_x = px - w - 1.0
    max_off_y = py - w - 1.0

    ty0, tx0, cy0, cx0 = _corners(p_pad, guess, H, W, py, px, w, margin_x)
    t_patch, gx_patch, gy_patch, c_patch = extract_klt_patches(
        img_prev, gx, gy, img_curr, ty0, tx0, cy0, cx0, status, py=py, px=px,
    )

    # fractional window offsets inside the patches
    t_base = torch.stack([tx0, ty0], -1).to(torch.float32)
    c_base = torch.stack([cx0, cy0], -1).to(torch.float32)
    t_off = p_pad - half - t_base
    t_in = _in_box(t_off, max_off_x, max_off_y)
    t_off_cl = _clip_off(t_off, max_off_x, max_off_y)

    T = _blend(t_patch, t_off_cl, w)
    Tx = _blend(gx_patch, t_off_cl, w)
    Ty = _blend(gy_patch, t_off_cl, w)

    # 2x2 normal matrix, once per level (like cv2)
    a11 = torch.sum(Tx * Tx, dim=(-2, -1))
    a12 = torch.sum(Tx * Ty, dim=(-2, -1))
    a22 = torch.sum(Ty * Ty, dim=(-2, -1))
    tr_half = (a11 + a22) * 0.5
    disc = torch.sqrt(torch.clamp(tr_half * tr_half - (a11 * a22 - a12 * a12), min=0.0))
    min_eig = (tr_half - disc) / float(w * w)
    det = a11 * a22 - a12 * a12
    solvable = (min_eig > min_eig_threshold) & (det > 1e-12)

    status = status & t_in & solvable

    inv_det = 1.0 / torch.where(det > 1e-12, det, 1.0)
    i11 = a22 * inv_det
    i12 = -a12 * inv_det
    i22 = a11 * inv_det

    # iterate: current window at p_lvl + d, converged features frozen
    d = guess
    conv = torch.zeros(d.shape[:-1], dtype=torch.bool, device=d.device)
    for _ in range(iters):
        c_off = p_pad + d - half - c_base
        in_patch = _in_box(c_off, max_off_x, max_off_y)
        Iw = _blend(c_patch, _clip_off(c_off, max_off_x, max_off_y), w)
        diff = Iw - T
        b1 = torch.sum(diff * Tx, dim=(-2, -1))
        b2 = torch.sum(diff * Ty, dim=(-2, -1))
        du = -(i11 * b1 + i12 * b2)
        dv = -(i12 * b1 + i22 * b2)
        active = (~conv) & in_patch
        d = torch.where(active[..., None], d + torch.stack([du, dv], dim=-1), d)
        conv = conv | (du * du + dv * dv < eps2) | (~in_patch)

    # lost if the final window left the patch (~left the search region)
    # or the TRUE image at this level
    inside_patch = _in_box(p_pad + d - half - c_base, max_off_x, max_off_y, lo=-1.0)
    status = status & _inside(p_lvl + d, Wt, Ht) & inside_patch
    return d, status, min_eig


def _track_impl(
    prev_levels, curr_levels, prev_grad_levels, pos, valid, init,
    window: int, max_level: int, max_iters: int, eps: float,
    min_eig_threshold: float, margin_x: int = 6, level_iters: tuple | None = None,
    engine: str = "patches",
) -> KltResult:
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} is not one of {ENGINES}")
    w = window
    px = _patch_cols(w, margin_x)

    def iters_of(level: int) -> int:
        if level_iters is None:
            return max_iters
        return min(max_iters, level_iters[min(level, len(level_iters) - 1)])

    # patch rows per level; 0: the level is too small for the patch and is
    # skipped, keeping the guess chain
    pys = []
    for level in range(max_level + 1):
        H, W = prev_levels[level].shape[-2:]
        pys.append(0 if W < px + 1 else _level_rows(w, H))
    # the fused run: levels 0 .. run-1, each passing svo_tpu's rule
    run = 0
    if engine == "fused":
        while run <= min(max_level, lk_fused.MAX_LEVELS - 1) and pys[run] and _fused_level_ok(
            *prev_levels[run].shape[-2:], pys[run], w, margin_x
        ):
            run += 1

    # the level-0 seed at the scale above the top level: doubled on entering it
    guess = torch.zeros_like(pos) if init is None else init / (2.0 ** (max_level + 1))
    kw = dict(window=w, pys=pys, px=px, iters=[iters_of(level) for level in range(max_level + 1)],
              eps=eps, min_eig_threshold=min_eig_threshold, margin_x=margin_x,
              pad_x=_PAD_X, pad_y=_PAD_Y)
    used = (prev_levels[:max_level + 1], prev_grad_levels[:max_level + 1],
            curr_levels[:max_level + 1])
    if engine == "patches":
        # every level in one launch
        guess, status, min_eig_out = klt_track.klt_track(*used, pos, guess, valid, **kw)
    else:
        def level_fn(img_prev, gx, gy, img_curr, p_lvl, p_pad, guess, status, *, py, iters,
                     **level_kw):
            H, W = img_prev.shape[-2:]
            if not _fused_level_ok(H, W, py, w, margin_x):
                return klt_track.klt_track_level(img_prev, gx, gy, img_curr, p_lvl, p_pad,
                                                 guess, status, py=py, iters=iters, **level_kw)
            # a fused level with a failing level below it: one launch of its own
            d, min_eig, solvable, in_fin = lk_fused.lk_track_level(
                img_prev, gx, gy, img_curr, p_pad, guess, status,
                window=w, py=py, max_iters=iters, eps=eps,
                min_eig_threshold=min_eig_threshold, margin_x=margin_x, margin_y=_MY,
            )
            status = (
                status & solvable
                & _inside(p_lvl + d, W - 2 * _PAD_X, H - 2 * _PAD_Y) & in_fin
            )
            return d, status, min_eig

        # levels above the run, one by one
        guess, status, min_eig_out = klt_track.klt_track_chain(
            level_fn, *used, pos, guess, valid, stop=run, **kw)
        if run:
            # the whole run, down to level 0, in one launch
            guess, min_eig_out, status = lk_fused.lk_track_pyramid(
                prev_levels[:run], prev_grad_levels[:run], curr_levels[:run],
                pos, guess, status, window=w, pys=pys[:run],
                iters=kw["iters"][:run], eps=eps,
                min_eig_threshold=min_eig_threshold, margin_x=margin_x, margin_y=_MY,
                pad_x=_PAD_X, pad_y=_PAD_Y,
            )

    if min_eig_out is None:  # level 0 was too small to run
        min_eig_out = torch.zeros(pos.shape[:-1], dtype=torch.float32, device=pos.device)
    new_pos = pos + guess
    # the final position must lie inside the level-0 image (cv2 kills these)
    H0 = prev_levels[0].shape[-2] - 2 * _PAD_Y
    W0 = prev_levels[0].shape[-1] - 2 * _PAD_X
    inside0 = (
        (new_pos[..., 0] >= 0)
        & (new_pos[..., 0] <= W0 - 1)
        & (new_pos[..., 1] >= 0)
        & (new_pos[..., 1] <= H0 - 1)
    )
    return KltResult(pos=new_pos, status=status & inside0, err=min_eig_out)


class KltTracker:
    """Pyramid-caching KLT front: build pyramids once per image, reuse them
    for stereo matching and temporal tracking."""

    @staticmethod
    def build_pyramid(img: torch.Tensor, max_level: int):
        """((levels...), ((gx, gy)...)) of the edge-padded pyramid of an
        (H, W) image or an (S, H, W) stack."""
        levels = [pad_replicate(l, _PAD_Y, _PAD_X) for l in klt_pyramid(img, max_level)]
        grads = [scharr_gradients(l) for l in levels]
        return tuple(levels), tuple(grads)

    @staticmethod
    def track(
        prev_pyr,
        curr_pyr,
        pos: torch.Tensor,
        valid: torch.Tensor,
        params: KltParams,
        init_flow: torch.Tensor | None = None,
        engine: str = "patches",
    ) -> KltResult:
        """Track (N, 2) features `pos` (mask `valid`) from prev to curr,
        optionally seeded with an (N, 2) level-0 displacement; with
        pyramids of (S, H, W) stacks, pos is (S, N, 2) and valid (S, N). engine:
        "patches" (svo_tpu's default) or "fused" (see the module doc)."""
        prev_levels, prev_grads = prev_pyr
        curr_levels, _ = curr_pyr
        return _track_impl(
            prev_levels,
            curr_levels,
            prev_grads,
            pos,
            valid,
            init_flow,
            window=params.window,
            max_level=params.max_level,
            max_iters=params.max_iters,
            level_iters=params.level_iters,
            eps=params.eps,
            min_eig_threshold=params.min_eig_threshold,
            margin_x=params.margin_x,
            engine=engine,
        )


def selftest_geometry(img: torch.Tensor, n: int, window: int, seed: int):
    """The self-test's inputs, as svo_tpu/ops/klt.py:434-490 makes them at
    level 0: the edge-padded image and its Scharr gradients, the patch size
    (py, px) of `window` with margin_x 6, and the corners (ty0, tx0, cy0,
    cx0) of n random positions and guesses drawn from
    np.random.default_rng(seed) in svo_tpu's order. Raises ValueError on an
    image too small for one patch."""
    import numpy as np

    img_p = pad_replicate(img, _PAD_Y, _PAD_X)
    gx, gy = scharr_gradients(img_p)
    H, W = img_p.shape
    py, px = _level_rows(window, H), _patch_cols(window, 6)
    if py == 0 or W < px + 1:
        raise ValueError(f"image too small for the self-test: {tuple(img.shape)}")
    rng = np.random.default_rng(seed)
    pos = np.stack(
        [rng.uniform(0, W - 1, n).astype(np.float32), rng.uniform(0, H - 1, n).astype(np.float32)],
        axis=-1,
    )
    guess = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    corners = _corners(
        torch.from_numpy(pos).to(img.device), torch.from_numpy(guess).to(img.device),
        H, W, py, px, window, 6,
    )
    return (img_p, gx, gy), corners, py, px


def slice_windows(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, py: int, px: int):
    """(N, py, px) windows of an (H, W) image at (y0, x0), one slice per
    corner, the start clamped to [0, H-py] x [0, W-px] as
    jax.lax.dynamic_slice clamps it: the self-test's reference, sharing no
    code with extract_klt_patches or its plain version."""
    H, W = img.shape

    def window(y: int, x: int) -> torch.Tensor:
        y, x = min(max(y, 0), H - py), min(max(x, 0), W - px)
        return img[y:y + py, x:x + px]

    return torch.stack([window(y, x) for y, x in zip(y0.tolist(), x0.tolist())])


def patch_extraction_selftest(img, n: int = 64, window: int = 21, seed: int = 0) -> float:
    """Hold the patch extraction against a separate slicing of the same
    windows on a real (H, W) image and return the max |difference|
    (expected exactly 0.0). The counterpart of svo_tpu's self-test
    (bench.py records it as pallas_ab_max_diff): the tracker's level-0
    geometry (selftest_geometry), n features, all live. On a CUDA tensor
    extract_klt_patches launches csrc/klt_patches.cu; on a CPU tensor (or a
    numpy array) it runs its plain version, and either is compared with
    slice_windows, never with itself."""
    img = torch.as_tensor(img, dtype=torch.float32)
    (img_p, gx, gy), (ty0, tx0, cy0, cx0), py, px = selftest_geometry(img, n, window, seed)
    valid = torch.ones(n, dtype=torch.bool, device=img.device)
    got = extract_klt_patches(img_p, gx, gy, img_p, ty0, tx0, cy0, cx0, valid, py, px)
    want = [slice_windows(a, ty0, tx0, py, px) for a in (img_p, gx, gy)]
    want.append(slice_windows(img_p, cy0, cx0, py, px))
    return max(float(torch.max(torch.abs(g - w))) for g, w in zip(got, want))
