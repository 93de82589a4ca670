"""(vobench's frozen copy: the wrapper below runs the plain version on every
device; the CUDA kernel is not launched.)

The fused pyramidal-LK engine: a whole tracker call in one launch.

Port of svo_tpu/ops/lk_pallas.py::lk_track_level. On a CUDA tensor the
wrappers launch the hand-written kernel csrc/lk_level.cu; on a CPU tensor
they run the plain PyTorch versions beside them (the CPU tests' path, and
what chip_smoke.py holds the kernel against on the card).

Two entries, one kernel:

- lk_track_level, the counterpart of the TPU kernel: ONE pyramid level per
  launch (plain version lk_track_level_ref). The tracker takes it for a
  fused level outside a run.
- lk_track_pyramid: a run of consecutive levels, coarse to fine down to
  level 0, in ONE launch (plain version lk_track_pyramid_ref). The TPU
  kernel is one level per call because one call has one image shape; on
  the card the kernel takes a table of level pointers, and what the
  tracker did in small tensor ops between two levels (scale the position,
  double the guess, add the level's flow, and the status) happens per
  feature in registers. lk_track_pyramid_chain states that glue once, over
  any per-level function: with lk_track_level_ref it is the plain version,
  with lk_track_level it is the chain of per-level launches, to which the
  whole-call launch is bit-equal on the card.

What bounds a call on the card: neither bytes nor operations (a temporal
call of 128 features moves ~6 MB and does ~26 Mflop over four levels) but
its launch, this wrapper's host work, and the latency of one feature's
serial chain through the levels. So the design is fewer launches (one a
call), no device op in the wrapper beyond the output's allocation and two
views, and inside the kernel async staging with the next level's templates
copied ahead (csrc/lk_level.cu has the details and why TMA does not apply).

The geometry is the TPU kernel's, not that of the patch path in ops/klt.py:

- corners: the template window's top-left t = pos - (w-1)/2 at
  (clip(floor(t_y), 0, H-py), clip(floor(t_x), 0, W-64)); the current
  window's at floor(c) - margin with c = pos + guess - (w-1)/2, clipped the
  same way. No 8-row alignment; 64 is the TPU kernel's scratch width and
  W is the padded level's width.
- the template offset inside its window is clipped to [0, 2]; whether it
  had to be is part of `solvable`.
- iterations move the current offset inside a travel box of 2*margin px
  per axis; a feature that leaves it stops (conv = min(conv + small +
  (1 - in_patch), 1)); the final box test allows 1 px of slack.
- bilinear samples blend along x first, then y, with the hat weights
  max(0, 1 - |o - tap|) of the TPU kernel.
- a dead slot (valid False) has zero windows: its d equals the guess, its
  min_eig is 0 and it is not solvable.

The result d is relative to the guess as in svo_tpu: d = guess + (of - o0).

The stream axis: images (S, H, W) with pos/guess (S, N, 2) and valid (S, N)
give d (S, N, 2) and (S, N) flags from ONE launch over S*N features (the
TPU kernel's batched rule, lk_pallas.py::_batched). Images (H, W) with
(N, 2) positions are one stream.
"""

from __future__ import annotations


import torch

from vobench.reference.ops.index import gather_hw

PX = 64      # lk_pallas._PX: the column budget the corners are clipped by
_T_MAX = 2.0  # lk_pallas._TT_T - 2: the template offset's clip
MAX_LEVELS = 8  # csrc/lk_level.cu kMaxLevels: the kernel's level table


def _check(prev, gx, gy, curr, pos, guess, valid, *, window, py, margin_x, margin_y):
    """svo_tpu's preconditions (lk_pallas.py:534-539), plus what the
    kernel reads: four f32 images of one shape, (H, W) or (S, H, W), with
    H >= py, and pos/guess/valid with the same leading axis."""
    imgs = (prev, gx, gy, curr)
    shape = tuple(prev.shape)
    if len(shape) not in (2, 3):
        raise ValueError(f"images must be (H, W) or (S, H, W), got {shape}")
    H, W = shape[-2:]
    for im in imgs:
        if im.dtype != torch.float32 or tuple(im.shape) != shape:
            raise ValueError(
                f"images must be four float32 tensors of one shape (H, W) or "
                f"(S, H, W), got {[(tuple(i.shape), i.dtype) for i in imgs]}"
            )
        if im.device != prev.device:
            raise ValueError("images lie on different devices")
    lead = shape[:-2]
    if valid.dim() != len(lead) + 1 or tuple(valid.shape[:-1]) != lead or valid.dtype != torch.bool:
        raise ValueError(
            f"valid must be a bool tensor (N,) for (H, W) images and (S, N) for "
            f"(S, H, W), got {tuple(valid.shape)} {valid.dtype} for images {shape}"
        )
    want = tuple(valid.shape) + (2,)
    for name, t in (("pos", pos), ("guess", guess)):
        if tuple(t.shape) != want or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {want} float32, got {tuple(t.shape)} {t.dtype}")
        if t.device != prev.device:
            raise ValueError(f"{name} lies on {t.device}, the images on {prev.device}")
    if valid.device != prev.device:
        raise ValueError(f"valid lies on {valid.device}, the images on {prev.device}")
    if ((W + 127) // 128) * 128 < 256:
        raise ValueError(f"image too narrow: W={W}")
    if py % 8:
        raise ValueError(f"py={py} must be a multiple of 8")
    if py < window + 2 * margin_y:
        raise ValueError(f"py={py} < window {window} + 2 * margin_y {margin_y}")
    if PX < window + 2 * margin_x + 1:
        raise ValueError(f"window {window} + 2 * margin_x {margin_x} + 1 > {PX}")
    if 2 * max(margin_x, margin_y) + 2 > 65:
        raise ValueError(f"margins {margin_x}/{margin_y} too large")
    if H < py:
        raise ValueError(f"level height {H} < py {py}")


def _corner(v: torch.Tensor, margin: int, hi: int) -> torch.Tensor:
    """clip(floor(v) - margin, 0, hi) as int64; the clamp comes after the
    cast, so a non-finite v still lands in range."""
    return torch.clamp(torch.floor(v).long() - margin, 0, hi)


def _sample(img, iy, ix, ox, oy, w: int, max_off: tuple[int, int], live):
    """(..., N, w, w) bilinear samples of img at rows iy + oy + r, cols
    ix + ox + c: x blended first, then y, with hat weights. Offsets lie in
    [0, max_off] (or are NaN); the tap after the last one has weight 0 and
    is read clamped to the image. Dead slots come back zero."""
    H, W = img.shape[-2:]
    ar = torch.arange(w, device=img.device)

    def taps(o, hi):
        a = torch.floor(o).long().clamp(0, hi)
        af = a.to(torch.float32)
        w0 = torch.clamp(1.0 - torch.abs(o - af), min=0.0)
        w1 = torch.clamp(1.0 - torch.abs(o - (af + 1.0)), min=0.0)
        return a, w0[..., None, None], w1[..., None, None]

    ax, wx0, wx1 = taps(ox, max_off[0])
    ay, wy0, wy1 = taps(oy, max_off[1])
    r = (iy + ay)[..., None, None] + ar[:, None]
    c = (ix + ax)[..., None, None] + ar[None, :]
    r0, r1 = torch.clamp(r, max=H - 1), torch.clamp(r + 1, max=H - 1)
    c0, c1 = torch.clamp(c, max=W - 1), torch.clamp(c + 1, max=W - 1)
    top = wx0 * gather_hw(img, r0, c0) + wx1 * gather_hw(img, r0, c1)
    bot = wx0 * gather_hw(img, r1, c0) + wx1 * gather_hw(img, r1, c1)
    return torch.where(live[..., None, None], wy0 * top + wy1 * bot, 0.0)


def lk_track_level_ref(
    prev, gx, gy, curr, pos, guess, valid, *, window: int, py: int,
    max_iters: int, eps: float, min_eig_threshold: float,
    margin_x: int = 6, margin_y: int = 6,
):
    """Plain PyTorch version of the fused level; same arguments and
    results as lk_track_level."""
    H, W = prev.shape[-2:]
    w = window
    half = (w - 1) / 2.0
    Rx, Ry = float(2 * margin_x), float(2 * margin_y)
    t_tl = pos - half
    c_tl = pos + guess - half
    t_iy = _corner(t_tl[..., 1], 0, H - py)
    t_ix = _corner(t_tl[..., 0], 0, W - PX)
    c_iy = _corner(c_tl[..., 1], margin_y, H - py)
    c_ix = _corner(c_tl[..., 0], margin_x, W - PX)
    t_ox = t_tl[..., 0] - t_ix.to(torch.float32)
    t_oy = t_tl[..., 1] - t_iy.to(torch.float32)
    o0x = c_tl[..., 0] - c_ix.to(torch.float32)
    o0y = c_tl[..., 1] - c_iy.to(torch.float32)
    t_in = (t_ox >= 0.0) & (t_ox <= _T_MAX) & (t_oy >= 0.0) & (t_oy <= _T_MAX)
    t_ox = torch.clamp(t_ox, 0.0, _T_MAX)
    t_oy = torch.clamp(t_oy, 0.0, _T_MAX)

    t_box = (int(_T_MAX), int(_T_MAX))
    T = _sample(prev, t_iy, t_ix, t_ox, t_oy, w, t_box, valid)
    Tx = _sample(gx, t_iy, t_ix, t_ox, t_oy, w, t_box, valid)
    Ty = _sample(gy, t_iy, t_ix, t_ox, t_oy, w, t_box, valid)

    a11 = torch.sum(Tx * Tx, dim=(-2, -1))
    a12 = torch.sum(Tx * Ty, dim=(-2, -1))
    a22 = torch.sum(Ty * Ty, dim=(-2, -1))
    tr_half = (a11 + a22) * 0.5
    det = a11 * a22 - a12 * a12
    disc = torch.sqrt(torch.clamp(tr_half * tr_half - det, min=0.0))
    min_eig = (tr_half - disc) / float(w * w)
    inv_det = 1.0 / torch.where(det > 1e-12, det, 1.0)
    i11 = a22 * inv_det
    i12 = -a12 * inv_det
    i22 = a11 * inv_det
    eps2 = eps * eps

    c_box = (2 * margin_x, 2 * margin_y)
    ox, oy = o0x, o0y
    conv = torch.zeros_like(ox)
    for _ in range(max_iters):
        in_patch = ((ox >= 0.0) & (ox <= Rx) & (oy >= 0.0) & (oy <= Ry)).to(torch.float32)
        Iw = _sample(
            curr, c_iy, c_ix, torch.clamp(ox, 0.0, Rx), torch.clamp(oy, 0.0, Ry),
            w, c_box, valid,
        )
        diff = Iw - T
        b1 = torch.sum(diff * Tx, dim=(-2, -1))
        b2 = torch.sum(diff * Ty, dim=(-2, -1))
        du = -(i11 * b1 + i12 * b2)
        dv = -(i12 * b1 + i22 * b2)
        active = (1.0 - conv) * in_patch
        ox = ox + active * du
        oy = oy + active * dv
        small = (du * du + dv * dv < eps2).to(torch.float32)
        conv = torch.clamp(conv + small + (1.0 - in_patch), max=1.0)

    solvable = (min_eig > min_eig_threshold) & (det > 1e-12) & t_in & valid
    in_fin = (ox >= -1.0) & (ox <= Rx + 1.0) & (oy >= -1.0) & (oy <= Ry + 1.0)
    d = guess + torch.stack([ox - o0x, oy - o0y], dim=-1)
    return d, min_eig, solvable, in_fin


def lk_track_level(
    prev: torch.Tensor,
    gx: torch.Tensor,
    gy: torch.Tensor,
    curr: torch.Tensor,
    pos: torch.Tensor,
    guess: torch.Tensor,
    valid: torch.Tensor,
    *,
    window: int,
    py: int,
    max_iters: int,
    eps: float,
    min_eig_threshold: float,
    margin_x: int = 6,
    margin_y: int = 6,
):
    """Run one fused LK level. Returns (d, min_eig, solvable, in_patch):
    d (N, 2) is the updated flow (guess + iterations), the flags (N,) bool.

    prev/gx/gy/curr: padded level images (see ops/klt.py); pos: (N, 2)
    positions in padded level coordinates; guess: (N, 2) flow in; valid:
    (N,) bool. With (S, H, W) images every other argument and result has
    the leading S too, and the card runs one launch whatever S is.
    margin_x/margin_y: the per-axis travel budget is 2*margin px. Positions
    of features whose status ends False carry no meaning."""
    kw = dict(window=window, py=py, margin_x=margin_x, margin_y=margin_y)
    _check(prev, gx, gy, curr, pos, guess, valid, **kw)
    return lk_track_level_ref(
        prev, gx, gy, curr, pos, guess, valid, max_iters=max_iters, eps=eps,
        min_eig_threshold=min_eig_threshold, **kw,
    )



def lk_track_pyramid_chain(
    level_fn, prev_levels, grad_levels, curr_levels, pos, guess0, valid, *,
    window: int, pys, iters, eps: float, min_eig_threshold: float,
    margin_x: int = 6, margin_y: int = 6, pad_x: int = 0, pad_y: int = 0,
):
    """A run of levels through `level_fn` (lk_track_level or its plain
    version), one call per level from the coarsest of the run down to level
    0, with the tracker's glue between them in tensor ops. Arguments and
    results as lk_track_pyramid."""
    guess, status, min_eig = guess0, valid, None
    for level in range(len(prev_levels) - 1, -1, -1):
        H, W = prev_levels[level].shape[-2:]
        p_lvl = pos / (2.0 ** level)
        guess = guess * 2.0
        p_pad = torch.stack([p_lvl[..., 0] + pad_x, p_lvl[..., 1] + pad_y], dim=-1)
        d, min_eig, solvable, in_fin = level_fn(
            prev_levels[level], *grad_levels[level], curr_levels[level],
            p_pad, guess, status, window=window, py=pys[level],
            max_iters=iters[level], eps=eps, min_eig_threshold=min_eig_threshold,
            margin_x=margin_x, margin_y=margin_y,
        )
        q = p_lvl + d
        inside = (
            (q[..., 0] >= 0) & (q[..., 0] < W - 2 * pad_x)
            & (q[..., 1] >= 0) & (q[..., 1] < H - 2 * pad_y)
        )
        status = status & solvable & inside & in_fin
        guess = d
    return guess, min_eig, status


def lk_track_pyramid_ref(prev_levels, grad_levels, curr_levels, pos, guess0, valid, **kw):
    """Plain PyTorch version of lk_track_pyramid: the chain of
    lk_track_level_ref calls; same arguments and results."""
    return lk_track_pyramid_chain(
        lk_track_level_ref, prev_levels, grad_levels, curr_levels, pos, guess0, valid, **kw
    )


def lk_track_pyramid(
    prev_levels,
    grad_levels,
    curr_levels,
    pos: torch.Tensor,
    guess0: torch.Tensor,
    valid: torch.Tensor,
    *,
    window: int,
    pys,
    iters,
    eps: float,
    min_eig_threshold: float,
    margin_x: int = 6,
    margin_y: int = 6,
    pad_x: int = 0,
    pad_y: int = 0,
):
    """Run the fused LK levels L-1 .. 0 of one tracker call in one launch.
    Returns (d, min_eig, status): d (N, 2) the level-0 flow, min_eig (N,)
    that of level 0, status (N,) bool.

    prev_levels / curr_levels: the L padded level images, level 0 first;
    grad_levels: L pairs (gx, gy) of the previous image's levels; pos:
    (N, 2) level-0 positions in TRUE image coordinates (level l works at
    pos / 2**l + (pad_x, pad_y)); guess0: (N, 2) flow in, at twice the top
    level's scale (it is doubled on entering every level); valid: (N,)
    bool; pys / iters: per level, the row budget and the iteration count.
    Per level: d = guess + the level's flow; status &= solvable & in_patch
    & (pos / 2**l + d inside the true level image, the padded size less
    2*pad per axis); a slot whose status fell is a dead slot further down
    and keeps its flow. With (S, H, W) levels every other argument and
    result has the leading S too, and the card runs one launch whatever S
    is."""
    L = len(prev_levels)
    if not (1 <= L <= MAX_LEVELS) or not (
        len(grad_levels) == len(curr_levels) == len(pys) == len(iters) == L
    ):
        raise ValueError(
            f"need 1..{MAX_LEVELS} levels with a gradient pair, a current image, a "
            f"py and an iteration count each, got {L} / {len(grad_levels)} / "
            f"{len(curr_levels)} / {len(pys)} / {len(iters)}"
        )
    geom = dict(window=window, margin_x=margin_x, margin_y=margin_y)
    for level in range(L):
        _check(prev_levels[level], *grad_levels[level], curr_levels[level],
               pos, guess0, valid, py=pys[level], **geom)
    kw = dict(pys=pys, iters=iters, eps=eps, min_eig_threshold=min_eig_threshold,
              pad_x=pad_x, pad_y=pad_y, **geom)
    return lk_track_pyramid_ref(prev_levels, grad_levels, curr_levels, pos, guess0, valid, **kw)

