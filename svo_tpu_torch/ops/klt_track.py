"""The patches engine's tracker call in one launch.

On a CUDA tensor the wrappers launch the hand-written kernel
csrc/klt_track.cu; on a CPU tensor they run the plain PyTorch versions (the
CPU tests' path, and what the card tests and chip_smoke.py hold the kernel
against on the card). The plain versions are ops/klt.py's own level,
_patch_level (extraction, template blends, 2x2 system, masked iterations),
and klt_track_chain, the glue between levels; nothing here repeats them.

Two entries, one kernel:

- klt_track: every level of one tracker call, coarse to fine down to
  level 0, in ONE launch (plain version klt_track_ref, the chain of
  _patch_level calls). The patches engine's only launch a tracker call.
- klt_track_level: ONE level, _patch_level's arguments and results (plain
  version _patch_level itself). The fused engine takes it for a level
  above its run that fails svo_tpu's rule (small images only).

What bounds a call on the card: neither bytes nor operations but the
latency of one feature's serial chain through the levels and, before this
kernel, the ~650 small tensor ops a level issued from the host. The
kernel reproduces every rounding of those ops, the row sums in the order
PyTorch's reduction takes them (sum_plan), so it is bit-equal to the plain
path on the card.

The stream axis: images (S, H, W) with pos/guess (S, N, 2) and valid
(S, N) give (S, N, 2) flow and (S, N) status and min_eig from ONE launch
over S*N features. Images (H, W) with (N, 2) positions are one stream.
"""

from __future__ import annotations

import ctypes

import torch

from svo_tpu_torch import _build
from svo_tpu_torch.geometry.pnp import _block_dims

MAX_LEVELS = 8  # csrc/klt_track.cu kMaxLevels: the kernel's level table
_SMEM_FLOATS = 227 * 1024 // 4  # a block's shared memory; a warp takes one feature's
# the kernel's instantiations: threads a lane plays -> rounds of four it holds
_ROUNDS = {1: 8, 2: 4, 4: 2}


def sum_plan(window: int, rows: int) -> tuple[int, bool, int]:
    """How PyTorch's CUDA reduction splits torch.sum(x, dim=(-2, -1)) over
    a contiguous float32 (rows, window, window): (block_width threads along
    a row, whether it reads the row in 4-vectors, rounds of four a thread
    reads at most). setReduceConfig (ATen/native/cuda/Reduce.cuh): rows of
    128 floats or more are read in 4-vectors; the block's width and height
    as set_block_dimension gives them for 512 threads. ValueError where the
    kernel does not repeat the split: fewer than 32 or more than 128
    threads along a row, or a row split among warps as well."""
    ww = window * window
    vec = ww >= 128
    width, height = _block_dims(ww // 4 if vec else ww, rows, 512)
    if width < 32 or width // 32 not in _ROUNDS:
        raise ValueError(f"a {window}x{window} window's sum over {rows} rows takes "
                         f"{width} threads a row; the kernel repeats 32, 64 or 128")
    if -(-ww // width) >= min(16 * height, 256):
        raise ValueError(f"a {window}x{window} window's sum over {rows} rows splits among warps")
    rounds = -(-(ww // 4) // width) if vec else -(-ww // (4 * width))
    if rounds > _ROUNDS[width // 32]:
        raise ValueError(f"a {window}x{window} window's sum needs {rounds} rounds a thread")
    return width, vec, rounds


def _check(prev_levels, grad_levels, curr_levels, pos, guess, valid, *, window, pys, px):
    """Four float32 images of one shape a level, (H, W) or (S, H, W), on
    one device, each used level holding its py x px patch; pos and guess
    (..., N, 2) float32 and valid (..., N) bool with the images' leading
    axis."""
    lead = None
    for level, py in enumerate(pys):
        four = (prev_levels[level], *grad_levels[level], curr_levels[level])
        shape = tuple(four[0].shape)
        if len(shape) not in (2, 3):
            raise ValueError(f"images must be (H, W) or (S, H, W), got {shape}")
        if any(im.dtype != torch.float32 or tuple(im.shape) != shape for im in four):
            raise ValueError(
                f"level {level}: images must be four float32 tensors of one shape (H, W) or "
                f"(S, H, W), got {[(tuple(i.shape), i.dtype) for i in four]}")
        if any(im.device != pos.device for im in four):
            raise ValueError(f"level {level}: images lie on another device than pos ({pos.device})")
        if lead is None:
            lead = shape[:-2]
        elif shape[:-2] != lead:
            raise ValueError(f"level {level}: streams {shape[:-2]}, level 0 has {lead}")
        H, W = shape[-2:]
        if py and not (window + 2 <= py <= H and window + 2 <= px <= W):
            raise ValueError(f"level {level}: a {py}x{px} patch for window {window} "
                             f"does not fit the {H}x{W} image")
    if tuple(valid.shape[:-1]) != lead or valid.dim() != len(lead) + 1 or valid.dtype != torch.bool:
        raise ValueError(f"valid must be a bool tensor (N,) for (H, W) images and (S, N) for "
                         f"(S, H, W), got {tuple(valid.shape)} {valid.dtype}")
    want = tuple(valid.shape) + (2,)
    for name, t in (("pos", pos), ("guess", guess)):
        if tuple(t.shape) != want or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {want} float32, got {tuple(t.shape)} {t.dtype}")
    if guess.device != pos.device or valid.device != pos.device:
        raise ValueError("pos, guess and valid lie on different devices")


def _kernel_args(window: int, px: int, pys, rows: int):
    """The kernel's split arguments, or ValueError for a call it does not
    take (the window, the sum's split, the shared memory of a feature)."""
    # a feature's shared floats: three (window + 1)-row template windows
    # and its patch, at row stride px
    if (3 * (window + 1) + max(pys)) * px > _SMEM_FLOATS:
        raise ValueError(f"a feature's windows ({window}, {max(pys)}x{px}) exceed shared memory")
    return sum_plan(window, rows)


def klt_track_chain(level_fn, prev_levels, grad_levels, curr_levels, pos, guess, status, *,
                    window: int, pys, px: int, iters, eps: float, min_eig_threshold: float,
                    margin_x: int, pad_x: int, pad_y: int, stop: int = 0):
    """Levels len(prev_levels)-1 .. stop of a tracker call through
    `level_fn` (ops/klt.py::_patch_level's arguments and results), with the
    tracker's glue between them in tensor ops: p_lvl = pos / 2**level, the
    guess doubled, a level with py 0 skipped keeping the guess, p_pad =
    p_lvl + (pad_x, pad_y). Returns (guess, status, min_eig): the flow and
    status after level `stop`, min_eig of level 0 (None unless level 0
    ran)."""
    min_eig0 = None
    for level in range(len(prev_levels) - 1, stop - 1, -1):
        p_lvl = pos / (2.0 ** level)
        guess = guess * 2.0
        if pys[level] == 0:
            continue
        p_pad = torch.stack([p_lvl[..., 0] + pad_x, p_lvl[..., 1] + pad_y], dim=-1)
        guess, status, min_eig = level_fn(
            prev_levels[level], *grad_levels[level], curr_levels[level], p_lvl, p_pad, guess,
            status, w=window, py=pys[level], px=px, margin_x=margin_x, iters=iters[level],
            eps2=eps * eps, min_eig_threshold=min_eig_threshold,
        )
        if level == 0:
            min_eig0 = min_eig
    return guess, status, min_eig0


def klt_track_ref(prev_levels, grad_levels, curr_levels, pos, guess0, valid, **kw):
    """Plain PyTorch version of klt_track: the chain of _patch_level calls;
    same arguments and results."""
    from svo_tpu_torch.ops.klt import _patch_level  # ops/klt.py imports this module

    guess, status, min_eig = klt_track_chain(
        _patch_level, prev_levels, grad_levels, curr_levels, pos, guess0, valid, **kw)
    if min_eig is None:  # level 0 was too small to run
        min_eig = torch.zeros(pos.shape[:-1], dtype=torch.float32, device=pos.device)
    return guess, status, min_eig


def _streams(img: torch.Tensor) -> int:
    return img.shape[0] if img.dim() == 3 else 1


def _as_is(t: torch.Tensor) -> torch.Tensor:
    """t as the kernel reads it (dense, row-major): t itself when it is."""
    return t if t.is_contiguous() else t.contiguous()


_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the level table: host arrays of device pointers and of ints; eps2 and
# min_eig_threshold are C floats
_KLT_TRACK = _build.entry("svo_klt_track", [
    ctypes.POINTER(_p), ctypes.POINTER(_i), _i, _i, _p, _p, _p, _i, _i, _i, _i, _i, _i,
    _f, _f, _i, _i, _i, _p, _p,
], "klt_track", counts=("launches", "slots"))
_KLT_TRACK_LEVEL = _build.entry("svo_klt_track_level", [
    _p, _p, _p, _p, _i, _i, _i, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _f, _f,
    _i, _i, _i, _p, _p,
], "klt_track", counts=("launches", "slots"))


def klt_track(
    prev_levels,
    grad_levels,
    curr_levels,
    pos: torch.Tensor,
    guess0: torch.Tensor,
    valid: torch.Tensor,
    *,
    window: int,
    pys,
    px: int,
    iters,
    eps: float,
    min_eig_threshold: float,
    margin_x: int,
    pad_x: int,
    pad_y: int,
):
    """Run the patches engine's levels L-1 .. 0 of one tracker call in one
    launch. Returns (d, status, min_eig): d (N, 2) the level-0 flow, status
    (N,) bool, min_eig (N,) that of level 0 (0 where level 0 is too small
    to run).

    prev_levels / curr_levels: the L padded level images, level 0 first;
    grad_levels: L pairs (gx, gy) of the previous image's levels; pos:
    (N, 2) level-0 positions in TRUE image coordinates; guess0: (N, 2) flow
    at twice the top level's scale; valid: (N,) bool; pys / iters: per
    level the patch rows (0: the level is skipped) and the iteration count;
    px: the patch columns; pad_x / pad_y: the levels' padding. With
    (S, H, W) levels every other argument and result has the leading S
    too, and the card runs one launch whatever S is."""
    L = len(prev_levels)
    if not (1 <= L <= MAX_LEVELS) or not (
        len(grad_levels) == len(curr_levels) == len(pys) == len(iters) == L
    ):
        raise ValueError(
            f"need 1..{MAX_LEVELS} levels with a gradient pair, a current image, a py and an "
            f"iteration count each, got {L} / {len(grad_levels)} / {len(curr_levels)} / "
            f"{len(pys)} / {len(iters)}")
    _check(prev_levels, grad_levels, curr_levels, pos, guess0, valid, window=window, pys=pys,
           px=px)
    kw = dict(window=window, pys=pys, px=px, iters=iters, eps=eps,
              min_eig_threshold=min_eig_threshold, margin_x=margin_x, pad_x=pad_x, pad_y=pad_y)
    if pos.device.type == "cpu":
        return klt_track_ref(prev_levels, grad_levels, curr_levels, pos, guess0, valid, **kw)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    S, N = _streams(prev_levels[0]), valid.shape[-1]
    bw, vec, rounds = _kernel_args(window, px, pys, S * N)
    imgs, dims = [], []
    for level in range(L):
        four = (prev_levels[level], *grad_levels[level], curr_levels[level])
        imgs.extend(_as_is(im) for im in four)
        dims.extend((*four[0].shape[-2:], pys[level], iters[level]))
    pos_c, guess_c, valid_c = _as_is(pos), _as_is(guess0), _as_is(valid)
    out = torch.empty((*valid.shape, 4), dtype=torch.float32, device=pos.device)
    _build.launch(
        _KLT_TRACK, pos.device,
        (ctypes.c_void_p * (4 * L))(*(im.data_ptr() for im in imgs)),
        (ctypes.c_int * (4 * L))(*dims), L, S,
        pos_c.data_ptr(), guess_c.data_ptr(), valid_c.data_ptr(), N, window, px, margin_x,
        pad_x, pad_y, eps * eps, min_eig_threshold, bw, int(vec), rounds, out.data_ptr(),
    )
    _build.count("klt_track.slots", S * N)
    return out[..., 0:2], out[..., 3] > 0.5, out[..., 2]


def klt_track_level(
    img_prev, gx, gy, img_curr, p_lvl, p_pad, guess, status, *, w: int, py: int, px: int,
    margin_x: int, iters: int, eps2: float, min_eig_threshold: float,
):
    """One level of the patches engine: ops/klt.py::_patch_level's
    arguments and results (d, status, min_eig), one launch on the card
    whatever S is, _patch_level itself on the CPU."""
    from svo_tpu_torch.ops import klt  # ops/klt.py imports this module

    _check((img_prev,), ((gx, gy),), (img_curr,), p_lvl, guess, status, window=w, pys=(py,),
           px=px)
    if p_pad.shape != p_lvl.shape or p_pad.dtype != torch.float32 or p_pad.device != p_lvl.device:
        raise ValueError(f"p_pad must be {tuple(p_lvl.shape)} float32 on {p_lvl.device}")
    kw = dict(w=w, py=py, px=px, margin_x=margin_x, iters=iters, eps2=eps2,
              min_eig_threshold=min_eig_threshold)
    if p_lvl.device.type == "cpu":
        return klt._patch_level(img_prev, gx, gy, img_curr, p_lvl, p_pad, guess, status, **kw)
    if p_lvl.device.type != "cuda":
        raise ValueError(f"unsupported device {p_lvl.device}")
    if not py:
        raise ValueError("a level with py 0 is skipped, not run")
    S, N = _streams(img_prev), status.shape[-1]
    H, W = img_prev.shape[-2:]
    bw, vec, rounds = _kernel_args(w, px, (py,), S * N)
    imgs = [_as_is(im) for im in (img_prev, gx, gy, img_curr)]
    p_lvl_c, p_pad_c, guess_c, valid_c = (_as_is(t) for t in (p_lvl, p_pad, guess, status))
    out = torch.empty((*status.shape, 4), dtype=torch.float32, device=p_lvl.device)
    _build.launch(
        _KLT_TRACK_LEVEL, p_lvl.device, *(im.data_ptr() for im in imgs), S, H, W,
        p_lvl_c.data_ptr(), p_pad_c.data_ptr(), guess_c.data_ptr(), valid_c.data_ptr(), N,
        w, py, px, margin_x, iters, klt._PAD_X, klt._PAD_Y, eps2, min_eig_threshold,
        bw, int(vec), rounds, out.data_ptr(), what="klt_track (one level)",
    )
    _build.count("klt_track.slots", S * N)
    return out[..., 0:2], out[..., 3] > 0.5, out[..., 2]
