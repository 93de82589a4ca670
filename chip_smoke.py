#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (svo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. It builds the port's CUDA kernels from the
sources in the checkout (nvcc, sm_90a) and holds each against its plain
PyTorch version at the main path's shapes: KLT patch extraction
(klt_patches) and the fused LK level (lk_level), for one stream and for a
stack of 8 streams in one launch (which must equal 8 single launches bit
for bit) at every level's shape; the whole-call launch of lk_level (all
pyramid levels of a tracker call in one launch) at the temporal, stereo and
forward-backward shapes, which must equal the chain of per-level launches
bit for bit and be the faster of the two; and the capability probes
(svo_tpu_torch/probe.py). It runs small
card-vs-CPU agreement checks with both KLT engines, single-stream and
batched. Then the two main paths on bench.py's 97-frame 376x1241 synthetic
sequence, chunk 12 and keyframe cadence 6, each once per engine
(lk_engine="patches", svo_tpu's default, through klt_patches, one launch
per level; "fused", through lk_level, one launch per tracker call) with
accuracy and launch-count checks:
StereoVO.run_chunked (one stream), and BatchedStereoVO.process_chunk with 8
streams in lockstep, even streams forward and odd streams reversed, where a
kernel must be launched exactly as often as for one stream. Warm runs of
both engines, in turns, give frames/s; a profiled chunk of each gives
device launches and device time per frame. Every phase prints its lines;
any failed check raises and the script exits non-zero. Without a CUDA
device it exits non-zero before printing a result. The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from svo_tpu_torch._measure import device_events, median_ms, smi_line

REPO = os.path.dirname(os.path.abspath(__file__))
SHAPE = (376, 1241)  # KITTI seq 00 image size, as bench.py
N_FRAMES = 97        # 1 bootstrap frame + 8 chunks of 12, as bench.py
ATE_LIMIT_M = 0.273  # the OpenCV reference pipeline's ATE on this sequence
ENGINES = ("patches", "fused")
STREAMS = 8          # batched main path: streams in lockstep, as bench.py
CHUNK, CADENCE = 12, 6
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published peak
F32_FLOP_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase_device() -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"device: {name} | count {torch.cuda.device_count()} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    print(smi)  # name, power limit: exactly as nvidia-smi prints them
    return name, smi


def bound_klt_patches(valid, py: int, px: int) -> float:
    """Least ms the card could take for one extraction: every live slot's
    four windows read once, every slot's four windows written once (dead
    slots are written as zeros and read nothing), corners and valid read."""
    n, live = valid.numel(), int(valid.sum())
    nbytes = (live + n) * 4 * py * px * 4 + n * (4 * 4 + 1)
    return nbytes / HBM_BYTES_PER_S * 1e3


def bound_lk_level(valid, window: int, mx: int, my: int, iters: int) -> tuple[float, str]:
    """Least ms for one fused level, the larger of its bytes over the
    memory rate and its operations over the f32 rate. Bytes: a live slot
    reads three (w+3)^2 template windows and one (w+2my+1)x(w+2mx+1) current
    window; every slot reads pos, guess, valid and writes 8 floats.
    Operations: per live slot, 3 bilinear samples (7 flop) and 3 products
    into G per window pixel, then per iteration a sample, a difference and
    two multiply-adds per pixel. All iterations are counted: a converged
    feature still evaluates them, masked."""
    n, live = valid.numel(), int(valid.sum())
    tw = window + 3
    nbytes = live * (3 * tw * tw + (window + 2 * my + 1) * (window + 2 * mx + 1)) * 4
    nbytes += n * (8 + 8 + 1 + 32)
    flop = live * window * window * (3 * 7 + 6 + iters * (7 + 1 + 4))
    t_bytes, t_flop = nbytes / HBM_BYTES_PER_S * 1e3, flop / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flop else (t_flop, "operations")


def phase_build() -> None:
    from svo_tpu_torch import _build

    t0 = time.perf_counter()
    path = _build.library_path()
    _build.load()
    print(f"build: {os.path.relpath(path, REPO)} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")


def phase_kernel(frame) -> dict:
    """Kernel against its plain version at every level of the temporal and
    stereo calls, with ~40% dead slots and corners at and past the borders;
    at level 0 also through the wrapper's conversions (int64 corners;
    strided corners and a strided valid), which only run on the card."""
    from svo_tpu_torch.ops import klt
    from svo_tpu_torch.ops.klt_patches import (
        extract_klt_patches, extract_klt_patches_ref,
    )

    left, right = (torch.from_numpy(f).cuda() for f in frame)
    levels_l, grads_l = klt.KltTracker.build_pyramid(left, 3)
    levels_r, _ = klt.KltTracker.build_pyramid(right, 3)
    rng = np.random.default_rng(0)
    rows, worst = [], 0.0
    for kind, n, window, margin_x in (("temporal", 128, 21, 6), ("stereo", 192, 11, 16)):
        for lvl in range(4):
            prev, curr = levels_l[lvl], levels_r[lvl]
            gx, gy = grads_l[lvl]
            H, W = prev.shape
            py, px = klt._level_rows(window, H), klt._patch_cols(window, margin_x)
            pos = rng.uniform([-8, -8], [W + 8, H + 8], (n, 2)).astype(np.float32)
            pos[:4] = [[0, 0], [W - 1, H - 1], [-50, H + 50], [W + 50, -50]]
            guess = rng.uniform(-4, 4, (n, 2)).astype(np.float32)
            corners = klt._corners(
                torch.from_numpy(pos).cuda(), torch.from_numpy(guess).cuda(),
                H, W, py, px, window, margin_x,
            )
            # raw corners past the borders too: the kernel clamps them itself
            corners[1][4], corners[3][5] = W + 100, -100
            valid = torch.from_numpy(rng.random(n) >= 0.4).cuda()
            args = (prev, gx, gy, curr, *corners, valid, py, px)
            got = extract_klt_patches(*args)
            want = extract_klt_patches_ref(*args)
            torch.cuda.synchronize()
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            worst = max(worst, err)
            check(err == 0.0, f"{kind} level {lvl}: kernel differs from plain by {err}")
            ms = median_ms(lambda: extract_klt_patches(*args))
            plain = median_ms(lambda: extract_klt_patches_ref(*args))
            bound = bound_klt_patches(valid, py, px)
            if lvl == 0:
                # what the wrapper converts before the launch: int64 corners;
                # corners and valid that are strided views of wider tensors
                wide = [torch.stack([c, c.flip(0)], dim=1)[:, 0] for c in (*corners, valid)]
                check(not any(t.is_contiguous() for t in wide), "the views under test are contiguous")
                for what, alt in (("int64 corners", [c.long() for c in corners] + [valid]),
                                  ("strided corners and valid", wide)):
                    conv = extract_klt_patches(prev, gx, gy, curr, *alt, py, px)
                    cerr = max(float((g - w).abs().max()) for g, w in zip(conv, want))
                    print(f"kernel klt_patches {kind:8s} L0 with {what}: max|diff| {cerr}")
                    check(cerr == 0.0, f"{kind} L0 with {what}: differs from plain by {cerr}")
                    worst = max(worst, cerr)
            rows.append(dict(kind=kind, level=lvl, H=H, W=W, N=n, py=py, px=px,
                             ms=ms, plain_ms=plain, max_abs_err=err, bound_ms=bound))
            print(f"kernel klt_patches {kind:8s} L{lvl} {H}x{W} N={n} {py}x{px}: "
                  f"max|diff| {err} | kernel {ms:.4f} ms | plain {plain:.4f} ms | "
                  f"bound {bound:.6f} ms (bytes)")
    return dict(rows=rows, max_abs_err=worst)


def _lk_agreement(tag, got, again, want, guess_t, valid, min_ok: int) -> tuple[float, float]:
    """Hold one lk_level result against its plain version `want` and a
    second launch `again` by the tolerances phase_lk_level states; print
    the readings, then raise on any that fails. Returns max |d diff| over
    the slots both sides track and the norm-wise min_eig difference."""
    (d, me, sv, ip), (d_r, me_r, sv_r, ip_r) = got, want
    flags = min(float((sv == sv_r).float().mean()), float((ip == ip_r).float().mean()))
    ok = sv & ip & sv_r & ip_r
    n_ok = int(ok.sum())
    err = float((d - d_r)[ok].abs().max()) if n_ok else 0.0
    me_err = float((me - me_r)[valid].abs().max() / me_r[valid].abs().max())
    dead = ~valid
    dead_exact = bool(torch.equal(d[dead], guess_t[dead]) and not sv[dead].any())
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"{tag}: flags agree {flags:.4f} | max|d diff| {err:.3g} px over {n_ok} "
          f"tracked | min_eig diff {me_err:.3g} of max | dead d == guess "
          f"{dead_exact} | repeat bit-identical {repeat}")
    check(flags >= 0.99, f"{tag}: flags agree on {flags}")
    check(n_ok >= min_ok, f"{tag}: only {n_ok} slots tracked by both")
    check(err <= 1e-3, f"{tag}: d differs by {err} px")
    check(me_err <= 1e-4, f"{tag}: min_eig differs by {me_err} of max")
    check(dead_exact, f"{tag}: a dead slot moved or is solvable")
    check(repeat, f"{tag}: a second launch differs")
    return err, me_err


def phase_lk_level(frame) -> dict:
    """The fused LK-level kernel against its plain version at the 9 shapes
    of the main path: temporal L0-L3 (N=128, window 21, margins 6/6), the
    fb re-track at L0, stereo L0-L3 (N=192, window 11, margins 16/6), all
    8 iterations, on the 376x1241 frame's padded pyramid, with ~40% dead
    slots and positions at and past the borders.

    Tolerances: flags (solvable, in_patch) equal on >= 99% of the slots; d
    within 1e-3 px where both sides say solvable and in_patch; a dead
    slot's d equal to its guess exactly; min_eig within 1e-4 of the call's
    largest min_eig (norm-wise: both sides take lambda_min = tr/2 - disc in
    f32 from window sums added in another order, so where G is
    ill-conditioned the elementwise relative error is not bounded); a
    second launch bit-identical to the first."""
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.ops import klt
    from svo_tpu_torch.ops.lk_fused import lk_track_level, lk_track_level_ref

    cfg = Config()
    left, right = (torch.from_numpy(f).cuda() for f in frame)
    levels_l, grads_l = klt.KltTracker.build_pyramid(left, 3)
    levels_r, _ = klt.KltTracker.build_pyramid(right, 3)
    rng = np.random.default_rng(1)
    shapes = [("temporal", lvl, 128, cfg.temporal_klt, 4.0) for lvl in range(4)]
    shapes.append(("fb", 0, 128, cfg.temporal_klt, 0.5))
    shapes += [("stereo", lvl, 192, cfg.stereo_klt, 4.0) for lvl in range(4)]
    rows, worst = [], 0.0
    for kind, lvl, n, params, reach in shapes:
        prev, curr = levels_l[lvl], levels_r[lvl]
        gx, gy = grads_l[lvl]
        H, W = prev.shape
        w, mx = params.window, params.margin_x
        py = klt._level_rows(w, H)
        check(klt._fused_level_ok(H, W, py, w, mx), f"{kind} L{lvl} {H}x{W} is not fused")
        pos = rng.uniform([-8, -8], [W + 8, H + 8], (n, 2)).astype(np.float32)
        pos[:4] = [[0, 0], [W - 1, H - 1], [-50, H + 50], [W + 50, -50]]
        guess = rng.uniform(-reach, reach, (n, 2)).astype(np.float32)
        valid = torch.from_numpy(rng.random(n) >= 0.4).cuda()
        guess_t = torch.from_numpy(guess).cuda()
        args = (prev, gx, gy, curr, torch.from_numpy(pos).cuda(), guess_t, valid)
        kw = dict(window=w, py=py, max_iters=params.max_iters, eps=params.eps,
                  min_eig_threshold=params.min_eig_threshold, margin_x=mx,
                  margin_y=klt._MY)
        got = lk_track_level(*args, **kw)
        again = lk_track_level(*args, **kw)
        want = lk_track_level_ref(*args, **kw)
        torch.cuda.synchronize()
        tag = f"kernel lk_level {kind:8s} L{lvl} {H}x{W} N={n} w={w} m={mx}/{klt._MY}"
        err, me_err = _lk_agreement(tag, got, again, want, guess_t, valid, 8)
        worst = max(worst, err)
        ms = median_ms(lambda: lk_track_level(*args, **kw))
        plain = median_ms(lambda: lk_track_level_ref(*args, **kw), reps=5, inner=2)
        bound, bound_by = bound_lk_level(valid, w, mx, klt._MY, params.max_iters)
        rows.append(dict(kind=kind, level=lvl, H=H, W=W, N=n, window=w, ms=ms,
                         plain_ms=plain, max_abs_err=err, min_eig_rel=me_err,
                         bound_ms=bound, bound_by=bound_by))
        print(f"{tag}: kernel {ms:.4f} ms | plain {plain:.4f} ms | bound {bound:.6f} ms ({bound_by})")
    return dict(rows=rows, max_abs_err=worst)


def phase_batched_kernels(frames) -> dict:
    """Both kernels with S=8 streams in one launch at every shape the
    batched main path gives them, on the padded pyramids of 8 different
    frames: klt_patches at temporal and stereo L0-L3, lk_level at those and
    the fb re-track at L0. At each shape the batched kernel is held against
    its batched plain version (the tolerances of the single-stream phases)
    and stream s of the batched launch must be bit-equal to a single launch
    on stream s's inputs, so the stream stride is checked at every padded
    level size. Only the level-0 rows are timed: one batched call beside 8
    single calls and the plain version."""
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.ops import klt
    from svo_tpu_torch.ops.klt_patches import (
        extract_klt_patches, extract_klt_patches_ref,
    )
    from svo_tpu_torch.ops.lk_fused import lk_track_level, lk_track_level_ref

    cfg = Config()
    S = STREAMS
    lefts = torch.from_numpy(np.stack([f[1] for f in frames[:S]])).cuda()
    rights = torch.from_numpy(np.stack([f[2] for f in frames[:S]])).cuda()
    levels_l, grads_l = klt.KltTracker.build_pyramid(lefts, 3)
    levels_r, _ = klt.KltTracker.build_pyramid(rights, 3)
    rng = np.random.default_rng(2)
    shapes = [("temporal", lvl, 128, cfg.temporal_klt, 4.0) for lvl in range(4)]
    shapes.append(("fb", 0, 128, cfg.temporal_klt, 0.5))
    shapes += [("stereo", lvl, 192, cfg.stereo_klt, 4.0) for lvl in range(4)]
    out = {"klt_patches_max_abs_err": 0.0, "lk_level_max_abs_err": 0.0}
    for kind, lvl, n, params, reach in shapes:
        prev, curr = levels_l[lvl], levels_r[lvl]
        gx, gy = grads_l[lvl]
        H, W = prev.shape[-2:]
        w, mx = params.window, params.margin_x
        py, px = klt._level_rows(w, H), klt._patch_cols(w, mx)
        timed = lvl == 0 and kind != "fb"
        pos = rng.uniform([-8, -8], [W + 8, H + 8], (S, n, 2)).astype(np.float32)
        pos[:, :4] = [[0, 0], [W - 1, H - 1], [-50, H + 50], [W + 50, -50]]
        pos_t = torch.from_numpy(pos).cuda()
        guess_t = torch.from_numpy(rng.uniform(-reach, reach, (S, n, 2)).astype(np.float32)).cuda()
        valid = torch.from_numpy(rng.random((S, n)) >= 0.4).cuda()

        if kind != "fb":  # the fb re-track extracts at temporal L0's shape
            corners = klt._corners(pos_t, guess_t, H, W, py, px, w, mx)
            corners[1][:, 4], corners[3][:, 5] = W + 100, -100  # the kernel clamps
            args = (prev, gx, gy, curr, *corners, valid, py, px)
            before = extract_klt_patches.launches
            got = extract_klt_patches(*args)
            check(extract_klt_patches.launches == before + 1, "a batched extraction is one launch")
            want = extract_klt_patches_ref(*args)
            torch.cuda.synchronize()
            err = max(float((g - v).abs().max()) for g, v in zip(got, want))

            def singles_klt():
                return [extract_klt_patches(prev[s], gx[s], gy[s], curr[s],
                                            *(c[s] for c in corners), valid[s], py, px)
                        for s in range(S)]

            same = all(torch.equal(g[s], o) for s, one in enumerate(singles_klt())
                       for g, o in zip(got, one))
            line = (f"kernel klt_patches batched S={S} {kind:8s} L{lvl} {H}x{W} N={n} {py}x{px}: "
                    f"max|diff| {err} | each stream bit-equal to its single launch {same}")
            if timed:
                ms = median_ms(lambda: extract_klt_patches(*args))
                ms8 = median_ms(singles_klt, reps=10, inner=3)
                plain = median_ms(lambda: extract_klt_patches_ref(*args), reps=10, inner=3)
                bound = bound_klt_patches(valid, py, px)
                line += (f" | one launch {ms:.4f} ms | {S} single calls {ms8:.4f} ms | plain "
                         f"{plain:.4f} ms | bound {bound:.6f} ms (bytes)")
                out[f"klt_patches_{kind}"] = dict(ms=ms, ms_singles=ms8, plain_ms=plain,
                                                  bound_ms=bound)
            print(line)
            check(err == 0.0, f"batched klt_patches {kind} L{lvl}: differs from plain by {err}")
            check(same, f"batched klt_patches {kind} L{lvl}: a stream differs from its single launch")
            out["klt_patches_max_abs_err"] = max(out["klt_patches_max_abs_err"], err)

        tag = f"kernel lk_level batched S={S} {kind:8s} L{lvl} {H}x{W} N={n} w={w} m={mx}/{klt._MY}"
        check(klt._fused_level_ok(H, W, py, w, mx), f"{kind} L{lvl} {H}x{W} is not fused")
        largs = (prev, gx, gy, curr, pos_t, guess_t, valid)
        kw = dict(window=w, py=py, max_iters=params.max_iters, eps=params.eps,
                  min_eig_threshold=params.min_eig_threshold, margin_x=mx,
                  margin_y=klt._MY)
        before = lk_track_level.launches
        got = lk_track_level(*largs, **kw)
        check(lk_track_level.launches == before + 1, "a batched level is one launch")
        again = lk_track_level(*largs, **kw)
        want = lk_track_level_ref(*largs, **kw)
        torch.cuda.synchronize()
        derr, _ = _lk_agreement(tag, got, again, want, guess_t, valid, 8 * S)
        out["lk_level_max_abs_err"] = max(out["lk_level_max_abs_err"], derr)

        def singles_lk():
            return [lk_track_level(*(a[s] for a in largs), **kw) for s in range(S)]

        same = all(torch.equal(g[s], o) for s, one in enumerate(singles_lk())
                   for g, o in zip(got, one))
        # a strided view of a larger stack must be copied, not misread
        wide = torch.stack([prev, prev.flip(0)], dim=1)[:, 0]
        check(not wide.is_contiguous(), "the view under test is contiguous")
        strided = lk_track_level(wide, *largs[1:], **kw)
        line = f"{tag}: each stream bit-equal to its single launch {same}"
        if timed:
            ms = median_ms(lambda: lk_track_level(*largs, **kw))
            ms8 = median_ms(singles_lk, reps=10, inner=3)
            plain = median_ms(lambda: lk_track_level_ref(*largs, **kw), reps=5, inner=2)
            bound, bound_by = bound_lk_level(valid, w, mx, klt._MY, params.max_iters)
            line += (f" | one launch {ms:.4f} ms | {S} single calls {ms8:.4f} ms | plain "
                     f"{plain:.4f} ms | bound {bound:.6f} ms ({bound_by})")
            out[f"lk_level_{kind}"] = dict(ms=ms, ms_singles=ms8, plain_ms=plain,
                                           bound_ms=bound, bound_by=bound_by)
        print(line)
        check(same, f"{tag}: a stream differs from its single launch")
        check(all(torch.equal(a, b) for a, b in zip(got, strided)),
              f"{tag}: a non-contiguous image stack was misread")
    return out


def _track_inputs(frames, S: int, kind: str, cfg, seed: int):
    """(args, kw) of one lk_fused.lk_track_pyramid call at the main path's
    shapes, on the card: the padded pyramids of S rendered (left, right)
    frames (prev: left frame t; curr: left frame t+1, or the right frame t
    for kind "stereo"; kind "fb" is the level-0 forward-backward call), the
    detector's corners as features, a leading (S,) on everything unless S
    is 1. The first four slots are pinned at and past the borders, ~25% of
    the slots are dead and the incoming flow is random within +-0.25 px at
    the top level's scale."""
    from svo_tpu_torch.ops import klt
    from svo_tpu_torch.ops.detect import detect_fast

    lead = (lambda a: a[0]) if S == 1 else (lambda a: a)
    prev = lead(torch.from_numpy(np.stack([f[0] for f in frames[:S]])).cuda())
    if kind == "stereo":
        params, n = cfg.stereo_klt, 192
        curr = lead(torch.from_numpy(np.stack([f[1] for f in frames[:S]])).cuda())
    else:
        params, n = cfg.temporal_klt, 128
        if kind == "fb":
            params = dataclasses.replace(params, max_level=0, max_iters=8)
        curr = lead(torch.from_numpy(np.stack([f[0] for f in frames[1:S + 1]])).cuda())
    prev_levels, grads = klt.KltTracker.build_pyramid(prev, params.max_level)
    curr_levels, _ = klt.KltTracker.build_pyramid(curr, params.max_level)
    pos, _, valid = detect_fast(prev, 20.0, None, cfg)
    pos, valid = pos[..., :n, :].contiguous(), valid[..., :n].contiguous()
    rng = np.random.default_rng(seed)
    H, W = prev.shape[-2:]
    pos[..., :4, :] = torch.tensor(
        [[0.0, 0.0], [W - 1.0, H - 1.0], [-50.0, H + 50.0], [W + 50.0, -50.0]]).cuda()
    valid[..., :4] = True
    valid &= torch.from_numpy(rng.random(tuple(valid.shape)) >= 0.25).cuda()
    guess0 = torch.from_numpy(
        rng.uniform(-0.25, 0.25, tuple(pos.shape)).astype(np.float32)).cuda()
    pys = [klt._level_rows(params.window, lv.shape[-2]) for lv in prev_levels]
    for lv, py in zip(prev_levels, pys):
        check(klt._fused_level_ok(*lv.shape[-2:], py, params.window, params.margin_x),
              f"{kind}: level {tuple(lv.shape)} does not take the fused engine")
    kw = dict(window=params.window, pys=pys, iters=[params.max_iters] * len(pys),
              eps=params.eps, min_eig_threshold=params.min_eig_threshold,
              margin_x=params.margin_x, margin_y=klt._MY, pad_x=klt._PAD_X, pad_y=klt._PAD_Y)
    return (prev_levels, grads, curr_levels, pos, guess0, valid), kw


def phase_lk_track(frames) -> dict:
    """The whole-call launch of lk_level (every pyramid level of a tracker
    call in one launch) at the main path's shapes: temporal (window 21, 4
    levels, N=128), stereo (window 11, margin_x 16, 4 levels, N=192) and the
    forward-backward call (1 level), for one stream and for 8 in one launch,
    on _track_inputs (the detector's corners, four slots pinned at and past
    the borders, ~25% dead slots, a random incoming flow).

    Held against lk_track_pyramid_ref, its plain version: status equal on
    >= 99% of the slots; a dead slot's d equal to its incoming flow at
    level 0's scale exactly, its min_eig 0; a second launch bit-identical;
    and d, where both track, within 1e-3 px on EVERY slot that has settled.
    A slot has settled when the plain version with four times the
    iterations at every level ends within 0.1 px of where it ends with the
    tracker's count. The few that have not (mistracks still moving by 2-6
    px when their 8 iterations are up: on them an iteration does not
    contract, so the two roundings of the window sums drift apart, ~10x at
    level 0 where measured) are at most 1% of the tracked slots and stay
    within 1e-2 px. Where a slot passes 1e-3 px, its flow is printed level
    by level, kernel beside plain, with how far it still moves.
    BIT-EQUAL to the chain of per-level
    launches with the glue between levels in tensor ops; every stream of the
    8-stream launch bit-equal to its single-stream launch.

    Timed, in turns within this call (chain, whole, whole, chain; CUDA
    events, median of 25): the wall of one tracker call through the chain
    of per-level wrapper calls and through the whole-call wrapper. The
    whole-call wall must be the lower one at every shape, one stream and
    8. The device time of a whole-call launch is read from the profiler's
    kernel records over 20 launches. The bound is the sum of the levels'
    bounds with the slots live at each level in this run."""
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.ops.lk_fused import (
        lk_track_level, lk_track_level_ref, lk_track_pyramid, lk_track_pyramid_chain,
        lk_track_pyramid_ref,
    )

    cfg = Config(use_orb=False, image_height=SHAPE[0], image_width=SHAPE[1])
    pairs = [f[1:] for f in frames[: STREAMS + 1]]
    out = {"max_abs_err": 0.0}
    for S in (1, STREAMS):
        for seed, kind in enumerate(("temporal", "stereo", "fb")):
            args, kw = _track_inputs(pairs, S, kind, cfg, 10 * S + seed)
            pos, guess0, valid = args[3:]
            n_levels = len(kw["pys"])
            live = []  # slots live entering each level, coarse to fine
            flows = {lk_track_level: [], lk_track_level_ref: []}  # d leaving each level

            def recorded(level_fn):
                def fn(*a, **k):
                    res = level_fn(*a, **k)
                    flows[level_fn].append(res[0])
                    return res
                return fn

            def counted(*a, **k):
                live.append(a[6])
                return recorded(lk_track_level)(*a, **k)

            def chain(level_fn=lk_track_level):
                return lk_track_pyramid_chain(level_fn, *args, **kw)

            def whole():
                return lk_track_pyramid(*args, **kw)

            before = lk_track_pyramid.launches, lk_track_level.launches
            got = whole()
            check((lk_track_pyramid.launches, lk_track_level.launches)
                  == (before[0] + 1, before[1]), "a whole tracker call is one launch")
            again = whole()
            by_level = chain(counted)
            want = lk_track_pyramid_ref(*args, **kw)
            torch.cuda.synchronize()
            (d, me, st), (d_r, me_r, st_r) = got, want
            tag = (f"kernel lk_level whole call S={S} {kind:8s} {n_levels} levels "
                   f"N={valid.shape[-1]} w={kw['window']} m={kw['margin_x']}/{kw['margin_y']}")
            equal_chain = all(torch.equal(g, c) for g, c in zip(got, by_level))
            repeat = all(torch.equal(g, a) for g, a in zip(got, again))
            flags = float((st == st_r).float().mean())
            ok = st & st_r
            n_ok = int(ok.sum())
            diff = (d - d_r)[ok].abs().amax(dim=-1)
            err = float(diff.max()) if n_ok else 0.0
            close = float((diff <= 1e-3).float().mean()) if n_ok else 1.0
            # how far plain still moves with 4x the iterations: settled or not
            d_long = lk_track_pyramid_ref(*args, **{**kw, "iters": [4 * i for i in kw["iters"]]})[0]
            moves = (d_long - d_r)[ok].abs().amax(dim=-1)
            settled = moves <= 0.1
            err_settled = float(diff[settled].max()) if bool(settled.any()) else 0.0
            dead = ~valid
            dead_exact = bool(
                torch.equal(d[dead], guess0[dead] * 2.0 ** n_levels)
                and not st[dead].any() and not me[dead].any()
            )
            line = (f"{tag}: bit-equal to the chain of per-level launches {equal_chain} | "
                    f"status agrees with plain {flags:.4f} | max|d diff| {err:.3g} px over "
                    f"{n_ok} tracked of {int(valid.sum())} live, {close:.4f} of them within "
                    f"1e-3 px; {int(settled.sum())} settled, max|d diff| {err_settled:.3g} px "
                    f"over those | dead slots exact {dead_exact} "
                    f"| repeat bit-identical {repeat}")
            if err > 1e-3:
                # the slot furthest from plain, level by level, coarse to fine
                lk_track_pyramid_chain(recorded(lk_track_level_ref), *args, **kw)
                slot = tuple(ok.nonzero()[int(diff.argmax())].tolist())
                per_level = [float((a[slot] - b[slot]).abs().max())
                             for a, b in zip(flows[lk_track_level], flows[lk_track_level_ref])]
                line += (f" | slot {slot}, |d kernel - d plain| leaving each level, coarse to "
                         f"fine: {' '.join(f'{v:.3g}' for v in per_level)} px; plain moves it "
                         f"{float(moves[int(diff.argmax())]):.3g} px further with 4x the iterations")
            if S > 1:
                singles = [lk_track_pyramid(
                    [lv[s] for lv in args[0]], [(gx[s], gy[s]) for gx, gy in args[1]],
                    [lv[s] for lv in args[2]], pos[s], guess0[s], valid[s], **kw)
                    for s in range(S)]
                same = all(torch.equal(g[s], o) for s, one in enumerate(singles)
                           for g, o in zip(got, one))
                line += f" | each stream bit-equal to its single launch {same}"
                check(same, f"{tag}: a stream differs from its single launch")
                # a strided view of a larger stack must be copied, not misread
                wide = [torch.stack([lv, lv.flip(0)], dim=1)[:, 0] for lv in args[0]]
                check(not wide[0].is_contiguous(), "the view under test is contiguous")
                strided = lk_track_pyramid(wide, *args[1:], **kw)
                check(all(torch.equal(a, b) for a, b in zip(got, strided)),
                      f"{tag}: a non-contiguous level stack was misread")
            bound = sum(bound_lk_level(v, kw["window"], kw["margin_x"], kw["margin_y"], it)[0]
                        for v, it in zip(live, kw["iters"][::-1]))
            turns = [median_ms(fn) for fn in (chain, whole, whole, chain)]
            chain_ms, whole_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            plain = median_ms(lambda: lk_track_pyramid_ref(*args, **kw), reps=3, inner=1)
            evs = [e for e in device_events(lambda: [whole() for _ in range(20)])
                   if "lk_level_kernel" in e.key]
            check(sum(e.count for e in evs) == 20, f"{tag}: the profiler did not see 20 launches")
            device_us = sum(e.self_device_time_total for e in evs) / 20
            line += (f" | wall of one call, in turns: chain {turns[0]:.4f} whole {turns[1]:.4f} "
                     f"whole {turns[2]:.4f} chain {turns[3]:.4f} ms | device {device_us:.2f} us a "
                     f"launch (profiler) | plain {plain:.4f} ms | "
                     f"bound {bound:.6f} ms (bytes; live per level "
                     f"{[int(v.sum()) for v in live]})")
            print(line)
            check(equal_chain, f"{tag}: differs from the chain of per-level launches")
            check(flags >= 0.99, f"{tag}: status agrees with plain on {flags}")
            check(n_ok >= 8 * S, f"{tag}: only {n_ok} slots tracked by both")
            check(close >= 0.99, f"{tag}: d within 1e-3 px of plain on {close} of the slots")
            check(err_settled <= 1e-3,
                  f"{tag}: d differs from plain by {err_settled} px on a settled slot")
            check(err <= 1e-2, f"{tag}: d differs from plain by {err} px")
            check(dead_exact, f"{tag}: a dead slot moved, is tracked or has a min_eig")
            check(repeat, f"{tag}: a second launch differs")
            check(max(turns[1:3]) < min(turns[0], turns[3]),
                  f"{tag}: the whole-call launch is not faster than the chain: {turns}")
            out["max_abs_err"] = max(out["max_abs_err"], err)
            out[f"{kind}_{S}"] = dict(ms=whole_ms, chain_ms=chain_ms, plain_ms=plain,
                                      bound_ms=bound, turns=turns, device_us=device_us)
    return out


def phase_probe() -> dict:
    """The capability probes (svo_tpu_torch/probe.py), one line each; then
    the window-sum probe's time beside its plain version, which is one
    PyTorch call."""
    from svo_tpu_torch import probe

    probe.run_probe.launches = 0
    rows = probe.run_all("cuda")
    launches = probe.run_probe.launches
    check(launches > 0, "no probe kernel was launched")
    x, o = probe.make_inputs(0, "cuda")
    first = probe.PROBES[0]
    ms = median_ms(lambda: probe.run_probe(first, x, o))
    plain = median_ms(lambda: first.plain(x, o, first.param))
    nbytes = 32 * 34 * 21 * 4 + 32 * 4
    print(f"probe {first.name}: kernel {ms:.4f} ms | plain (one torch.sum) {plain:.4f} ms | "
          f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.8f} ms (bytes)")
    errs = [r["max_abs_err"] for r in rows if r["max_abs_err"] is not None]
    return dict(launches=launches, ms=ms, plain_ms=plain, max_abs_err=max(errs),
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)


def _run(frames, seq, device, lk_engine, chunk=12, cadence=6):
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.geometry import camera as cam_mod
    from svo_tpu_torch.pipeline.odometry import StereoVO

    H, W = frames[0][1].shape
    cfg = Config(use_orb=False, image_height=H, image_width=W)
    cam = cam_mod.from_intrinsics(
        seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline
    )
    vo = StereoVO(cfg, cam, device=device, chunk=chunk, kf_cadence=cadence,
                  lk_engine=lk_engine)
    return vo.run_chunked(frames)


def _drive_cadenced(frames, seq, device, noises, lk_engine, cadence=6):
    """The cadenced frame steps of run_chunked, with the PnP noise given.
    Frames (H, W) drive one stream; stacks (S, H, W) with noise
    (S, hypotheses, N) drive S streams in lockstep."""
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.geometry import camera as cam_mod
    from svo_tpu_torch.pipeline import frontend

    H, W = frames[0][1].shape[-2:]
    cfg = Config(use_orb=False, image_height=H, image_width=W)
    cam = cam_mod.from_intrinsics(
        seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline, device=device
    )

    def img(a):
        return torch.from_numpy(a).to(device)

    st = frontend.make_bootstrap(cam, cfg, lk_engine)(img(frames[0][1]), img(frames[0][2]))
    for i, (_, left, right) in enumerate(frames[1:]):
        st = frontend.step_body(
            st, img(left), img(right), cam, cfg,
            kf_mode="always" if i % cadence == 0 else "never",
            pnp_noise=noises[i].to(device), lk_engine=lk_engine,
        )
    return st.poses[..., : len(frames), :, :].cpu().numpy()


def phase_small_agreement(lk_engine: str) -> None:
    """A small sequence through the card and through the CPU path (the
    plain version of every kernel) with the same PnP noise: trajectories
    within 10 cm and 1 deg, the bound svo_tpu's tests hold two tracker
    engines to."""
    from svo_tpu_torch.geometry.pnp import gumbel_noise
    from svo_tpu_torch.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(n_frames=13, shape=(96, 256), fx=120.0, speed=0.12, seed=3)
    frames = list(seq)
    gen = torch.Generator().manual_seed(0)
    noises = [gumbel_noise((128, 128), gen, "cpu") for _ in frames[1:]]
    gpu = _drive_cadenced(frames, seq, "cuda", noises, lk_engine)
    cpu = _drive_cadenced(frames, seq, "cpu", noises, lk_engine)
    check(bool(np.isfinite(gpu).all()), "small run: non-finite poses on the card")
    dt = np.linalg.norm(gpu[:, :3, 3] - cpu[:, :3, 3], axis=-1).max()
    ang = max(
        np.degrees(np.arccos(np.clip((np.trace(a[:3, :3].T @ b[:3, :3]) - 1) / 2, -1, 1)))
        for a, b in zip(gpu, cpu)
    )
    print(f"small run 96x256 x13, lk_engine={lk_engine}, card vs CPU path, same PnP noise: max |dt| "
          f"{dt:.6f} m, max rotation diff {ang:.6f} deg")
    check(dt < 0.1 and ang < 1.0, "card and CPU paths disagree on the small run")


def _pose_diff(a, b) -> tuple[float, float]:
    """Max translation distance (m) and max rotation angle (deg) between
    two (..., F, 4, 4) trajectories."""
    a, b = a.reshape(-1, 4, 4), b.reshape(-1, 4, 4)
    dt = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=-1).max()
    cos = (np.einsum("nij,nij->n", a[:, :3, :3], b[:, :3, :3]) - 1) / 2
    return float(dt), float(np.degrees(np.arccos(np.clip(cos, -1, 1))).max())


def phase_small_agreement_batched(lk_engine: str, S: int = 3) -> None:
    """S small sequences in lockstep with shared PnP noise: the batched
    drive on the card against the batched drive on the CPU path within 10
    cm and 1 deg, and against S single-stream drives on the card within 1
    cm and 0.4 deg. Batched and single differ only inside ransac_pnp, by
    ~1e-6 a call (sums over another shape); where the solve ends on an
    unrefined 6-point DLT hypothesis, that solve's conditioning has been
    seen to carry this to 0.7 mm in one pose, and f32 arccos near 1
    reads 0.03-0.04 deg: the bounds are ~10x those."""
    from svo_tpu_torch.geometry.pnp import gumbel_noise
    from svo_tpu_torch.io.synthetic import SyntheticSequence

    seqs = [SyntheticSequence(n_frames=13, shape=(96, 256), fx=120.0, speed=0.12, seed=3 + s)
            for s in range(S)]
    per_stream = [list(q) for q in seqs]
    stacked = [(t, np.stack([fr[t][1] for fr in per_stream]),
                np.stack([fr[t][2] for fr in per_stream])) for t in range(13)]
    gen = torch.Generator().manual_seed(0)
    noises = [gumbel_noise((S, 128, 128), gen, "cpu") for _ in stacked[1:]]
    gpu = _drive_cadenced(stacked, seqs[0], "cuda", noises, lk_engine)
    cpu = _drive_cadenced(stacked, seqs[0], "cpu", noises, lk_engine)
    check(gpu.shape == (S, 13, 4, 4), f"batched small run: poses shape {gpu.shape}")
    check(bool(np.isfinite(gpu).all()), "batched small run: non-finite poses on the card")
    singles = np.stack([
        _drive_cadenced(per_stream[s], seqs[0], "cuda", [n[s] for n in noises], lk_engine)
        for s in range(S)
    ])
    dt_c, ang_c = _pose_diff(gpu, cpu)
    dt_s, ang_s = _pose_diff(gpu, singles)
    print(f"small batched run S={S} 96x256 x13, lk_engine={lk_engine}, same PnP noise: card vs "
          f"CPU path max |dt| {dt_c:.6f} m, max rotation diff {ang_c:.6f} deg | batched vs "
          f"{S} single-stream drives on the card max |dt| {dt_s:.6f} m, max rotation diff "
          f"{ang_s:.6f} deg")
    check(dt_c < 0.1 and ang_c < 1.0, "batched: card and CPU paths disagree on the small run")
    check(dt_s < 0.01 and ang_s < 0.4, "batched and single-stream drives disagree on the small run")


def _u8(img) -> np.ndarray:
    return np.clip(img, 0, 255).astype(np.uint8)


def _config_and_camera(seq, device=None):
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.geometry import camera as cam_mod

    cfg = Config(use_orb=False, image_height=SHAPE[0], image_width=SHAPE[1])
    cam = cam_mod.from_intrinsics(
        seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline, device=device
    )
    return cfg, cam


def _launches_per_frame(seq, lk_engine, first, chunks, n=6):
    """Device activities and device ms per frame step (torch.profiler) over
    one warm cadenced chunk of n frames: one keyframe step, n-1 tracking
    steps. The profiler counts every device activity: kernels, fills and
    copies. Also the mean device us per launch of the port's own kernels.
    first: the (left, right) f32 tensors of frame 0; chunks: two
    (lefts_u8, rights_u8) chunks of n frames, the first to warm up, the
    second profiled. Tensors that carry a stream axis drive the batched step,
    where a frame step serves all streams."""
    from svo_tpu_torch.pipeline import frontend

    cfg, cam = _config_and_camera(seq, "cuda")
    step = frontend.make_cadenced_chunk_step(cam, cfg, n, CADENCE, lk_engine)
    gen = torch.Generator(device="cuda").manual_seed(0)
    st = frontend.make_bootstrap(cam, cfg, lk_engine)(*first)
    st = step(st, *chunks[0], gen)  # warm-up chunk
    dev = device_events(lambda: step(st, *chunks[1], gen))
    launches = sum(e.count for e in dev)
    check(launches > 0, "the profiler saw no device activity")
    own = {}
    for name in ("klt_patches_kernel", "lk_level_kernel"):
        evs = [e for e in dev if name in e.key]
        count = sum(e.count for e in evs)
        if count:
            own[name] = sum(e.self_device_time_total for e in evs) / count
    return launches / n, sum(e.self_device_time_total for e in dev) / n / 1e3, own


def _expected_launches(engine: str, n_kf: int) -> int:
    """Launches of the path's kernel in a 97-frame cadenced run. patches:
    one extraction per pyramid level, so (temporal levels + the fb level)
    per frame and the stereo levels per keyframe (bootstrap included).
    fused: every level qualifies at 376x1241, so a tracker call is one
    launch: the temporal and the fb call per frame, the stereo call per
    keyframe. The count does not depend on the number of streams: a launch
    serves all of them."""
    from svo_tpu_torch.config import Config

    cfg = Config()
    if engine == "fused":
        return 2 * (N_FRAMES - 1) + n_kf
    per_frame = cfg.temporal_klt.max_level + 1 + 1
    per_kf = cfg.stereo_klt.max_level + 1
    return per_frame * (N_FRAMES - 1) + per_kf * n_kf


# the wrappers that launch each kernel: lk_level has the per-level entry and
# the whole-call entry, counted together
WRAPPERS = {"klt_patches": ("extract_klt_patches",),
            "lk_level": ("lk_track_level", "lk_track_pyramid")}
PATH_KERNEL = {"patches": "klt_patches", "fused": "lk_level"}


def _kernel_counts(counts: dict) -> dict:
    return {k: sum(counts[w] for w in ws) for k, ws in WRAPPERS.items()}


def _check_launches(tag, engine, counts, n_kf):
    expected = _expected_launches(engine, n_kf)
    for name, count in _kernel_counts(counts).items():
        want = expected if name == PATH_KERNEL[engine] else 0
        check(count == want, f"{tag} {engine}: {name} launched {count} times, expected {want}")


def phase_main_path(kernels, frames, seq) -> dict:
    """bench.py's single-stream path once per KLT engine, then one warm run
    of each and a profiled chunk of each. Returns the launches of each
    kernel wrapper in each engine's first run."""
    from svo_tpu_torch.eval.trajectory import ate_rmse

    launches = {}
    for engine in ENGINES:
        for k in kernels:
            k.launches = 0
        res = _run(frames, seq, "cuda", engine)
        counts = {k.__name__: k.launches for k in kernels}
        launches[engine] = counts
        poses = res.poses
        check(poses.shape == (N_FRAMES, 4, 4), f"poses shape {poses.shape}")
        check(bool(np.isfinite(poses).all()), f"{engine}: NaN/inf in the poses")
        ate = ate_rmse(poses, seq.gt_poses)
        inl = float(res.metrics[1:, 1].mean())
        live = float(res.metrics[:, 2].mean())
        n_kf = int(res.kf_flags.sum())
        print(f"main path lk_engine={engine}: ATE {ate:.4f} m (limit {ATE_LIMIT_M}) | "
              f"mean inlier ratio {inl:.4f} | mean live features {live:.1f} | "
              f"keyframes {n_kf} | launches {counts}")
        check(np.isfinite(ate) and ate <= ATE_LIMIT_M, f"{engine}: ATE {ate} m > {ATE_LIMIT_M} m")
        check(inl >= 0.8, f"{engine}: mean inlier ratio {inl} < 0.8")
        check(live >= 60, f"{engine}: mean live features {live} < 60")
        _check_launches("single stream", engine, counts, n_kf)

    warm = {}
    for engine in ENGINES:
        torch.cuda.reset_peak_memory_stats()
        res = _run(frames, seq, "cuda", engine)
        peak = torch.cuda.max_memory_allocated()
        check(bool(np.isfinite(res.poses).all()), f"{engine}: NaN/inf in a warm run's poses")
        warm[engine] = res.fps
        print(f"warm run lk_engine={engine}: {res.fps:.3f} frames/s | "
              f"{1e3 / res.fps:.2f} ms/frame | {res.total_time_s:.3f} s for "
              f"{N_FRAMES - 1} frames | peak device memory {peak / 2**20:.1f} MiB | "
              f"ATE {ate_rmse(res.poses, seq.gt_poses):.4f} m")
    first = tuple(torch.from_numpy(frames[0][k]).cuda() for k in (1, 2))
    chunks = [
        tuple(torch.from_numpy(np.stack([_u8(f[k]) for f in frames[1 + c * 6: 7 + c * 6]])).cuda()
              for k in (1, 2))
        for c in range(2)
    ]
    for engine in ENGINES:
        per, dev_ms, own = _launches_per_frame(seq, engine, first, chunks)
        own_us = " | ".join(f"{k} {v:.2f} us device per launch" for k, v in own.items())
        wall_ms = 1e3 / warm[engine]
        print(f"profile lk_engine={engine}: {per:.0f} device launches per frame | "
              f"{dev_ms:.2f} ms device kernel time per frame | {own_us} | warm "
              f"{warm[engine]:.3f} frames/s, {wall_ms:.2f} ms wall per frame | device "
              f"busy share {dev_ms / wall_ms:.3f}")
    return launches


def phase_batched_main_path(kernels, frames, seq) -> dict:
    """The batched main path: BatchedStereoVO with 8 streams in lockstep on
    bench.py's sequence (even streams forward, odd streams reversed), chunk
    12, keyframe cadence 6, all chunks staged on the card as uint8, once
    per KLT engine with accuracy and launch-count checks; then warm runs in
    turns and a profiled 6-frame chunk of each engine. Returns the launches
    of each kernel wrapper in each engine's first run."""
    from svo_tpu_torch.eval.trajectory import ate_rmse
    from svo_tpu_torch.parallel.batched import BatchedStereoVO

    S = STREAMS
    cfg, cam = _config_and_camera(seq)
    streams = [frames if s % 2 == 0 else frames[::-1] for s in range(S)]
    gts = [seq.gt_poses if s % 2 == 0 else seq.gt_poses[::-1] for s in range(S)]
    l0 = torch.from_numpy(np.stack([st[0][1] for st in streams])).cuda()
    r0 = torch.from_numpy(np.stack([st[0][2] for st in streams])).cuda()

    def stage(ts):
        """(len(ts), S, H, W) uint8 on the card, frame-major, left and right."""
        return tuple(
            torch.from_numpy(np.stack([np.stack([_u8(st[t][k]) for st in streams]) for t in ts])).cuda()
            for k in (1, 2)
        )

    n_chunks = (N_FRAMES - 1) // CHUNK
    chunks = [stage(range(1 + c * CHUNK, 1 + (c + 1) * CHUNK)) for c in range(n_chunks)]
    n_stepped = n_chunks * CHUNK
    staged = sum(t.numel() for c in chunks for t in c)
    print(f"batched main path: {S} streams x {N_FRAMES} frames, {n_chunks} chunks of {CHUNK} "
          f"staged on the card, {staged / 2**20:.1f} MiB uint8")

    def drive(engine):
        bvo = BatchedStereoVO(cfg, cam, S, chunk=CHUNK, kf_cadence=CADENCE, lk_engine=engine)
        check(bvo.device.type == "cuda", "BatchedStereoVO does not default to the card")
        bvo.start(l0, r0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in chunks:
            bvo.process_chunk(*c)
        torch.cuda.synchronize()
        return bvo, time.perf_counter() - t0

    launches = {}
    for engine in ENGINES:
        for k in kernels:
            k.launches = 0
        bvo, _ = drive(engine)
        counts = {k.__name__: k.launches for k in kernels}
        launches[engine] = counts
        trajs = bvo.trajectories(n_stepped + 1)
        check(trajs.shape == (S, N_FRAMES, 4, 4), f"batched poses shape {trajs.shape}")
        check(bool(np.isfinite(trajs).all()), f"batched {engine}: NaN/inf in the poses")
        ates = [float(ate_rmse(trajs[s], gts[s][: n_stepped + 1])) for s in range(S)]
        metrics = bvo.state.metrics[:, : n_stepped + 1].cpu().numpy()
        inl = metrics[:, 1:, 1].mean(axis=1)
        live = metrics[:, :, 2].mean(axis=1)
        n_kf = bvo.state.kf_flags[:, : n_stepped + 1].sum(dim=1).tolist()
        print(f"batched main path lk_engine={engine}: per-stream ATE "
              f"{' '.join(f'{a:.4f}' for a in ates)} m (limit {ATE_LIMIT_M}; the TPU package's "
              f"band 0.044-0.095) | mean inlier ratio per stream "
              f"{' '.join(f'{v:.4f}' for v in inl)} | mean live features per stream "
              f"{' '.join(f'{v:.1f}' for v in live)} | keyframes per stream {n_kf} | "
              f"launches {counts}")
        for s in range(S):
            check(np.isfinite(ates[s]) and ates[s] <= ATE_LIMIT_M,
                  f"batched {engine}: stream {s} ATE {ates[s]} m > {ATE_LIMIT_M} m")
            check(inl[s] >= 0.8, f"batched {engine}: stream {s} mean inlier ratio {inl[s]} < 0.8")
            check(live[s] >= 60, f"batched {engine}: stream {s} mean live features {live[s]} < 60")
        check(len(set(n_kf)) == 1, f"batched {engine}: keyframe counts differ: {n_kf}")
        # the same count as ONE stream's run: a launch serves all streams
        _check_launches(f"batched S={S}", engine, counts, n_kf[0])

    warm = {e: [] for e in ENGINES}
    for engine in ENGINES + ENGINES[::-1]:  # in turns: a, b, b, a
        torch.cuda.reset_peak_memory_stats()
        bvo, wall = drive(engine)
        peak = torch.cuda.max_memory_allocated()
        trajs = bvo.trajectories(n_stepped + 1)
        check(bool(np.isfinite(trajs).all()), f"batched {engine}: NaN/inf in a warm run's poses")
        agg = S * n_stepped / wall
        warm[engine].append(agg)
        worst = max(float(ate_rmse(trajs[s], gts[s][: n_stepped + 1])) for s in range(S))
        print(f"batched warm run lk_engine={engine}: {agg:.3f} frames/s aggregate over {S} "
              f"streams | {1e3 * wall / n_stepped:.2f} ms per lockstep frame step | "
              f"{wall:.3f} s for {n_stepped} steps | peak device memory {peak / 2**20:.1f} MiB "
              f"(torch.cuda.max_memory_allocated, staged chunks included) | worst ATE {worst:.4f} m")
    prof_chunks = [stage(range(1 + c * 6, 7 + c * 6)) for c in range(2)]
    for engine in ENGINES:
        per, dev_ms, own = _launches_per_frame(seq, engine, (l0, r0), prof_chunks)
        own_us = " | ".join(f"{k} {v:.2f} us device per launch" for k, v in own.items())
        wall_ms = 1e3 * S / float(np.mean(warm[engine]))
        print(f"batched profile lk_engine={engine}: {per:.0f} device launches per lockstep "
              f"frame step ({per / S:.0f} per stream-frame) | {dev_ms:.2f} ms device kernel "
              f"time per step ({dev_ms / S:.2f} per stream-frame) | {own_us} | warm aggregate "
              f"frames/s {' / '.join(f'{f:.3f}' for f in warm[engine])}, {wall_ms:.2f} ms wall "
              f"per step | device busy share {dev_ms / wall_ms:.3f}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "needs a CUDA device", file=sys.stderr)
        return 1
    from svo_tpu_torch.io.synthetic import SyntheticSequence
    from svo_tpu_torch.ops.klt_patches import extract_klt_patches
    from svo_tpu_torch.ops.lk_fused import lk_track_level, lk_track_pyramid

    t_start = time.perf_counter()

    def done(phase: str) -> None:
        print(f"[{time.perf_counter() - t_start:.0f} s] {phase} done")

    name, smi = phase_device()
    phase_build()
    t0 = time.perf_counter()
    seq = SyntheticSequence(n_frames=N_FRAMES, shape=SHAPE, fx=718.856)
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:  # numpy frees the GIL
        frames = [(i, *lr) for i, lr in enumerate(pool.map(seq.frame, range(N_FRAMES)))]
    print(f"rendered {N_FRAMES} frames {SHAPE[0]}x{SHAPE[1]} in "
          f"{time.perf_counter() - t0:.1f} s")
    frame = frames[0][1:]
    kern = phase_kernel(frame)
    lk = phase_lk_level(frame)
    done("single-stream kernels")
    batched = phase_batched_kernels(frames)
    track = phase_lk_track(frames)
    probes = phase_probe()
    done("batched kernels, whole-call launches and probes")
    for engine in ENGINES:
        phase_small_agreement(engine)
    for engine in ENGINES:
        phase_small_agreement_batched(engine)
    done("small agreement runs")
    kernels = [extract_klt_patches, lk_track_level, lk_track_pyramid]
    single = phase_main_path(kernels, frames, seq)
    done("single-stream main path")
    multi = phase_batched_main_path(kernels, frames, seq)
    done("batched main path")

    def row(name, source, replaces, rows, engine, key):
        """One kernel's line: its numbers at the temporal level-0 shape of
        one stream, and of the 8-stream launch beside them."""
        r0 = next(r for r in rows["rows"] if r["kind"] == "temporal" and r["level"] == 0)
        b = batched[key]
        n_single = _kernel_counts(single[engine])[name]
        n_batched = _kernel_counts(multi[engine])[name]
        check(n_single > 0 and n_batched > 0, f"{name} was not launched on a main path")
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_single + n_batched,
            "launches_single_stream": n_single, "launches_batched": n_batched,
            "max_abs_err": max(rows["max_abs_err"], batched[f"{name}_max_abs_err"]),
            "ms": r0["ms"], "plain_ms": r0["plain_ms"], "bound_ms": r0["bound_ms"],
            "bound_by": r0.get("bound_by", "bytes"), "library_ms": None,
            "batched_ms": b["ms"], "batched_singles_ms": b["ms_singles"],
            "batched_plain_ms": b["plain_ms"], "batched_bound_ms": b["bound_ms"],
        }

    # the whole temporal tracker call in one lk_level launch, beside the
    # chain of per-level launches it replaces on the main path
    lk_row = row("lk_level", "svo_tpu_torch/csrc/lk_level.cu", "svo_tpu/ops/lk_pallas.py:432",
                 lk, "fused", "lk_level_temporal")
    lk_row["max_abs_err"] = max(lk_row["max_abs_err"], track["max_abs_err"])
    for suffix, t in (("", track["temporal_1"]), ("_batched", track[f"temporal_{STREAMS}"])):
        lk_row[f"track{suffix}_ms"] = t["ms"]
        lk_row[f"track_chain{suffix}_ms"] = t["chain_ms"]
        lk_row[f"track_plain{suffix}_ms"] = t["plain_ms"]
        lk_row[f"track_bound{suffix}_ms"] = t["bound_ms"]
        lk_row[f"track_device{suffix}_us"] = t["device_us"]

    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.0f} s")
    print(smi)
    print(json.dumps({"kernels": [
        row("klt_patches", "svo_tpu_torch/csrc/klt_patches.cu", "svo_tpu/ops/klt_pallas.py:139",
            kern, "patches", "klt_patches_temporal"),
        lk_row,
        {
            "name": "probe", "route": "cuda", "source": "svo_tpu_torch/csrc/probe.cu",
            "replaces": "scripts/probe_mosaic.py:26", "launches": probes["launches"],
            "max_abs_err": probes["max_abs_err"], "ms": probes["ms"],
            "plain_ms": probes["plain_ms"], "bound_ms": probes["bound_ms"],
            "bound_by": "bytes", "library_ms": probes["plain_ms"],
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
