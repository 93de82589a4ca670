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
kernel must be launched exactly as often as for one stream. The same
runs, warm by then, give frames/s; a profiled chunk of each gives device
launches and device time per frame. Then the back-end: solve_ba,
refine_alternate, optimize_pose_graph and refine_global on seeded fixtures
on the card against the CPU path and twice on the card (bit-identical);
bench.py's refined arm (8 streams, refine() every 2 chunks and at the last
chunk) beside the same run without it, with the time and the
device activities of one sweep in each regime; the BA throughput stage of
bench.py; one stream with the in-pipeline window BA (ba.enabled); and a
checkpoint taken on the card after chunk 4 and resumed in a fresh engine,
which must reproduce chunks 5-8 bit for bit. The shipping configuration
(Config(): the ORB detector, plain PyTorch with no kernel of its own): the
scale pyramid, the Harris response and detect_orb on the card against the
CPU path (one stream and 8), then the port's own entry point,
svo_tpu_torch.run_synthetic.main, on the 97-frame sequence with chunk 12
and cadence 6 (fused) and with the data-dependent keyframe rule inside
the chunk (patches), 8 ORB streams through BatchedStereoVO, and
python3 -m svo_tpu_torch.run_kitti on tests/fixtures/kitti_mini as a
process of its own; each ORB run is held to svo_tpu's own ORB accuracy
and must launch its engine's kernel as the launch rule gives. Then the
long runs and the distributed paths: svo_tpu_torch.soak for 241 frames
(the observation ring wraps under the running pipeline; the window after
the wrap, a resume bit for bit, the ATE), svo_tpu_torch.eval_worlds with
the eight worlds forward and reversed as 16 batched streams (the first 49
frames of each), both counted against the launch rule; and on
torch.distributed, a world of one (NCCL) holding 8 BA shards against the
single solve, refine_global_sharded against refine_global, MultiStereoVO
against StereoVO, then two gloo processes sharing the card, bit-equal to
the world of one. Then the evaluation harnesses, each in this process:
svo_tpu_torch.eval_recovery (drift injected into a live 97-frame run; the
back-end's aggressive regime must fire, be accepted and recover it),
svo_tpu_torch.eval_ba (refine_global swept over the 97 frames above),
svo_tpu_torch.eval_fleet (a KITTI root built from kitti_mini, and 2
synthetic sequences) and svo_tpu_torch.eval_euroc (euroc_mini, held to
2 x svo_tpu's ATE), each counted against the launch rule. Every phase prints its lines;
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
from types import SimpleNamespace

import numpy as np
import torch

from svo_tpu_torch._measure import device_events, median_ms, per_second, smi_line

REPO = os.path.dirname(os.path.abspath(__file__))
SHAPE = (376, 1241)  # KITTI seq 00 image size, as bench.py
N_FRAMES = 97        # 1 bootstrap frame + 8 chunks of 12, as bench.py
ATE_LIMIT_M = 0.273  # the OpenCV reference pipeline's ATE on this sequence
# svo_tpu's own ATE on this sequence with the ORB detector, chunk 12, cadence
# 6, forward (examples/run_synthetic.py) and reversed, on a CPU (the JAX
# reference; PERF.md): an ORB run is held to the larger of ATE_LIMIT_M and
# 1.25 x svo_tpu's ORB ATE on the same frames in the same order
REF_ORB_ATE_M = {"forward": 0.1443, "reversed": 0.3559}
ORB_ATE_LIMIT_M = {d: max(ATE_LIMIT_M, 1.25 * a) for d, a in REF_ORB_ATE_M.items()}
# svo_tpu's ORB on tests/fixtures/kitti_mini (run frame by frame, CPU) lands
# in one of a few basins by PnP seed: 0.1581 0.1473 0.1473 0.1473 0.2303
# 0.1473 m for seeds 0-5, the worst past the fixture's FAST-made bound
REF_ORB_KITTI_MINI_WORST_M = 0.2303
ENGINES = ("patches", "fused")
STREAMS = 8          # batched main path: streams in lockstep, as bench.py
WORLD_STREAMS = 16   # the worlds suite: 8 worlds, forward and reversed
CHUNK, CADENCE = 12, 6
REFINE_EVERY = 2     # chunks between refine() sweeps, as bench.py
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
    forward-backward call (1 level), for one stream, for 8 in one launch
    (the batched main path) and for 16 (the worlds suite), on _track_inputs
    (the detector's corners, four slots pinned at and past the borders,
    ~25% dead slots, a random incoming flow).

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
    8- and 16-stream launches bit-equal to its single-stream launch.

    Timed, in turns within this call (chain, whole, whole, chain; CUDA
    events, median of 25): the wall of one tracker call through the chain
    of per-level wrapper calls and through the whole-call wrapper. The
    whole-call wall must be the lower one at every shape, one stream, 8 and
    16. The device time of a whole-call launch is read from the profiler's
    kernel records over 20 launches. The bound is the sum of the levels'
    bounds with the slots live at each level in this run."""
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.ops.lk_fused import (
        lk_track_level, lk_track_level_ref, lk_track_pyramid, lk_track_pyramid_chain,
        lk_track_pyramid_ref,
    )

    cfg = Config(use_orb=False, image_height=SHAPE[0], image_width=SHAPE[1])
    pairs = [f[1:] for f in frames[: WORLD_STREAMS + 1]]
    out = {"max_abs_err": 0.0}
    for S in (1, STREAMS, WORLD_STREAMS):
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
            # the profiler's tracing may drop records (seen once: fewer than the
            # 20 launched), so the mean is over the launches it did record
            seen = sum(e.count for e in evs)
            check(0 < seen <= 20, f"{tag}: the profiler recorded {seen} of 20 launches")
            device_us = sum(e.self_device_time_total for e in evs) / seen
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


def _config_and_camera(seq, device=None, use_orb=False):
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.geometry import camera as cam_mod

    cfg = Config(use_orb=use_orb, image_height=SHAPE[0], image_width=SHAPE[1])
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


def _expected_launches(engine: str, n_kf: int, steps: int = N_FRAMES - 1) -> int:
    """Launches of the path's kernel in a cadenced run of `steps` frame
    steps (bench.py's 97-frame run unless given) with n_kf keyframe steps,
    bootstraps included. patches:
    one extraction per pyramid level, so (temporal levels + the fb level)
    per frame and the stereo levels per keyframe (bootstrap included).
    fused: every level qualifies at 376x1241, so a tracker call is one
    launch: the temporal and the fb call per frame, the stereo call per
    keyframe. The count does not depend on the number of streams: a launch
    serves all of them."""
    from svo_tpu_torch.config import Config

    cfg = Config()
    if engine == "fused":
        return 2 * steps + n_kf
    per_frame = cfg.temporal_klt.max_level + 1 + 1
    per_kf = cfg.stereo_klt.max_level + 1
    return per_frame * steps + per_kf * n_kf


# the wrappers that launch each kernel: lk_level has the per-level entry and
# the whole-call entry, counted together
WRAPPERS = {"klt_patches": ("extract_klt_patches",),
            "lk_level": ("lk_track_level", "lk_track_pyramid")}
PATH_KERNEL = {"patches": "klt_patches", "fused": "lk_level"}


def _kernel_counts(counts: dict) -> dict:
    return {k: sum(counts[w] for w in ws) for k, ws in WRAPPERS.items()}


def _counts(kernels) -> dict:
    return {k.__name__: k.launches for k in kernels}


def _zero(kernels) -> None:
    for k in kernels:
        k.launches = 0


def _check_launches(tag, engine, counts, n_kf, steps: int = N_FRAMES - 1):
    expected = _expected_launches(engine, n_kf, steps)
    for name, count in _kernel_counts(counts).items():
        want = expected if name == PATH_KERNEL[engine] else 0
        check(count == want, f"{tag} {engine}: {name} launched {count} times, expected {want}")


def phase_main_path(kernels, frames, seq) -> tuple[dict, dict]:
    """bench.py's single-stream path once per KLT engine, then a profiled
    chunk of each. The runs are warm: the small agreement runs have driven
    the whole pipeline on the card before, and the kernels are built and
    loaded (no separate warm run, to keep the script inside its time).
    Returns the launches of each kernel wrapper in each engine's run, and
    each engine's ATE."""
    from svo_tpu_torch.eval.trajectory import ate_rmse

    launches, ates, warm = {}, {}, {}
    for engine in ENGINES:
        _zero(kernels)
        torch.cuda.reset_peak_memory_stats()
        res = _run(frames, seq, "cuda", engine)
        peak = torch.cuda.max_memory_allocated()
        warm[engine] = res.fps
        counts = _counts(kernels)
        launches[engine] = counts
        poses = res.poses
        check(poses.shape == (N_FRAMES, 4, 4), f"poses shape {poses.shape}")
        check(bool(np.isfinite(poses).all()), f"{engine}: NaN/inf in the poses")
        ate = ates[engine] = float(ate_rmse(poses, seq.gt_poses))
        inl = float(res.metrics[1:, 1].mean())
        live = float(res.metrics[:, 2].mean())
        n_kf = int(res.kf_flags.sum())
        print(f"main path lk_engine={engine}: ATE {ate:.4f} m (limit {ATE_LIMIT_M}) | "
              f"mean inlier ratio {inl:.4f} | mean live features {live:.1f} | "
              f"keyframes {n_kf} | {res.fps:.3f} frames/s, {1e3 / res.fps:.2f} ms/frame | "
              f"peak device memory {peak / 2**20:.1f} MiB | launches {counts}")
        check(np.isfinite(ate) and ate <= ATE_LIMIT_M, f"{engine}: ATE {ate} m > {ATE_LIMIT_M} m")
        check(inl >= 0.8, f"{engine}: mean inlier ratio {inl} < 0.8")
        check(live >= 60, f"{engine}: mean live features {live} < 60")
        _check_launches("single stream", engine, counts, n_kf)

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
    return launches, ates


def _stage_batched(frames, seq) -> SimpleNamespace:
    """bench.py's batched inputs on the card: 8 streams on its sequence
    (even streams forward, odd streams reversed), the first frames as f32
    and every chunk of 12 frames staged as uint8, frame-major."""
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
    staged = sum(t.numel() for c in chunks for t in c)
    print(f"batched main path: {S} streams x {N_FRAMES} frames, {n_chunks} chunks of {CHUNK} "
          f"staged on the card, {staged / 2**20:.1f} MiB uint8")
    return SimpleNamespace(cfg=cfg, cam=cam, gts=gts, l0=l0, r0=r0, stage=stage, chunks=chunks,
                           n_stepped=n_chunks * CHUNK)


def _stream_ates(trajs, staged) -> list:
    from svo_tpu_torch.eval.trajectory import ate_rmse

    n = staged.n_stepped + 1
    return [float(ate_rmse(trajs[s], staged.gts[s][:n])) for s in range(len(trajs))]


def phase_batched_main_path(kernels, seq, staged) -> dict:
    """The batched main path: BatchedStereoVO with 8 streams in lockstep on
    bench.py's sequence (even streams forward, odd streams reversed), chunk
    12, keyframe cadence 6, all chunks staged on the card as uint8, once
    per KLT engine with accuracy and launch-count checks, each run timed
    (warm: the single-stream paths ran before), then a profiled 6-frame
    chunk of each engine. Returns the launches of each kernel wrapper in
    each engine's run."""
    from svo_tpu_torch.parallel.batched import BatchedStereoVO

    S = STREAMS
    cfg, cam, l0, r0 = staged.cfg, staged.cam, staged.l0, staged.r0
    stage, chunks, n_stepped = staged.stage, staged.chunks, staged.n_stepped

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

    launches, warm = {}, {}
    for engine in ENGINES:
        _zero(kernels)
        torch.cuda.reset_peak_memory_stats()
        bvo, wall = drive(engine)
        peak = torch.cuda.max_memory_allocated()
        warm[engine] = S * n_stepped / wall
        counts = _counts(kernels)
        launches[engine] = counts
        trajs = bvo.trajectories(n_stepped + 1)
        check(trajs.shape == (S, N_FRAMES, 4, 4), f"batched poses shape {trajs.shape}")
        check(bool(np.isfinite(trajs).all()), f"batched {engine}: NaN/inf in the poses")
        ates = _stream_ates(trajs, staged)
        metrics = bvo.state.metrics[:, : n_stepped + 1].cpu().numpy()
        inl = metrics[:, 1:, 1].mean(axis=1)
        live = metrics[:, :, 2].mean(axis=1)
        n_kf = bvo.state.kf_flags[:, : n_stepped + 1].sum(dim=1).tolist()
        print(f"batched main path lk_engine={engine}: per-stream ATE "
              f"{' '.join(f'{a:.4f}' for a in ates)} m (limit {ATE_LIMIT_M}; the TPU package's "
              f"band 0.044-0.095) | mean inlier ratio per stream "
              f"{' '.join(f'{v:.4f}' for v in inl)} | mean live features per stream "
              f"{' '.join(f'{v:.1f}' for v in live)} | keyframes per stream {n_kf} | "
              f"{warm[engine]:.3f} frames/s aggregate, {1e3 * wall / n_stepped:.2f} ms per "
              f"lockstep frame step | peak device memory {peak / 2**20:.1f} MiB (staged chunks "
              f"included) | launches {counts}")
        for s in range(S):
            check(np.isfinite(ates[s]) and ates[s] <= ATE_LIMIT_M,
                  f"batched {engine}: stream {s} ATE {ates[s]} m > {ATE_LIMIT_M} m")
            check(inl[s] >= 0.8, f"batched {engine}: stream {s} mean inlier ratio {inl[s]} < 0.8")
            check(live[s] >= 60, f"batched {engine}: stream {s} mean live features {live[s]} < 60")
        check(len(set(n_kf)) == 1, f"batched {engine}: keyframe counts differ: {n_kf}")
        # the same count as ONE stream's run: a launch serves all streams
        _check_launches(f"batched S={S}", engine, counts, n_kf[0])

    prof_chunks = [stage(range(1 + c * 6, 7 + c * 6)) for c in range(2)]
    for engine in ENGINES:
        per, dev_ms, own = _launches_per_frame(seq, engine, (l0, r0), prof_chunks)
        own_us = " | ".join(f"{k} {v:.2f} us device per launch" for k, v in own.items())
        wall_ms = 1e3 * S / warm[engine]
        print(f"batched profile lk_engine={engine}: {per:.0f} device launches per lockstep "
              f"frame step ({per / S:.0f} per stream-frame) | {dev_ms:.2f} ms device kernel "
              f"time per step ({dev_ms / S:.2f} per stream-frame) | {own_us} | aggregate "
              f"frames/s {warm[engine]:.3f}, {wall_ms:.2f} ms wall per step | device busy share "
              f"{dev_ms / wall_ms:.3f}")
    return launches


def _to(tree, device):
    """A tensor, or a (nested) tuple of tensors, on `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    moved = [_to(x, device) for x in tree]
    return type(tree)(*moved) if hasattr(tree, "_fields") else tuple(moved)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    else:
        for x in tree:
            yield from _leaves(x)


def _bit_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def _max_abs(a, b) -> float:
    return float((a.cpu().double() - b.cpu().double()).abs().max())


def _rel(a, b, floor: float = 0.0) -> float:
    """max |a - b| / max(|b|, floor) over the elements (b the CPU's)."""
    a, b = a.cpu().double(), b.cpu().double()
    return float(((a - b).abs() / torch.clamp(b.abs(), min=max(floor, 1e-30))).max())


def _host_syncs(fn) -> int:
    """The synchronising CUDA calls (host reads of device data) that fn
    makes, as torch's sync debug mode reports them."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (setting the mode warns too, that it is a prototype: not counted)
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def phase_backend_agreement() -> None:
    """The back-end on the card against the port's own CPU run (the card's
    machine has no svo_tpu; the CPU run is what tests/test_torch_*.py hold
    against svo_tpu), on seeded fixtures (svo_tpu_torch/ba/synthetic.py),
    and each function twice on the card, which must give the same bits.
    The solvers must make no host read on the card (solve_ex, no checks)
    and refine_global exactly one, its `aggressive.any()`.

    Tolerances. Decisions identical: n_obs, `accepted`, `frame_lo`, the
    regime, which blocks improved. solve_ba (4 iterations, in which the
    problem converges), refine_alternate (6 rounds, both modes),
    optimize_pose_graph (3 iterations) and refine_global in the
    conservative regime (the near-GT span): poses 1e-4, points 1e-3,
    initial costs 1e-4 and final costs 1e-3 relative (a pose graph's final
    cost against a floor of 1e-4 of its initial cost: converged, it is the
    rounding of its residuals). refine_global in the aggressive regime (the
    drifted span) is held more loosely, and for a reason that was measured
    on an H100: the four block solves agree with the CPU's to 7e-6 in cost
    and 5e-5 in their camera poses (f32 normal equations on points 8-30 m
    away), and the consensus then chains 21 relative poses from the anchor,
    so that an edge's 5e-5 becomes 1-2 mm at the far end of a 7 m span (a
    lever arm, not an accept/reject flip: the difference grows smoothly
    over the pose-graph iterations). Poses 5e-3 (1.8e-3 read), points 3e-2
    (8.6e-3 read, on points whose depth the stereo rows pin to ~0.5 m),
    block costs 1e-3, the refined span cost and the pose-graph costs 5e-2
    relative (sums of squared mm-size residuals); and the rebuilt
    trajectory's error against ground truth within 2 mm of the CPU's."""
    from svo_tpu_torch.ba import synthetic
    from svo_tpu_torch.ba.pose_graph import optimize_pose_graph
    from svo_tpu_torch.ba.solver import refine_alternate, solve_ba
    from svo_tpu_torch.parallel.global_opt import refine_global

    K = torch.from_numpy(synthetic.K_MAT)
    bfx = synthetic.FX * synthetic.BASELINE

    def both(tag, fn, inputs, host_reads=0):
        cpu = fn(*inputs, K)
        on_card, K_card = _to(inputs, "cuda"), K.cuda()
        gpu, again = fn(*on_card, K_card), fn(*on_card, K_card)
        torch.cuda.synchronize()
        check(all(x.is_cuda for x in _leaves(gpu)), f"{tag}: a result is not on the card")
        same = _bit_equal(gpu, again)
        check(same, f"{tag}: two calls on the card differ")
        syncs = _host_syncs(lambda: fn(*on_card, K_card))
        check(syncs == host_reads, f"{tag}: {syncs} host reads on the card, expected {host_reads}")
        return cpu, gpu

    def held(tag, readings):
        """readings: (what, value, bound); print all, then raise on any."""
        print(f"back-end card vs CPU, {tag}: twice on the card bit-identical True, host reads "
              f"as expected | "
              + " | ".join(f"{w} {v:.3g} (<= {b:g})" for w, v, b in readings))
        for w, v, b in readings:
            check(v <= b, f"{tag}: {w} {v} > {b}")

    prob = (synthetic.ba_problem(0),)
    for tag, fn in (
        ("solve_ba 4 iterations", lambda p, K: solve_ba(p, K, bfx, iterations=4)),
        ("refine_alternate 6 rounds", lambda p, K: refine_alternate(p, K, bfx, rounds=6)),
        ("refine_alternate 6 rounds points_only",
         lambda p, K: refine_alternate(p, K, bfx, rounds=6, points_only=True)),
    ):
        cpu, gpu = both(tag, fn, prob)
        check(int(cpu.n_obs) == int(gpu.n_obs), f"{tag}: n_obs differs")
        check(float(gpu.cost) < float(gpu.cost0), f"{tag}: the cost did not fall")
        held(tag, [("poses", _max_abs(gpu.T_cw, cpu.T_cw), 1e-4),
                   ("points", _max_abs(gpu.points, cpu.points), 1e-3),
                   ("cost0 rel", _rel(gpu.cost0, cpu.cost0), 1e-4),
                   ("cost rel", _rel(gpu.cost, cpu.cost), 1e-3)])

    tag = "optimize_pose_graph 3 iterations"
    cpu, gpu = both(tag, lambda g, K: optimize_pose_graph(g, iterations=3), (synthetic.drifted_graph(0),))
    check(float(gpu.cost) < 1e-2 * float(gpu.cost0), f"{tag}: the graph did not converge")
    held(tag, [("poses", _max_abs(gpu.T_wc, cpu.T_wc), 1e-4),
               ("cost0 rel", _rel(gpu.cost0, cpu.cost0), 1e-3),
               ("cost rel", _rel(gpu.cost, cpu.cost, floor=1e-4 * float(cpu.cost0)), 1e-3)])

    for name, kw, aggressive in (("drifted span", {}, True),
                                 ("near-GT span", dict(drift_rot=0.0, drift_trans=0.0), False)):
        tag = f"refine_global, {name}"
        mp, poses, gt = synthetic.drifted_state(1, **kw)
        hi = torch.tensor(gt.shape[0] - 1, dtype=torch.int32)
        cpu, gpu = both(tag, lambda mp, poses, hi, K: refine_global(mp, poses, hi, K, bfx),
                        (mp, poses, hi), host_reads=1)
        regime = [float(r.cost_per_obs) > 10.0 for r in (cpu, gpu)]
        check(regime == [aggressive, aggressive], f"{tag}: regimes {regime}")
        check(bool(cpu.accepted) == bool(gpu.accepted), f"{tag}: accepted differs")
        check(int(cpu.frame_lo) == int(gpu.frame_lo), f"{tag}: frame_lo differs")
        check(torch.equal(cpu.ba_cost <= cpu.ba_cost0, (gpu.ba_cost <= gpu.ba_cost0).cpu()),
              f"{tag}: the blocks that improved differ")

        def ate(p):
            n = gt.shape[0]
            return float(torch.sqrt(((p.cpu()[:n, :3, 3] - gt[:, :3, 3]) ** 2).sum(-1).mean()))

        print(f"{tag}: aggressive {aggressive} | accepted {bool(gpu.accepted)} | cost per "
              f"observation {float(gpu.cost_per_obs):.3f} | span cost {float(gpu.span_cost0):.1f} "
              f"-> {float(gpu.span_cost):.1f} | ATE against ground truth {ate(poses):.4f} -> "
              f"{ate(gpu.poses):.4f} m")
        loose = aggressive
        readings = [("poses", _max_abs(gpu.poses, cpu.poses), 5e-3 if loose else 1e-4),
                    ("points", _max_abs(gpu.map.points, cpu.map.points), 3e-2 if loose else 1e-3),
                    ("span_cost0 rel", _rel(gpu.span_cost0, cpu.span_cost0), 1e-4),
                    ("cost_per_obs rel", _rel(gpu.cost_per_obs, cpu.cost_per_obs), 1e-4),
                    ("span_cost rel", _rel(gpu.span_cost, cpu.span_cost), 5e-2 if loose else 1e-3)]
        if aggressive:
            check(bool(gpu.accepted) and ate(gpu.poses) < 0.3 * ate(poses),
                  f"{tag}: the drifted span was not rebuilt")
            readings += [("ATE against the CPU's", abs(ate(gpu.poses) - ate(cpu.poses)), 2e-3),
                         ("ba_cost0 rel", _rel(gpu.ba_cost0, cpu.ba_cost0), 1e-4),
                         ("ba_cost rel", _rel(gpu.ba_cost, cpu.ba_cost), 1e-3),
                         ("pg_cost0 rel", _rel(gpu.pg_cost0, cpu.pg_cost0), 5e-2),
                         ("pg_cost rel", _rel(gpu.pg_cost, cpu.pg_cost), 5e-2)]
        else:
            check(not bool(gpu.ba_cost0.any()) and float(gpu.pg_cost0) == 0.0,
                  f"{tag}: the skipped branch did not return zeros")
            check(torch.equal(gpu.poses.cpu(), poses), f"{tag}: poses moved in the conservative regime")
        held(tag, readings)


def _sweep_readings(tag: str, refine, state) -> dict:
    """One refine sweep from `state` (not advanced): wall ms between CUDA
    events (median of 5; the sweep ends in a host read, so this is its
    whole time), device activities and device time from the profiler."""
    ms = median_ms(lambda: refine(state), reps=5, inner=1)
    dev = device_events(lambda: refine(state))
    acts = sum(e.count for e in dev)
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
    check(acts > 0, f"{tag}: the profiler saw no device activity")
    accepted = refine(state)[1].cpu().numpy()
    print(f"refine sweep, {tag}: {ms:.2f} ms a sweep for {STREAMS} streams (CUDA events) | "
          f"{acts} device activities | {dev_ms:.2f} ms device time | device busy share "
          f"{dev_ms / ms:.3f} | accepted {accepted.astype(int).tolist()}")
    return dict(ms=ms, activities=acts, device_ms=dev_ms)


def phase_refined_main_path(kernels, staged) -> SimpleNamespace:
    """bench.py's refined arm at full width: 8 streams, 376x1241, 97 frames,
    chunk 12, cadence 6, the fused engine, refine() (span 22, the defaults)
    every 2 chunks and at the last chunk inside the timed loop; beside it
    the same run without refine() in this call (without, then with; two
    turns, not four, to keep the script inside its time), after a warm-up
    of one chunk and one sweep as bench.py.
    Every stream's refined ATE must stay under the limit and the state
    finite; refine() must leave the kernels' launch count what it was.
    Then one sweep alone: from the final (healthy) state, and from that
    state with every stream's last 20 poses bent by a growing yaw and side
    slip (the aggressive regime). Returns the engine after a refined run."""
    from svo_tpu_torch.parallel.batched import BatchedStereoVO

    S, n_stepped = STREAMS, staged.n_stepped

    def drive(refine: bool):
        bvo = BatchedStereoVO(staged.cfg, staged.cam, S, chunk=CHUNK, kf_cadence=CADENCE,
                              lk_engine="fused")
        bvo.make_refiner()
        bvo.start(staged.l0, staged.r0)
        verdicts = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, c in enumerate(staged.chunks):
            bvo.process_chunk(*c)
            if refine and ((i + 1) % REFINE_EVERY == 0 or i == len(staged.chunks) - 1):
                verdicts.append(bvo.refine())
        torch.cuda.synchronize()
        return bvo, time.perf_counter() - t0, verdicts

    warm = BatchedStereoVO(staged.cfg, staged.cam, S, chunk=CHUNK, kf_cadence=CADENCE,
                           lk_engine="fused")
    warm.start(staged.l0, staged.r0)
    warm.process_chunk(*staged.chunks[0])
    warm.refine()

    fps = {False: [], True: []}
    ates = {}
    for turn, refine in enumerate((False, True)):
        _zero(kernels)
        bvo, wall, verdicts = drive(refine)
        counts = _counts(kernels)
        trajs = bvo.trajectories(n_stepped + 1)
        check(all(bool(torch.isfinite(x).all()) for x in _leaves(bvo.state)
                  if x.is_floating_point()), f"refined arm turn {turn}: non-finite state")
        n_kf = bvo.state.kf_flags[:, : n_stepped + 1].sum(dim=1).tolist()
        _check_launches(f"refined arm turn {turn}", "fused", counts, n_kf[0])
        ates[refine] = _stream_ates(trajs, staged)
        fps[refine].append(S * n_stepped / wall)
        line = (f"refined arm turn {turn}, refine {'every 2 chunks + flush' if refine else 'off'}: "
                f"{fps[refine][-1]:.3f} frames/s aggregate | {wall:.3f} s | per-stream ATE "
                f"{' '.join(f'{a:.4f}' for a in ates[refine])} m | launches {counts}")
        if refine:
            line += " | accepted per sweep " + " ".join(
                "".join(str(int(v)) for v in acc) for acc in verdicts)
            n_chunks = len(staged.chunks)  # the terminal flush adds a sweep to an odd count
            check(len(verdicts) == n_chunks // REFINE_EVERY + (n_chunks % REFINE_EVERY > 0),
                  f"{len(verdicts)} sweeps")
            refined_bvo = bvo
        print(line)
        for s, a in enumerate(ates[refine]):
            check(np.isfinite(a) and a <= ATE_LIMIT_M,
                  f"refined arm turn {turn}: stream {s} ATE {a} m > {ATE_LIMIT_M} m")
    with_, without = float(np.mean(fps[True])), float(np.mean(fps[False]))
    print(f"refined arm: per-stream ATE refined {' '.join(f'{a:.4f}' for a in ates[True])} m beside "
          f"unrefined {' '.join(f'{a:.4f}' for a in ates[False])} m in this call (limit "
          f"{ATE_LIMIT_M}; the TPU package's BENCH_r05.json, an accuracy reference: 0.0391-0.0968 "
          f"refined, 0.0444-0.0949 unrefined) | aggregate frames/s with refine "
          f"{' / '.join(f'{f:.3f}' for f in fps[True])}, without "
          f"{' / '.join(f'{f:.3f}' for f in fps[False])}: {with_ / without:.3f} of without "
          f"(one turn each: inside the host's spread)")

    state = refined_bvo.state
    healthy = _sweep_readings("healthy spans", refined_bvo._refine, state)
    # drift: the last 20 frames of every stream leave the map behind
    F = n_stepped + 1
    k = torch.arange(1, 21, dtype=torch.float32, device="cuda")
    bend = torch.eye(4, device="cuda").repeat(20, 1, 1)
    bend[:, 0, 0] = bend[:, 2, 2] = torch.cos(0.004 * k)
    bend[:, 0, 2] = torch.sin(0.004 * k)
    bend[:, 2, 0] = -torch.sin(0.004 * k)
    bend[:, 0, 3] = 0.02 * k
    poses = state.poses.clone()
    poses[:, F - 20: F] = poses[:, F - 20: F] @ bend
    drifted = state._replace(poses=poses, pose=poses[:, F - 1])
    from svo_tpu_torch.parallel.global_opt import refine_global

    res = refine_global(drifted.map, drifted.poses, drifted.frame_id, refined_bvo.camera.K,
                        refined_bvo.camera.K[0, 0] * refined_bvo.camera.baseline)
    regime = (res.cost_per_obs > 10.0).tolist()
    check(all(regime), f"the bent spans are not all in the aggressive regime: {regime}")
    bent_ates = _stream_ates(drifted.poses[:, :F].cpu().numpy(), staged)
    back_ates = _stream_ates(res.poses[:, :F].cpu().numpy(), staged)
    print(f"refine sweep, drifted spans: cost per observation "
          f"{' '.join(f'{c:.1f}' for c in res.cost_per_obs.tolist())} | ATE bent "
          f"{' '.join(f'{a:.3f}' for a in bent_ates)} -> refined "
          f"{' '.join(f'{a:.3f}' for a in back_ates)} m | accepted "
          f"{res.accepted.int().tolist()}")
    aggressive = _sweep_readings("drifted spans (aggressive regime)", refined_bvo._refine, drifted)
    check(aggressive["activities"] > healthy["activities"],
          "the aggressive regime ran no more than the conservative one")
    return refined_bvo


def phase_ba_throughput(bvo) -> None:
    """bench.py's BA stage: solve_ba, 10 LM iterations, on the window of the
    last 10 frames (1024 point slots, 4096 observation slots) extracted
    from stream 0's live map after the refined run; 20 repetitions."""
    from svo_tpu_torch.ba.solver import solve_ba
    from svo_tpu_torch.ba.window import extract_window
    from svo_tpu_torch.pipeline.state import unstack

    iters, reps = 10, 20
    st0 = unstack(bvo.state)[0]
    problem, _ = extract_window(st0.map, st0.poses, st0.frame_id, n_cams=10, n_points=1024, n_obs=4096)
    K = bvo.camera.K
    bfx = K[0, 0] * bvo.camera.baseline
    res = solve_ba(problem, K, bfx, iterations=iters)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        res = solve_ba(problem, K, bfx, iterations=iters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dev = device_events(lambda: solve_ba(problem, K, bfx, iterations=iters))
    acts = sum(e.count for e in dev)
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
    check(bool(torch.isfinite(res.cost)) and float(res.cost) <= float(res.cost0),
          "BA throughput: the solve did not lower a finite cost")
    print(f"BA throughput: {iters * reps / wall:.1f} LM iterations/s | {1e3 * wall / reps:.2f} ms a "
          f"solve of {iters} iterations | window of {int(problem.obs_valid.sum())} valid "
          f"observations, {int(problem.pnt_valid.sum())} points, {int(problem.cam_valid.sum())} "
          f"cameras | cost {float(res.cost0):.1f} -> {float(res.cost):.1f} | {acts / iters:.0f} "
          f"device activities and {dev_ms / iters:.3f} ms device time an iteration")


def phase_ba_main_path(frames, seq, ate_off: float) -> None:
    """One stream with the in-pipeline window BA at its defaults (window 8
    keyframes, every 4 keyframes, 10 iterations), fused engine, bench.py's
    sequence through run_chunked. The BA solves are counted at the
    frontend's call and held against what its rule gives from kf_flags."""
    from svo_tpu_torch.config import BaParams, Config
    from svo_tpu_torch.eval.trajectory import ate_rmse
    from svo_tpu_torch.geometry import camera as cam_mod
    from svo_tpu_torch.pipeline import frontend
    from svo_tpu_torch.pipeline.odometry import StereoVO

    cfg = Config(use_orb=False, image_height=SHAPE[0], image_width=SHAPE[1], ba=BaParams(enabled=True))
    cam = cam_mod.from_intrinsics(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline)
    vo = StereoVO(cfg, cam, chunk=CHUNK, kf_cadence=CADENCE, lk_engine="fused")
    solved = []
    window_ba = frontend._window_ba

    def counted(mp, poses, kf_flags, fid, camera, cfg):
        solved.append(int(fid))
        return window_ba(mp, poses, kf_flags, fid, camera, cfg)

    frontend._window_ba = counted
    try:
        res = vo.run_chunked(frames)
    finally:
        frontend._window_ba = window_ba
    check(bool(np.isfinite(res.poses).all()), "BA main path: NaN/inf in the poses")
    count = np.cumsum(res.kf_flags)
    due = [f for f in range(1, N_FRAMES) if res.kf_flags[f] and count[f] >= cfg.ba.window
           and count[f] % cfg.ba.interval == 0]
    ate = float(ate_rmse(res.poses, seq.gt_poses))
    print(f"BA main path (ba.enabled, window {cfg.ba.window}, interval {cfg.ba.interval}, fused): "
          f"ATE {ate:.4f} m beside {ate_off:.4f} m with BA off (limit {ATE_LIMIT_M}) | keyframes "
          f"{int(res.kf_flags.sum())} | BA solves at frames {solved}, the rule gives {due} | "
          f"{res.fps:.3f} frames/s | mean inlier ratio {float(res.metrics[1:, 1].mean()):.4f}")
    check(solved == due, f"BA solves at {solved}, the rule gives {due}")
    check(len(due) == 3, f"expected 3 BA solves in {N_FRAMES} frames, the rule gives {len(due)}")
    check(np.isfinite(ate) and ate <= ATE_LIMIT_M, f"BA main path: ATE {ate} m > {ATE_LIMIT_M} m")


def phase_checkpoint(staged) -> None:
    """Checkpoint on the card: 8 streams, fused engine, refine() after every
    2 chunks. The state and the generator are saved after chunk 2; a fresh
    engine (started with another seed) loads them; both run chunks 3-4:
    every leaf of the two final states must be bit-equal. (Chunks 1-4 of
    the 8, for the script's time: the soak phase resumes a single stream
    over a live ring wrap.)"""
    import tempfile

    from svo_tpu_torch.parallel.batched import BatchedStereoVO
    from svo_tpu_torch.pipeline.state import leaves
    from svo_tpu_torch.utils.checkpoint import load_state, save_state

    def engine(seed):
        bvo = BatchedStereoVO(staged.cfg, staged.cam, STREAMS, chunk=CHUNK, kf_cadence=CADENCE,
                              lk_engine="fused")
        bvo.start(staged.l0, staged.r0, seed=seed)
        return bvo

    def run(bvo, first, last):
        for i in range(first, last):
            bvo.process_chunk(*staged.chunks[i])
            if (i + 1) % REFINE_EVERY == 0:
                bvo.refine()

    n = len(staged.chunks) // 2
    half = n // 2
    a = engine(0)
    run(a, 0, half)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        save_state(path, a.state, a.generator)
        size = os.path.getsize(path)
        b = engine(1)
        b.state = load_state(path, b.state, b.generator)
    check(all(x.is_cuda for x in leaves(b.state)), "the loaded state is not on the card")
    run(a, half, n)
    run(b, half, n)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(leaves(a.state), leaves(b.state)))
    dt = _max_abs(a.state.poses, b.state.poses)
    print(f"checkpoint on the card: saved after chunk {half} ({size / 2**20:.1f} MiB), resumed in a "
          f"fresh engine, chunks {half + 1}-{n} with refine() in the loop: every "
          f"leaf bit-equal {same} | max |pose diff| {dt}")
    check(same, "a resumed run differs from the run its checkpoint was taken from")

def _norm_rel(got, want) -> float:
    """max |got - want| / max |want| (want the CPU's)."""
    got, want = got.cpu().double(), want.cpu().double()
    return float((got - want).abs().max() / want.abs().max())


def phase_orb_agreement(frames) -> dict:
    """The ORB detector (plain PyTorch, no kernel of its own) on the card
    against the port's CPU path, on three frames of the 376x1241 sequence,
    one stream at a time and as an (8, H, W) stack (the three left frames,
    the three right frames, two left frames mirrored). TF32 must be off:
    the scale pyramid is a matrix product, and TF32 moves it ~1e-3.

    Tolerances (the Harris response is not bit-reproducible: the card's
    cumsum is a parallel scan and its matrix products add in other orders):
    every scale_pyramid level and every level's harris_response within
    1e-4 of the CPU's max |value|; detect_orb's valid positions equal as
    multisets up to near-ties, at most 2% of the valid slots flipped, each
    flipped candidate's Harris score within 1e-4 of max |Harris| of a
    level's quota cut-off or the merge's (ops/detect.compare_orb). Then
    one detect_orb call of one stream and of 8, timed with CUDA events."""
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.ops import detect, harris, pyramid

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    check(torch.get_float32_matmul_precision() == "highest",
          f"float32 matmul precision is {torch.get_float32_matmul_precision()}")
    cfg = Config(image_height=SHAPE[0], image_width=SHAPE[1])
    op = cfg.orb_params
    picks = (0, N_FRAMES // 2, N_FRAMES - 1)
    lefts = [frames[i][1] for i in picks]
    stack = np.ascontiguousarray(np.stack(
        lefts + [frames[i][2] for i in picks] + [lefts[0][:, ::-1], lefts[1][:, ::-1]]))
    out = dict(pyramid_rel=0.0, harris_rel=0.0, flipped=0, worst_flip=0.0)

    def agree(tag, cpu):
        gpu = cpu.cuda()
        lc = pyramid.scale_pyramid(cpu, op.pyr_levels, op.scale_factor)
        lg = pyramid.scale_pyramid(gpu, op.pyr_levels, op.scale_factor)
        prel = max(_norm_rel(g, c) for g, c in zip(lg, lc))
        hc = [harris.harris_response(c) for c in lc]
        hrel = max(_norm_rel(harris.harris_response(g), h) for g, h in zip(lg, hc))
        dc = detect.detect_orb(cpu, None, cfg)
        dg = [x.cpu() for x in detect.detect_orb(gpu, None, cfg)]
        cands = detect.orb_candidates(cpu, cfg)
        rows = []
        for s in range(cpu.shape[0] if cpu.dim() == 3 else 1):
            pick = (lambda x: x[s]) if cpu.dim() == 3 else (lambda x: x)
            ref = [pick(x).numpy() for x in dc]
            cuts = [float(pick(sc)[-1]) for _, sc in cands]
            if ref[2].all():
                cuts.append(float(ref[1][-1]))
            hmax = float(pick(hc[0]).abs().max())
            res = detect.compare_orb(ref, [pick(x).numpy() for x in dg], cuts, 1e-4 * hmax)
            rows.append(res)
            check(res["ok"] and res["n_ref"] >= 100,
                  f"ORB {tag} stream {s}: card and CPU detections disagree: {res}")
        flipped = sum(r["flipped"] for r in rows)
        worst = max(r["worst"] for r in rows)
        print(f"ORB card vs CPU, {tag}: scale_pyramid max|diff| {prel:.3g} of max | harris_response "
              f"{hrel:.3g} of max (<= 1e-4) | detect_orb valid {[r['n_ref'] for r in rows]} on the "
              f"CPU, {[r['n_got'] for r in rows]} on the card, {flipped} flipped, worst flip "
              f"{worst:.3g} from a cut-off")
        check(prel <= 1e-4, f"ORB {tag}: scale_pyramid differs by {prel} of max")
        check(hrel <= 1e-4, f"ORB {tag}: harris_response differs by {hrel} of max")
        out["pyramid_rel"] = max(out["pyramid_rel"], prel)
        out["harris_rel"] = max(out["harris_rel"], hrel)
        out["flipped"] += flipped
        out["worst_flip"] = max(out["worst_flip"], worst)
        return gpu

    for i, img in zip(picks, lefts):
        one = agree(f"frame {i}, one stream", torch.from_numpy(img))
    eight = agree("(8, H, W) stack", torch.from_numpy(stack))
    out["ms_1"] = median_ms(lambda: detect.detect_orb(one, None, cfg), reps=10, inner=2)
    out["ms_8"] = median_ms(lambda: detect.detect_orb(eight, None, cfg), reps=10, inner=2)
    dev = device_events(lambda: detect.detect_orb(one, None, cfg))
    out["activities_1"] = sum(e.count for e in dev)
    out["device_ms_1"] = sum(e.self_device_time_total for e in dev) / 1e3
    print(f"ORB detect_orb, {op.pyr_levels} levels, nfeatures {op.nfeatures}, quotas "
          f"{detect.orb_quotas(cfg)}: one stream {out['ms_1']:.3f} ms, 8 streams "
          f"{out['ms_8']:.3f} ms a call (CUDA events) | one stream {out['activities_1']} device "
          f"activities, {out['device_ms_1']:.3f} ms device time (profiler) | TF32 off")
    return out


def _step_profile(frames, seq, use_orb: bool, engine: str = "fused") -> dict:
    """Device activities and device time (profiler) of one keyframe step
    (kf_mode "always": detection, stereo KLT, triangulation on top of the
    tracking) and one tracking step ("never"), from a warm state, with the
    given detector."""
    from svo_tpu_torch.pipeline import frontend

    cfg, cam = _config_and_camera(seq, "cuda", use_orb=use_orb)
    imgs = [tuple(torch.from_numpy(f[k]).cuda() for k in (1, 2)) for f in frames[:5]]
    gen = torch.Generator(device=imgs[0][0].device).manual_seed(0)
    st = frontend.make_bootstrap(cam, cfg, engine)(*imgs[0])

    def step(st, i, mode):
        return frontend.step_body(st, *imgs[i], cam, cfg, kf_mode=mode, generator=gen,
                                  lk_engine=engine)

    st = step(step(st, 1, "always"), 2, "never")  # warm
    out = {}
    for i, mode in ((3, "always"), (4, "never")):
        dev = device_events(lambda: step(st, i, mode))
        out[mode] = (sum(e.count for e in dev), sum(e.self_device_time_total for e in dev) / 1e3)
    return out


def phase_shipping_main_path(kernels, frames, seq) -> dict:
    """The shipping configuration (Config(): the ORB detector) through the
    port's own entry point, svo_tpu_torch.run_synthetic.main, in this
    process so that the launch counters stay readable: bench.py's 97-frame
    376x1241 sequence on the card, (a) chunk 12, keyframe cadence 6, the
    fused engine; (b) chunk 12, cadence 0 (the data-dependent keyframe rule
    inside the chunk), the patches engine. The kernels are built, loaded
    and warm from the earlier phases, so its frames/s are warm. Each must stay under max(0.273 m, 1.25 x svo_tpu's own
    ORB ATE), with a mean inlier ratio >= 0.8 and >= 60 mean live features,
    and launch its engine's kernel exactly as the launch rule gives for its
    keyframes (the other kernel not at all). Then one keyframe step and one
    tracking step under the profiler, ORB beside FAST."""
    import tempfile

    from svo_tpu_torch import run_synthetic

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, engine, cadence in (("a", "fused", CADENCE), ("b", "patches", 0)):
            path = os.path.join(tmp, f"{tag}.json")
            _zero(kernels)
            rc = run_synthetic.main([
                "--frames", str(N_FRAMES), "--chunk", str(CHUNK), "--cadence", str(cadence),
                "--lk-engine", engine, "--device", "cuda", "--seed", "0",
                "--out-json", path])
            counts = _counts(kernels)
            with open(path) as f:
                r = json.load(f)
            r.update(tag=tag, counts=counts)
            runs[tag] = r
            mode = f"cadence {cadence}" if cadence else "dynamic keyframes"
            limit = ORB_ATE_LIMIT_M["forward"]
            print(f"shipping path ({tag}) Config() ORB, chunk {CHUNK}, {mode}, lk_engine={engine}, "
                  f"via run_synthetic.main: ATE {r['ate_m']:.4f} m (limit {limit:.4f}; svo_tpu's "
                  f"ORB {REF_ORB_ATE_M['forward']}, CPU) | RPE {r['rpe_m']:.4f} m | mean inlier "
                  f"ratio {r['mean_inlier_ratio']:.4f} | mean live features "
                  f"{r['mean_features']:.1f} | keyframes {r['keyframes']} | {r['fps']:.3f} "
                  f"frames/s | launches {counts}")
            check(r["device"].startswith("cuda") and r["finite"], f"shipping ({tag}): {r}")
            check(r["ate_m"] <= limit, f"shipping ({tag}): ATE {r['ate_m']} m > {limit} m")
            check(r["mean_inlier_ratio"] >= 0.8, f"shipping ({tag}): mean inlier ratio < 0.8")
            check(r["mean_features"] >= 60, f"shipping ({tag}): mean live features < 60")
            expected = _expected_launches(engine, r["keyframes"])
            for name, count in _kernel_counts(counts).items():
                want = expected if name == PATH_KERNEL[engine] else 0
                check(count == want, f"shipping ({tag}): {name} launched {count} times, "
                                     f"expected {want}")
    prof = {orb: _step_profile(frames, seq, orb) for orb in (True, False)}
    for mode in ("always", "never"):
        (a_orb, ms_orb), (a_fast, ms_fast) = prof[True][mode], prof[False][mode]
        print(f"profile, one {'keyframe' if mode == 'always' else 'tracking'} step, fused: ORB "
              f"{a_orb} device activities, {ms_orb:.2f} ms device time | FAST {a_fast}, "
              f"{ms_fast:.2f} ms")
    runs["profile"] = prof
    return runs


def phase_shipping_batched(kernels, staged) -> dict:
    """The shipping configuration (ORB) on the batched path: 8 streams in
    lockstep (even forward, odd reversed), chunk 12, cadence 6, the fused
    engine, bench.py's chunks staged on the card: every stream's ATE under
    the ORB limit of its direction (svo_tpu's own ORB reads 0.3559 m on the
    reversed frames, past ATE_LIMIT_M), with a mean inlier ratio >= 0.8 and
    >= 60 live features,
    the kernel launched as often as for one stream; the run's aggregate
    frames/s (warm: the FAST runs of the same path came first) and peak
    memory."""
    from svo_tpu_torch.parallel.batched import BatchedStereoVO

    S, n_stepped = STREAMS, staged.n_stepped
    cfg = dataclasses.replace(staged.cfg, use_orb=True)

    def drive():
        bvo = BatchedStereoVO(cfg, staged.cam, S, chunk=CHUNK, kf_cadence=CADENCE, lk_engine="fused")
        bvo.start(staged.l0, staged.r0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in staged.chunks:
            bvo.process_chunk(*c)
        torch.cuda.synchronize()
        return bvo, time.perf_counter() - t0

    _zero(kernels)
    torch.cuda.reset_peak_memory_stats()
    bvo, wall = drive()
    peak = torch.cuda.max_memory_allocated()
    counts = _counts(kernels)
    trajs = bvo.trajectories(n_stepped + 1)
    check(bool(np.isfinite(trajs).all()), "batched ORB: NaN/inf in the poses")
    ates = _stream_ates(trajs, staged)
    metrics = bvo.state.metrics[:, : n_stepped + 1].cpu().numpy()
    inl, live = metrics[:, 1:, 1].mean(axis=1), metrics[:, :, 2].mean(axis=1)
    n_kf = bvo.state.kf_flags[:, : n_stepped + 1].sum(dim=1).tolist()
    fps = S * n_stepped / wall
    print(f"batched shipping path, ORB, S={S}, fused: per-stream ATE "
          f"{' '.join(f'{a:.4f}' for a in ates)} m (limits {ORB_ATE_LIMIT_M['forward']:.4f} forward, "
          f"{ORB_ATE_LIMIT_M['reversed']:.4f} reversed) | mean inlier "
          f"ratio per stream {' '.join(f'{v:.4f}' for v in inl)} | mean live features per stream "
          f"{' '.join(f'{v:.1f}' for v in live)} | keyframes per stream {n_kf} | "
          f"{fps:.3f} frames/s aggregate | peak device memory "
          f"{peak / 2**20:.1f} MiB (staged chunks included) | launches {counts}")
    for s in range(S):
        limit = ORB_ATE_LIMIT_M["reversed" if s % 2 else "forward"]
        check(ates[s] <= limit, f"batched ORB: stream {s} ATE {ates[s]} m > {limit} m")
        check(inl[s] >= 0.8, f"batched ORB: stream {s} mean inlier ratio {inl[s]} < 0.8")
        check(live[s] >= 60, f"batched ORB: stream {s} mean live features {live[s]} < 60")
    check(len(set(n_kf)) == 1, f"batched ORB: keyframe counts differ: {n_kf}")
    _check_launches(f"batched ORB S={S}", "fused", counts, n_kf[0])
    return dict(counts=counts, ates=ates, fps=fps, peak_mib=peak / 2**20)


def phase_cli_fixture() -> dict:
    """python3 -m svo_tpu_torch.run_kitti on tests/fixtures/kitti_mini (12
    pairs at 96x320, zero-padded to Config()'s 376x1241) with the shipping
    ORB detector and the span-by-span refinement, as a process of its own
    on the card: exit 0, a 12-line trajectory and a per-frame JSONL of 12
    lines. Its ATE is held to the larger of tests/test_kitti_e2e.py's bound,
    max(5% of the distance traveled, 5 cm), which that test sets for FAST,
    and 1.25 x the worst ATE svo_tpu's own ORB reaches on the fixture over
    PnP seeds 0-5: with ORB both packages land in the same few basins by
    PnP noise (0.1473-0.2303 m), and the card's noise is not the CPU's. It reads the frames through the
    native prefetcher where native/loader.cpp builds (g++ and the libpng
    headers), else through io.kitti.SequenceReader (PIL); its first line
    says which."""
    import subprocess
    import tempfile

    from svo_tpu_torch.eval.trajectory import ate_rmse
    from svo_tpu_torch.io import kitti

    fix = os.path.join(REPO, "tests", "fixtures", "kitti_mini")
    with tempfile.TemporaryDirectory() as tmp:
        traj, records = os.path.join(tmp, "traj.txt"), os.path.join(tmp, "frames.jsonl")
        cmd = [sys.executable, "-m", "svo_tpu_torch.run_kitti", "--path", fix,
               "--calib", os.path.join(fix, "calib.txt"), "--gt", os.path.join(fix, "poses.txt"),
               "--refine", "--refine-blocks", "2", "--refine-cams", "5",
               "--out", traj, "--metrics-out", records]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            print(f"  run_kitti | {line}")
        check(proc.returncode == 0, f"run_kitti exited {proc.returncode}: {proc.stderr[-2000:]}")
        rows = np.loadtxt(traj)
        with open(records) as f:
            n_records = sum(1 for line in f if line.strip())
    check(rows.shape == (12, 12), f"run_kitti trajectory shape {rows.shape}")
    poses = np.tile(np.eye(4), (12, 1, 1))
    poses[:, :3, :4] = rows.reshape(12, 3, 4)
    gt = kitti.parse_ground_truth(os.path.join(fix, "poses.txt"))
    traveled = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())
    e2e_bound = max(0.05 * traveled, 0.05)
    ate = float(ate_rmse(poses, gt))
    bound = max(e2e_bound, 1.25 * REF_ORB_KITTI_MINI_WORST_M)
    reader = proc.stdout.splitlines()[0].split(":", 1)[1].strip()
    print(f"CLI fixture: run_kitti on kitti_mini, ORB, --refine, on the card: ATE {ate:.4f} m "
          f"(bound {bound:.4f}: 1.25 x svo_tpu's worst ORB basin {REF_ORB_KITTI_MINI_WORST_M}; "
          f"the FAST-made bound {e2e_bound:.4f} {'met' if ate < e2e_bound else 'not met'}) | "
          f"{n_records} per-frame records | frames through {reader} | "
          f"{wall:.1f} s for the whole process")
    check(ate < bound, f"run_kitti on kitti_mini: ATE {ate} m >= {bound} m")
    check(n_records >= 12, f"run_kitti wrote {n_records} per-frame records")
    return dict(ate=ate, reader=reader, wall_s=wall)

SOAK_FRAMES = 241    # 20 chunks of 12: the ring (32,768 slots) wraps once
WORLDS_FRAMES = 49   # 4 chunks of 12 of each of the 16 sequences of 241 frames
DIST_SHARDS = 8      # as svo_tpu_torch/multihost_ba_worker.py

def phase_soak(kernels) -> dict:
    """svo_tpu_torch.soak at 376x1241, 241 frames (20 chunks), fused,
    refine_global every 2 chunks, a checkpoint at chunk 10 and 4 chunks
    re-run from it in a fresh engine. ~144 observations a frame wrap the
    32,768-slot ring once. Held: at least one wrap; the window extracted at
    the last frame, after the wrap, holds only in-window rows; the resume
    bit-equal; the ATE finite and under the reference CPU's 0.273 m; the
    lk_level launches those of the launch rule over the main run and the
    rerun."""
    from svo_tpu_torch import soak
    from svo_tpu_torch.ba.window import extract_window

    _zero(kernels)
    argv = ["--frames", str(SOAK_FRAMES), "--refine-every", str(REFINE_EVERY), "--ckpt-at", "10",
            "--resume-chunks", "4", "--lk-engine", "fused", "--device", "cuda"]
    t0 = time.perf_counter()
    r, vo = soak.soak(soak.parse_args(argv))
    wall = time.perf_counter() - t0
    counts = _counts(kernels)
    cap, res = r["capacity"], r["resume"]
    st = vo.state
    fid = int(st.frame_id)
    prob, mapping = extract_window(st.map, st.poses, st.frame_id, n_cams=6, n_points=512, n_obs=1024)
    ov = prob.obs_valid
    cams = prob.obs_cam[ov]
    in_window = bool(ov.any()) and int(mapping.frame_lo) == fid - 5 and \
        int(cams.min()) >= 0 and int(cams.max()) <= 5
    print(f"soak: {r['frames']} frames 376x1241 fused, refine every {REFINE_EVERY} chunks "
          f"({r['refine']['accepted']}/{r['refine']['calls']} accepted) | ATE {r['ate_m']} m = "
          f"{r['ate_pct_of_traveled']}% of {r['traveled_m']} m (limit {ATE_LIMIT_M}) | "
          f"{cap['obs_written']} observations into a {cap['obs_ring']}-slot ring: "
          f"{cap['ring_wraps']} wrap(s) | {cap['points_used']} points | window at frame {fid} after "
          f"the wrap: {int(ov.sum())} rows, all in frames {fid - 5}-{fid}: {in_window} | resume "
          f"from chunk {res['checkpoint_chunk']}, {res['chunks_rerun']} chunks: max |pose diff| "
          f"{res['max_pose_diff']} | {r['fps_excl_render']:.3f} frames/s excluding rendering, "
          f"{r['fps_device_sustained']:.3f} frames/s over {r['device_window_frames']} staged frames | "
          f"tracked p5 {r['health']['tracked_p5']}, inlier ratio min "
          f"{r['health']['inlier_ratio_min']} | {wall:.1f} s | launches {counts}")
    check(cap["ring_wraps"] >= 1, f"soak: the observation ring did not wrap ({cap})")
    check(in_window, "soak: the window extracted after the wrap holds rows outside it")
    check(res["max_pose_diff"] == 0.0, f"soak: the resumed run differs ({res})")
    check(r["finite"] and np.isfinite(r["ate_m"]) and r["ate_m"] < ATE_LIMIT_M,
          f"soak: ATE {r['ate_m']} m")
    _check_launches("soak", "fused", counts, r["steps"]["keyframes"], r["steps"]["frames"])
    return dict(counts=counts, result=r)


def phase_worlds(kernels) -> dict:
    """svo_tpu_torch.eval_worlds: the eight worlds forward and reversed, 16
    streams of one BatchedStereoVO at 376x1241, the first 49 frames of each
    241-frame sequence, refine() every 2 chunks, no reference pipeline (the
    script's full length; PERF.md has that run). A 49-frame sequence would
    be another world: its loop would turn 7 degrees a frame, and at this
    size the port loses it with either KLT engine (ROADMAP C). Held: every stream finite and still tracking
    at its last frame, corridor-base under 0.273 m both ways, and one
    lk_level launch per tracker call for all 16 streams (phase_lk_track
    holds that launch against its plain version at these shapes)."""
    from svo_tpu_torch import eval_worlds

    _zero(kernels)
    argv = ["--frames", "241", "--limit", str(WORLDS_FRAMES), "--refine-every", str(REFINE_EVERY),
            "--skip-ref", "--lk-engine", "fused", "--device", "cuda"]
    t0 = time.perf_counter()
    r, _ = eval_worlds.evaluate(eval_worlds.parse_args(argv))
    wall = time.perf_counter() - t0
    counts = _counts(kernels)
    check(r["streams"] == WORLD_STREAMS,
          f"worlds: {r['streams']} streams, phase_lk_track checks {WORLD_STREAMS}")
    for row in r["worlds"]:
        print(f"  worlds | {row['world']:<22} fwd ATE {row['ate_fwd_m']:.4f} m, tracked "
              f"{row['tracked_last_fwd']} | rev ATE {row['ate_rev_m']:.4f} m, tracked "
              f"{row['tracked_last_rev']}")
    agg = r["refine"]["aggressive"]
    print(f"worlds: {r['streams']} streams x {r['frames_per_world']} frames 376x1241 fused, "
          f"refine() every {REFINE_EVERY} chunks ({r['refine']['sweeps']} sweeps; aggressive "
          f"spans {[(a['world'], a['dir'], a['chunk'], a['accepted']) for a in agg]}) | "
          f"{r['fps_aggregate_excl_render']:.3f} frames/s aggregate excluding rendering | "
          f"{wall:.1f} s | launches {counts}")
    for row in r["worlds"]:
        for d in ("fwd", "rev"):
            check(row[f"finite_{d}"] and np.isfinite(row[f"ate_{d}_m"]),
                  f"worlds: {row['world']} {d} is not finite")
            check(row[f"tracked_last_{d}"] > 0, f"worlds: {row['world']} {d} lost tracking")
    base = r["worlds"][0]
    check(base["world"] == "corridor-base" and max(base["ate_fwd_m"], base["ate_rev_m"]) < ATE_LIMIT_M,
          f"worlds: corridor-base ATE {base['ate_fwd_m']} / {base['ate_rev_m']} m")
    _check_launches("worlds", "fused", counts, r["steps"]["keyframes"], r["steps"]["frames"])
    return dict(counts=counts, result=r)


RECOVERY_FRAMES, RECOVERY_INJECT_AT = 97, 49   # eval_recovery's 241 / 121, depth cut
EUROC_MINI_ATE_M = 0.0455  # svo_tpu's EUROC_r05.json on tests/fixtures/euroc_mini


def phase_recovery(kernels) -> dict:
    """svo_tpu_torch.eval_recovery at 376x1241, fused, cut to 97 frames:
    corridor-base run healthily to frame 48, 4 degrees and 0.8 m of drift
    injected over frames 27-48 (the poses and the points born there), one
    refine_global sweep, then arm A without a back-end and arm B from the
    swept state with refine_global every 2 chunks, to frame 96. Held: the
    aggressive regime fired and its sweep was accepted, the span's error
    fell, arm B recovered (under half arm A's error), both arms started
    from the same generator state, and lk_level was launched by the launch
    rule over the healthy run and both arms."""
    from svo_tpu_torch import eval_recovery

    _zero(kernels)
    argv = ["--frames", str(RECOVERY_FRAMES), "--inject-at", str(RECOVERY_INJECT_AT),
            "--span", "22", "--lk-engine", "fused", "--device", "cuda"]
    t0 = time.perf_counter()
    r, _ = eval_recovery.recovery(eval_recovery.parse_args(argv))
    wall = time.perf_counter() - t0
    counts = _counts(kernels)
    print(f"recovery: {r['frames']} frames 376x1241 fused, drift at frame {r['inject_at']} over "
          f"{r['span']} frames: newest pose {r['newest_pose_err_m']:.4f} m off | sweep cost "
          f"{r['refine_cost_per_obs_px']:.4f} px/obs, aggressive {r['aggressive_fired']}, accepted "
          f"{r['accepted']}, span error {r['span_abs_err_before_m']:.4f} -> "
          f"{r['span_abs_err_after_m']:.4f} m | after the injection: no back-end "
          f"{r['post_abs_err_no_backend_m']:.4f} m, recovered {r['post_abs_err_recovered_m']:.4f} m, "
          f"recovered {r['recovered']} | generator at each arm {r['arm_generator_states']} | "
          f"{wall:.1f} s | launches {counts}")
    check(r["aggressive_fired"] and r["accepted"],
          f"recovery: aggressive {r['aggressive_fired']}, accepted {r['accepted']}")
    check(r["span_abs_err_after_m"] < r["span_abs_err_before_m"],
          f"recovery: the sweep did not reduce the span's error ({r['span_abs_err_before_m']} -> "
          f"{r['span_abs_err_after_m']} m)")
    check(r["recovered"], f"recovery: arm B {r['post_abs_err_recovered_m']} m is not under half of "
          f"arm A's {r['post_abs_err_no_backend_m']} m")
    gens = r["arm_generator_states"]
    check(len(gens) == 2 and gens[0] == gens[1], f"recovery: the arms' generators differ {gens}")
    _check_launches("recovery", "fused", counts, r["steps"]["keyframes"], r["steps"]["frames"])
    return dict(counts=counts, result=r)


def phase_eval_ba(kernels, frames, seq) -> dict:
    """svo_tpu_torch.eval_ba on the 97 frames rendered above: run_chunked
    (fused), then refine_global swept over the finished trajectory in
    22-frame spans (frames 21, 42, 63, 84 and 96) with eval_ba's sizes.
    Held: every swept pose finite, one sweep per span end, lk_level
    launched by the launch rule; ATE before and after printed."""
    from svo_tpu_torch import eval_ba

    _zero(kernels)
    args = eval_ba.parse_args(["--frames", str(N_FRAMES), "--lk-engine", "fused",
                               "--device", "cuda"])
    t0 = time.perf_counter()
    r, _ = eval_ba.evaluate(args, frames=frames, seq=seq)
    wall = time.perf_counter() - t0
    counts = _counts(kernels)
    his = eval_ba.schedule(N_FRAMES, args.blocks, args.cams_per_block)
    print(f"eval_ba: {eval_ba.summary_line(r)} | spans ending at {r['his']}, accepted "
          f"{r['accepted']}, cost/obs {[round(c, 3) for c in r['cost_per_obs']]} | {wall:.1f} s | "
          f"launches {counts}")
    check(r["finite"], "eval_ba: a swept pose is not finite")
    check(r["sweeps"] == len(his) == 5 and r["his"] == his,
          f"eval_ba: {r['sweeps']} sweeps at {r['his']}, expected {his}")
    _check_launches("eval_ba", "fused", counts, r["steps"]["keyframes"], r["steps"]["frames"])
    return dict(counts=counts, result=r)


def phase_eval_tables(kernels) -> dict:
    """The table harnesses, each in this process: svo_tpu_torch.eval_fleet
    on a KITTI root built from tests/fixtures/kitti_mini (sequences/00,
    poses/00.txt; 96x320, chunk 6 and cadence 6, so 7 frames, patches),
    eval_fleet on 2 synthetic sequences of 25 frames at 376x1241 (fused),
    and svo_tpu_torch.eval_euroc on tests/fixtures/euroc_mini (40 frames,
    192x320, the data-dependent keyframe rule, patches). Held: every ATE
    finite, the EuRoC ATE at most 2 x svo_tpu's 0.0455 m (the PnP noise
    differs and picks a basin at this size; a broken reader gives metres),
    and each run's kernel launched by the launch rule, so both kernels run."""
    import shutil
    import tempfile

    from svo_tpu_torch import eval_euroc, eval_fleet

    fix = os.path.join(REPO, "tests", "fixtures", "kitti_mini")
    per_run, rows = {}, []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        seq_dir = os.path.join(root, "sequences", "00")
        for d in ("image_2", "image_3"):
            shutil.copytree(os.path.join(fix, d), os.path.join(seq_dir, d))
        shutil.copy(os.path.join(fix, "calib.txt"), seq_dir)
        os.makedirs(os.path.join(root, "poses"))
        shutil.copy(os.path.join(fix, "poses.txt"), os.path.join(root, "poses", "00.txt"))
        for tag, engine, argv in (
            ("kitti_mini", "patches", ["--kitti", root, "--seqs", "00", "--chunk", "6",
                                       "--cadence", "6"]),
            ("synthetic", "fused", ["--seqs", "00,01", "--frames", "25"]),
        ):
            _zero(kernels)
            r, _ = eval_fleet.evaluate(eval_fleet.parse_args(
                argv + ["--lk-engine", engine, "--device", "cuda"]))
            per_run[tag] = _counts(kernels)
            check(len(r["rows"]) == (1 if tag == "kitti_mini" else 2), f"fleet {tag}: {r['rows']}")
            for row in r["rows"]:
                rows.append((tag, row))
                check(row["finite"] and np.isfinite(row["ate_m"]),
                      f"fleet {tag} {row['seq']}: ATE {row['ate_m']}")
            _check_launches(f"fleet {tag}", engine, per_run[tag],
                            sum(row["keyframes"] for row in r["rows"]),
                            sum(row["frames"] - 1 for row in r["rows"]))
    _zero(kernels)
    e, _ = eval_euroc.evaluate(eval_euroc.parse_args(["--lk-engine", "patches", "--device", "cuda"]))
    per_run["euroc_mini"] = _counts(kernels)
    wall = time.perf_counter() - t0
    for tag, row in rows:
        print(f"  fleet | {tag:<10} {row['seq']:>8} | {row['frames']} frames | ATE "
              f"{row['ate_m']:.4f} m ({row['ate_pct']:.3f}%) | RPE {row['rpe_t_m']:.4f} m / "
              f"{row['rpe_r_deg']:.4f} deg | {row['fps_incl_compile']:.3f} frames/s")
    bound = 2 * EUROC_MINI_ATE_M
    print(f"eval_euroc: {e['root']} {e['frames']} frames {e['image']}, patches: ATE {e['ate_m']:.4f} m "
          f"= {e['ate_pct_of_traveled']:.3f}% of {e['traveled_m']:.2f} m (bound {bound}; svo_tpu "
          f"{EUROC_MINI_ATE_M}) | RPE {e['rpe_trans_m']:.4f} m / {e['rpe_rot_deg']:.4f} deg | "
          f"inlier ratio {e['mean_inlier_ratio']:.4f}, {e['keyframes']} keyframes | tables "
          f"{wall:.1f} s | launches {per_run}")
    check(e["finite"] and np.isfinite(e["ate_m"]) and e["ate_m"] <= bound,
          f"eval_euroc: ATE {e['ate_m']} m > {bound} m")
    _check_launches("euroc_mini", "patches", per_run["euroc_mini"], e["keyframes"], e["frames"] - 1)
    counts = {k: sum(c[k] for c in per_run.values()) for k in per_run["euroc_mini"]}
    kc = _kernel_counts(counts)
    check(kc["klt_patches"] > 0 and kc["lk_level"] > 0, f"eval tables: launches {kc}")
    return dict(counts=counts, fleet=rows, euroc=e)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_distributed(frames, seq) -> dict:
    """The distributed paths on the card. In a world of one (NCCL, this
    process): solve_ba_distributed with 8 shards against solve_ba on the
    same problem (cameras 5e-4, points 5e-2, cost 1e-3 relative:
    tests/test_dist_ba.py's bounds); refine_global_sharded (4 blocks)
    against refine_global on a drifted span (poses 1e-4, ATE 1e-3:
    tests/test_global_opt.py's bounds); MultiStereoVO against StereoVO with
    the same seed on 13 frames of the sequence, bit-equal. Then two gloo
    ranks, each a process holding 4 of the 8 shards with the solve on the
    card (the gloo exchange passes through host memory on every call,
    parallel/collective.py): both must report their shards bit-equal to the
    one-process 8-shard solve and within the bounds of the single solve,
    and equal this process's NCCL solve bit for bit. LM iterations/s of
    each."""
    import subprocess
    import tempfile

    import torch.distributed as dist

    from svo_tpu_torch.ba import synthetic
    from svo_tpu_torch.ba.solver import BAProblem, solve_ba
    from svo_tpu_torch.eval.trajectory import ate_rmse
    from svo_tpu_torch.parallel import ba as dist_ba
    from svo_tpu_torch.parallel import global_opt, multihost
    from svo_tpu_torch.parallel.multi_seq import MultiStereoVO
    from svo_tpu_torch.pipeline.odometry import StereoVO

    torch.cuda.set_device(0)
    multihost.init(f"localhost:{_free_port()}", 1, 0, backend="nccl", timeout_s=120)
    try:
        it = 12
        problem = synthetic.ba_problem(42, n_cams=6, n_pts=128, noise_px=0.3)
        K = torch.tensor(synthetic.K_MAT, device="cuda")
        bfx = synthetic.FX * synthetic.BASELINE
        single_p = _to(problem, "cuda")
        sharded = _to(dist_ba.shard_problem(problem, DIST_SHARDS), "cuda")
        single = solve_ba(single_p, K, bfx, iterations=it)
        one = dist_ba.solve_ba_distributed(sharded, K, bfx, iterations=it)
        again = dist_ba.solve_ba_distributed(sharded, K, bfx, iterations=it)
        cam_err = _max_abs(one.T_cw, single.T_cw[None])
        pt_err = _max_abs(one.points.reshape(-1, 3), single.points)
        cost_rel = abs(float(one.cost[0]) - float(single.cost)) / float(single.cost)
        rates = {
            "single": per_second(lambda: solve_ba(single_p, K, bfx, iterations=it), it),
            "nccl_world_of_one": per_second(
                lambda: dist_ba.solve_ba_distributed(sharded, K, bfx, iterations=it), it),
        }
        print(f"distributed BA, NCCL world of one, {DIST_SHARDS} shards on the card: cameras "
              f"{cam_err:.2e} (bound 5e-4), points {pt_err:.2e} (5e-2), cost {cost_rel:.2e} "
              f"relative (1e-3) from solve_ba | cost {float(one.cost0[0]):.2f} -> "
              f"{float(one.cost[0]):.2f} | twice bit-identical {_bit_equal(one, again)} | "
              f"LM iterations/s: single {rates['single']:.1f}, sharded {rates['nccl_world_of_one']:.1f}")
        check(cam_err < 5e-4 and pt_err < 5e-2 and cost_rel < 1e-3,
              "distributed BA on the card is outside test_dist_ba.py's bounds")
        check(_bit_equal(one, again), "two distributed solves on the card differ")

        mp, poses, gt = synthetic.drifted_state(3)
        mp, poses = _to(mp, "cuda"), poses.to("cuda")
        hi = torch.tensor(21, dtype=torch.int32, device="cuda")
        kw = dict(n_blocks=4, ba_iterations=8, pg_iterations=8)
        ref = global_opt.refine_global(mp, poses, hi, K, bfx, **kw)
        sh = global_opt.refine_global_sharded(mp, poses, hi, K, bfx, **kw)
        pose_err = _max_abs(sh.poses, ref.poses)
        ate_sh, ate_ref = (float(ate_rmse(x.poses[:22].cpu().numpy(), gt)) for x in (sh, ref))
        print(f"refine_global_sharded, world of one, 4 blocks on the card: poses {pose_err:.2e} "
              f"from refine_global (bound 1e-4), bit-equal {_bit_equal(sh, ref)} | ATE "
              f"{ate_sh:.4f} against {ate_ref:.4f} m | cost per observation "
              f"{float(ref.cost_per_obs):.1f} | accepted {bool(sh.accepted)}")
        check(pose_err < 1e-4 and abs(ate_sh - ate_ref) < 1e-3,
              "refine_global_sharded disagrees with refine_global on the card")

        cfg, cam = _config_and_camera(seq)
        n_ms = 13
        multi = MultiStereoVO(cfg, cam, device="cuda")
        multi.start(frames[0][1][None], frames[0][2][None], seed=5)
        for f in frames[1:n_ms]:
            multi.process(f[1][None], f[2][None])
        lone = StereoVO(cfg, cam, seed=5, device="cuda").run(frames[:n_ms])
        same = np.array_equal(multi.trajectories(n_ms)[0], lone.poses)
        print(f"MultiStereoVO, world of one, {n_ms} frames 376x1241 against StereoVO(seed=5): "
              f"bit-equal {same} | fleet health {multi.fleet_health.tolist()}")
        check(same, "MultiStereoVO's stream differs from StereoVO with the same seed")
        check(np.array_equal(multi.fleet_health, lone.metrics[n_ms - 1]),
              "fleet_health of a world of one is not its stream's metrics row")
        one_T, one_pts = one.T_cw.cpu().numpy(), one.points.cpu().numpy()
    finally:
        dist.destroy_process_group()

    with tempfile.TemporaryDirectory() as tmp:
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "svo_tpu_torch.multihost_ba_worker", "--rank", str(r),
             "--nprocs", "2", "--port", str(port), "--backend", "gloo", "--device", "cuda",
             "--reps", "10", "--timeout", "240",
             "--out", os.path.join(tmp, f"mh_{r}.json"), "--arrays", os.path.join(tmp, f"mh_{r}.npz")],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
        try:
            errs = [p.communicate(timeout=400)[1] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            check(p.returncode == 0, f"gloo rank {r} exited {p.returncode}: {errs[r][-2000:]}")
        reps = [json.load(open(os.path.join(tmp, f"mh_{r}.json"))) for r in range(2)]
        arrays = [np.load(os.path.join(tmp, f"mh_{r}.npz")) for r in range(2)]
        half = DIST_SHARDS // 2
        same_as_nccl = all(
            np.array_equal(a["T_cw"], one_T[r * half:(r + 1) * half])
            and np.array_equal(a["points"], one_pts[r * half:(r + 1) * half])
            for r, a in enumerate(arrays))
    for rep in reps:
        print(f"  gloo rank {rep['rank']} of {rep['world']} on {rep['device']} ({rep['exchange']} "
              f"exchange): {rep['n_local_shards']} shards, bit-equal to one process "
              f"{rep['bit_equal_to_one_process']}, cameras {rep['cam_err_vs_single']:.2e} from the "
              f"single solve | LM iterations/s {rep['lm_iterations_per_s']}")
    rates["gloo_two_ranks"] = min(rep["lm_iterations_per_s"]["all_processes"] for rep in reps)
    print(f"distributed BA, 2 gloo ranks sharing the card: ok {[rep['ok'] for rep in reps]} | "
          f"bit-equal to this process's NCCL 8-shard solve {same_as_nccl} | "
          f"{rates['gloo_two_ranks']:.1f} LM iterations/s")
    check(all(rep["ok"] and rep["exchange"] == "host" for rep in reps),
          f"a gloo rank on the card failed its checks: {reps}")
    check(same_as_nccl, "2 gloo ranks on the card differ from the NCCL world of one")
    return dict(lm_iterations_per_s=rates)


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
    phase_orb_agreement(frames)
    done("ORB detector, card against CPU")
    phase_backend_agreement()
    done("back-end agreement")
    kernels = [extract_klt_patches, lk_track_level, lk_track_pyramid]
    single, single_ates = phase_main_path(kernels, frames, seq)
    done("single-stream main path")
    phase_ba_main_path(frames, seq, single_ates["fused"])
    done("single-stream main path with the window BA")
    shipping = phase_shipping_main_path(kernels, frames, seq)
    done("shipping configuration (ORB) through run_synthetic")
    staged = _stage_batched(frames, seq)
    multi = phase_batched_main_path(kernels, seq, staged)
    done("batched main path")
    shipping_batched = phase_shipping_batched(kernels, staged)
    done("batched shipping configuration (ORB)")
    refined_bvo = phase_refined_main_path(kernels, staged)
    phase_ba_throughput(refined_bvo)
    done("refined batched main path and BA throughput")
    del refined_bvo
    phase_checkpoint(staged)
    done("checkpoint and resume")
    del staged
    phase_cli_fixture()
    done("run_kitti on the KITTI fixture")
    soak = phase_soak(kernels)
    done("soak")
    worlds = phase_worlds(kernels)
    done("worlds suite")
    recovery = phase_recovery(kernels)
    done("aggressive recovery on live state")
    eval_ba_run = phase_eval_ba(kernels, frames, seq)
    done("refinement sweep over the finished trajectory")
    tables = phase_eval_tables(kernels)
    done("fleet table and EuRoC artifact")
    phase_distributed(frames, seq)
    done("distributed paths")

    def row(name, source, replaces, rows, engine, key):
        """One kernel's line: its numbers at the temporal level-0 shape of
        one stream, and of the 8-stream launch beside them."""
        r0 = next(r for r in rows["rows"] if r["kind"] == "temporal" and r["level"] == 0)
        b = batched[key]
        n_single = _kernel_counts(single[engine])[name]
        n_batched = _kernel_counts(multi[engine])[name]
        n_ship = sum(_kernel_counts(shipping[t]["counts"])[name] for t in ("a", "b"))
        n_ship += _kernel_counts(shipping_batched["counts"])[name]
        n_soak = _kernel_counts(soak["counts"])[name]
        n_worlds = _kernel_counts(worlds["counts"])[name]
        n_recovery = _kernel_counts(recovery["counts"])[name]
        n_eval_ba = _kernel_counts(eval_ba_run["counts"])[name]
        n_tables = _kernel_counts(tables["counts"])[name]
        check(n_single > 0 and n_batched > 0 and n_ship > 0,
              f"{name} was not launched on a main path")
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_single + n_batched + n_ship + n_soak + n_worlds + n_recovery
            + n_eval_ba + n_tables,
            "launches_single_stream": n_single, "launches_batched": n_batched,
            "launches_shipping_orb": n_ship, "launches_soak": n_soak,
            "launches_worlds": n_worlds, "launches_recovery": n_recovery,
            "launches_eval_ba": n_eval_ba, "launches_eval_tables": n_tables,
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
    for suffix, t in (("", track["temporal_1"]), ("_batched", track[f"temporal_{STREAMS}"]),
                      ("_worlds", track[f"temporal_{WORLD_STREAMS}"])):
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
