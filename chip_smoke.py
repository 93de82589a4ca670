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
bit for bit and be the faster of the two; the capability probes
(svo_tpu_torch/probe.py); the threefry PnP noise; and RANSAC-PnP
(ransac_pnp, two launches a call, bit-equal to its plain version at 1, 8
and 16 streams); and FAST with its 3x3 NMS and suppression mask (fast_nms,
one launch a call, bit-equal to its plain version at 1, 8 and 64 streams
of 376x1241 and at every level of ORB's 8-level pyramid); and the patches
engine's tracker call (klt_track, every level in one launch, bit-equal to
the chain of per-level tensor ops at the temporal, stereo and
forward-backward shapes, 1 and 8 streams). It runs small
card-vs-CPU agreement checks with both KLT engines, single-stream and
batched. Then the two main paths on bench.py's 97-frame 376x1241 synthetic
sequence, chunk 12 and keyframe cadence 6, each once per engine
(lk_engine="patches", svo_tpu's default, through klt_track; "fused",
through lk_level; either one launch per tracker call) with
accuracy and launch-count checks:
StereoVO.run_chunked (one stream), and BatchedStereoVO.process_chunk with 8
streams in lockstep, even streams forward and odd streams reversed, where a
kernel must be launched exactly as often as for one stream. The same
runs, warm by then, give frames/s; a profiled chunk of each gives device
launches and device time per frame. Then the back-end: solve_ba,
refine_alternate, optimize_pose_graph and refine_global on seeded fixtures
on the card against the CPU path and twice on the card (bit-identical);
bench.py's refined arm (8 streams, refine() every 2 chunks and at the last
chunk, the refiner captured) beside the same run without it; the BA
throughput stage of bench.py, eager and replayed; the captured refiner
against refine_global (graph=False) in both regimes, 8 streams and one;
one stream with the in-pipeline window BA (ba.enabled); and a
checkpoint taken on the card after chunk 4 and resumed in a fresh engine,
which must reproduce chunks 5-8 bit for bit. The shipping configuration
(Config(): the ORB detector, plain PyTorch but for the fast_nms kernel): the
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
against StereoVO and against its own eager steps (graph=False), then two
gloo processes sharing the card, bit-equal to
the world of one. Then the evaluation harnesses, each in this process:
svo_tpu_torch.eval_recovery (drift injected into a live 97-frame run; the
back-end's aggressive regime must fire, be accepted and recover it),
svo_tpu_torch.eval_ba (refine_global swept over the 97 frames above),
svo_tpu_torch.eval_fleet (a KITTI root built from kitti_mini, and 2
synthetic sequences) and svo_tpu_torch.eval_euroc (euroc_mini, held to
2 x svo_tpu's ATE), each counted against the launch rule. Then the
developer tools on the frames already rendered (8 streams, the first 49
frames): the patch self-test on a real frame (0.0), bench_batched and
time_chunk with each engine (ATE, reps bit-equal, the launch rule),
profile_chunk (lk_level 26 times in a traced 12-frame chunk), klt_bench
against the CPU path, microbench and soak_ref. Last the scaling harness,
svo_tpu_torch.scaling_eff, each arm in fresh processes on the card (one
card a rank where there are two, else both ranks sharing cuda:0): the
2-stream frontend fleet in one process against one a process
(trajectories bit-equal, each stream StereoVO(seed=s), klt_track by the
launch rule), and with two cards the distributed BA at its sweep's first
point, 1 process against 2 (ranks bit-equal, arms within 1e-3).

svo_tpu jits its frame loop and its back-end with the state donated, its
data-dependent branches (the dynamic keyframe rule, the window BA, the
refiner's regime) inside as lax.cond; the port captures each step as CUDA
graphs, one per branch key read once a call, and replays them
(pipeline/graph.py), the default on the card, so every engine above runs
captured: the cadenced chunks, the frame steps of the dynamic rule, the
window BA, the refine sweeps (their times are the benchmark's, vobench/).
phase_graph holds the captured cadenced runs against the eager loop
(graph=False) at bench.py's configuration, one stream and 8 with each
engine and Config() (ORB) for one stream, and phase_frame_graph the
captured frame steps (one stream frame by frame with each engine, the
dynamic rule in ORB chunks, 8 streams frame by frame, the window BA in
chunks and frame by frame): every leaf of the final state bit-equal, the
same launches, by the launch rule, one key read a frame step, the BA's
solves where its rule says.

The kernel checks and times and the batched-against-single check run
first, alone on the card. The phases after them run in
six worker processes of this script (`--worker <group>`,
WORKER_GROUPS), started together on the one card and each running its
phases in order; a
worker's output is printed when it ends, and a failed worker stops the
others. Every phase prints its lines and its wall; any failed check
raises and the script exits non-zero. Without a CUDA device it exits
non-zero before printing a result. The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

from svo_tpu_torch import _build
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
# the TPU's readings of bench.py's runs with svo_tpu's PnP noise, which the
# port now draws: BENCH_r05.json's ate_m (one stream) and ate_per_stream_m
# (8 streams, even forward, odd reversed); printed beside the port's, a
# reading, not a gate
TPU_ATE_M = 0.0441
TPU_ATE_PER_STREAM_M = (0.0444, 0.091, 0.0467, 0.0938, 0.0461, 0.0882, 0.0517, 0.0949)
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
            before = _build.launches()["klt_patches"]
            got = extract_klt_patches(*args)
            check(_build.launches()["klt_patches"] == before + 1,
                  "a batched extraction is one launch")
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
        before = _build.launches()["lk_level"]
        got = lk_track_level(*largs, **kw)
        check(_build.launches()["lk_level"] == before + 1, "a batched level is one launch")
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

            before = _build.launches()["lk_level"]
            got = whole()
            check(_build.launches()["lk_level"] == before + 1,
                  f"a whole tracker call of {n_levels} levels is one launch")
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

    _build.set_counters({"probe.launches": 0})
    rows = probe.run_all("cuda")
    launches = _build.launches()["probe"]
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


# svo_tpu's PnP noise, computed on the CPU with jax 0.9.0 (x32,
# jax_threefry_partitionable): for PRNGKey(seed), `rng, sub =
# jax.random.split(key)` and jax.random.bits / jax.random.gumbel(sub,
# (128, 128)) at flat indices RNG_INDICES.
RNG_INDICES = (0, 1, 128, 16383)
RNG_REFERENCE = {
    0: dict(rng=(0x6B200159, 0x99BA4EFE), sub=(0x375F238F, 0xCDDB151D),
            bits=(0x01DE0365, 0x05592150, 0x724E3F62, 0x3864C9C3),
            gumbel=(-1.5934563875198364, -1.3528481721878052, 0.2152974158525467,
                    -0.41397568583488464)),
    5: dict(rng=(0xA264258C, 0xD500890A), sub=(0x0C12EEC8, 0xE7AC32AC),
            bits=(0x1574CB01, 0x3AADB840, 0xE029E5D2, 0x252FE78C),
            gumbel=(-0.9079211950302124, -0.3873707950115204, 2.01890230178833,
                    -0.6571134328842163)),
    2**32 - 1: dict(rng=(0xB139A81A, 0x35816875), sub=(0xCE53F10B, 0x4253B296),
                    bits=(0x38445CE0, 0x5D4D3F47, 0x900486C1, 0x469D06EE),
                    gumbel=(-0.41546085476875305, -0.009295517578721046, 0.5529654026031494,
                            -0.25305795669555664)),
}
# Random123's known answers for threefry2x32_20 (kat_vectors): (counter,
# key) -> output
THREEFRY_KAT = (
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x243F6A88, 0x85A308D3), (0x13198A2E, 0x03707344), (0xC4923A9C, 0x483DF7A0)),
)
RNG_SHAPE = (128, 128)  # (hypotheses, max_features) of Config()
# operations of one value of the threefry kernel: a hash (20 rounds of add,
# rotate, xor; 17 adds of key injection) and xor, shift, or, sub, add, max,
# two logs, two negations; and per stream the split's two hashes
THREEFRY_OPS_PER_VALUE = 20 * 3 + 17 + 10
THREEFRY_OPS_PER_STREAM = 2 * (20 * 3 + 17)


def bound_threefry(S: int, n: int) -> tuple[float, str]:
    """Least ms for one split_gumbel launch: S keys read and written, S * n
    floats written; its integer and float operations at the card's 32-bit
    rate outside the tensor cores (the only such rate the published table
    gives)."""
    nbytes = S * (8 + 8) + S * n * 4
    ops = S * (n * THREEFRY_OPS_PER_VALUE + THREEFRY_OPS_PER_STREAM)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_rng() -> dict:
    """The threefry kernel (csrc/threefry.cu, ops/random.split_gumbel): no
    JAX on the card, so first known answers: Random123's threefry-2x32-20
    vectors through the plain hash on the card (and the first through the
    kernel: the new key of key (0, 0) is hash((0, 0), (0, 0))), and
    svo_tpu's keys, words and Gumbel values for three seeds (RNG_REFERENCE,
    words bit-equal, Gumbel within 1e-6). Then the kernel against its
    plain version on the card at S = 1, 8 and 16 streams of (128, 128):
    keys and words bit-equal, Gumbel within 1e-6 abs, and stream s of the
    S = 8 launch bit-equal to a single launch from PRNGKey(seed + s); the
    device us per launch (profiler), wall ms per call, bound and launches."""
    from svo_tpu_torch.ops.random import (prng_key, split_gumbel, split_gumbel_ref,
                                          threefry2x32_ref)

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    for ctr, key, want in THREEFRY_KAT:
        k0, k1, x0, x1 = (torch.tensor(v, dtype=torch.int64, device=dev) for v in (*key, *ctr))
        got = tuple(int(v) for v in threefry2x32_ref(k0, k1, x0, x1))
        check(got == want, f"threefry known answer {ctr} {key}: {got} != {want}")
    zero_key = torch.zeros(2, dtype=torch.int32, device=dev)
    new0, _ = split_gumbel(zero_key, RNG_SHAPE)
    got0 = tuple(int(v) for v in new0.cpu().numpy().view(np.uint32))
    check(got0 == THREEFRY_KAT[0][2], f"threefry kernel on key (0, 0): {got0}")
    idx = torch.tensor(RNG_INDICES, device=dev)
    ref_err = 0.0
    for seed, ref in RNG_REFERENCE.items():
        key = prng_key(seed, dev)
        new, noise, bits = split_gumbel(key, RNG_SHAPE, with_bits=True)
        check(tuple(int(v) for v in new.cpu().numpy().view(np.uint32)) == ref["rng"],
              f"seed {seed}: the kernel's new key is not svo_tpu's")
        check(tuple(int(v) for v in bits.reshape(-1)[idx].tolist()) == ref["bits"],
              f"seed {seed}: the kernel's words are not svo_tpu's")
        err = float(np.abs(noise.reshape(-1)[idx].cpu().numpy() - np.array(ref["gumbel"])).max())
        check(err <= 1e-6, f"seed {seed}: Gumbel {err} from svo_tpu's")
        ref_err = max(ref_err, err)
    print(f"rng: Random123 threefry2x32_20 known answers exact (plain on the card; the kernel's "
          f"split of key (0, 0)) | svo_tpu's keys and words for seeds "
          f"{list(RNG_REFERENCE)} bit-equal, Gumbel within {ref_err:.3g}")

    _build.set_counters({"threefry.launches": 0})
    rows = {}
    for S in (1, 8, 16):
        keys = prng_key(np.arange(S) + 5, dev)
        new, noise, bits = split_gumbel(keys, RNG_SHAPE, with_bits=True)
        new_p, noise_p, bits_p = split_gumbel_ref(keys, RNG_SHAPE, with_bits=True)
        torch.cuda.synchronize()
        check(torch.equal(new, new_p), f"threefry S={S}: keys differ from the plain version")
        check(torch.equal(bits, bits_p), f"threefry S={S}: words differ from the plain version")
        err = float((noise - noise_p).abs().max())
        check(bool(torch.isfinite(noise).all()) and err <= 1e-6,
              f"threefry S={S}: Gumbel {err} from the plain version")
        if S == 8:
            for s in range(S):
                one_new, one_noise = split_gumbel(prng_key(5 + s, dev), RNG_SHAPE)
                check(torch.equal(one_new, new[s]) and torch.equal(one_noise, noise[s]),
                      f"threefry: stream {s} of the S=8 launch differs from its single launch")
        ms = median_ms(lambda: split_gumbel(keys, RNG_SHAPE))
        plain_ms = median_ms(lambda: split_gumbel_ref(keys, RNG_SHAPE), reps=10, inner=3)
        n_before = _build.launches()["threefry"]
        evs = [e for e in device_events(lambda: [split_gumbel(keys, RNG_SHAPE) for _ in range(20)])
               if "threefry" in e.key]
        n_dev = sum(e.count for e in evs)
        device_us = sum(e.self_device_time_total for e in evs) / max(n_dev, 1)
        # the profiler drops records (ROADMAP C): the wrapper counts the
        # launches, the device time is averaged over what was recorded
        n_launched = _build.launches()["threefry"] - n_before
        check(n_launched == 20 and n_dev > 0,
              f"threefry S={S}: {n_launched} launches, {n_dev} traced")
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        for _ in range(100):
            split_gumbel(keys, RNG_SHAPE)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w0) * 10  # ms per call: 100 calls
        bound, by = bound_threefry(S, RNG_SHAPE[0] * RNG_SHAPE[1])
        rows[S] = dict(ms=ms, plain_ms=plain_ms, device_us=device_us, wall_ms=wall_ms,
                       bound_ms=bound, bound_by=by, max_abs_err=err)
        print(f"rng threefry S={S} x {RNG_SHAPE[0]}x{RNG_SHAPE[1]}: keys and words bit-equal to "
              f"plain, Gumbel max |diff| {err:.3g}{' | S=8 streams equal single launches' if S == 8 else ''} "
              f"| kernel {ms:.4f} ms (events) | device {device_us:.2f} us per launch | wall "
              f"{wall_ms:.4f} ms per call | plain {plain_ms:.4f} ms | bound {bound:.6f} ms ({by})")
    launches = _build.launches()["threefry"]
    print(f"rng: {time.perf_counter() - t0:.1f} s | launches {launches}")
    return dict(rows=rows, launches=launches,
                max_abs_err=max(ref_err, max(r["max_abs_err"] for r in rows.values())))


# the PnP kernel's shapes: the fleet's 8 streams, the live frame's one
# stream without a stream axis, and 16 (the worlds suite); max_features slots,
# num_hypotheses hypotheses and the previous pose as the one prior, as the
# frame step calls it
PNP_STREAMS = (1, STREAMS, WORLD_STREAMS)
# the dense configuration's call (vobench/configs/kitti00-orb2k.json): 8
# streams of 2,048 slots, the kernel's wide path
PNP_DENSE = (STREAMS, 2048)


def _pnp_problem(S: int, seed: int, inlier_share: float, N: int = 128):
    """S streams of N correspondences on the card: points 4-60 m ahead,
    0.5 px noise, a share moved 20-80 px off, 110 of 128 slots live, the
    previous pose 2 cm / 0.02 rad from the truth, Gumbel noise (as the frame
    step draws it); S = 1 without the stream axis."""
    from svo_tpu_torch.config import RansacParams
    from svo_tpu_torch.geometry import se3

    rng = np.random.default_rng(seed)
    H = RansacParams().num_hypotheses
    K = np.array([[718.856, 0, 607.1928], [0, 718.856, 185.2157], [0, 0, 1]])

    def pose(sigma):
        xi = torch.from_numpy(np.r_[rng.normal(0, sigma, 3), rng.normal(0, sigma, 3)])
        return se3.exp(xi).numpy()

    Xw, uv, valid, noise, T_init = [], [], [], [], []
    for _ in range(S):
        T_cw = pose(0.05)
        Xc = np.stack([rng.uniform(-15, 15, N), rng.uniform(-2, 2, N), rng.uniform(4, 60, N)], -1)
        Xw.append((np.linalg.inv(T_cw) @ np.c_[Xc, np.ones(N)].T).T[:, :3])
        px = (K @ Xc.T).T
        px = px[:, :2] / px[:, 2:] + rng.normal(0, 0.5, (N, 2))
        out = rng.random(N) >= inlier_share
        px[out] += rng.uniform(20, 80, (out.sum(), 2)) * rng.choice([-1, 1], (out.sum(), 2))
        uv.append(px)
        v = np.zeros(N, bool)
        v[rng.choice(N, 110 * N // 128, replace=False)] = True
        valid.append(v)
        noise.append(-np.log(-np.log(rng.uniform(np.finfo(np.float32).tiny, 1, (H, N)))))
        T_init.append(pose(0.02) @ T_cw)
    dev = torch.device("cuda")
    out = [torch.from_numpy(np.asarray(K, np.float32)).to(dev)]
    for a, dtype in ((Xw, np.float32), (uv, np.float32), (valid, bool), (noise, np.float32),
                     (T_init, np.float32)):
        t = torch.from_numpy(np.ascontiguousarray(np.stack(a), dtype)).to(dev)
        out.append(t[0] if S == 1 else t)
    return out


def bound_pnp(S: int, N: int = 128, H: int = 128, P: int = 1) -> tuple[float, str]:
    """Least ms for one ransac_pnp call: its inputs read and outputs written
    once; its float operations at the 32-bit rate outside the tensor cores.
    A hypothesis: A^T A's 78 entries of 12 products (1,872), the 12x12
    Cholesky (~650), 8 inverse iterations of two triangular solves and a
    norm (8 x 312), polar (8 x ~120) and 25 a residual over N slots; an LO
    chain (3 a stream): 2 rounds of a gate (25 N) and 4 Gauss-Newton steps
    (~150 N for the terms and their sums, ~600 for the 6x6 solve and the
    update), and its strict consensus (25 N)."""
    nbytes = 36 + S * (N * (12 + 8 + 1) + H * N * 4 + P * 64) + S * (64 + N + 4 + 1)
    hyp = 1872 + 650 + 8 * 312 + 8 * 120 + 25 * N
    chain = 2 * (25 * N + 4 * (150 * N + 600)) + 25 * N
    ops = S * ((H + P) * hyp + (2 * P + 1) * chain)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_pnp(frames, seq) -> dict:
    """The RANSAC-PnP kernel (csrc/ransac_pnp.cu, geometry/pnp.py) against
    its plain version on the card at S = 1 (no stream axis: StereoVO's
    frame step), 8 (the fleet's) and 16 at 128 slots, and 8 at 2,048 (the
    dense configuration's, the wide path), at 100/70/30% inliers: the
    result (T_wc, inliers, inlier_ratio, ok) bit-equal; stream s of the S =
    8 call at 128 has the index sets, DLT poses, MSAC scores and winner of
    its single-stream call bit for bit; then the wall ms per call (events),
    the device us of its two launches (profiler), the plain version's ms,
    the bound and the share of it; then the dense chunk path
    (phase_dense_chunk)."""
    from svo_tpu_torch.config import RansacParams
    from svo_tpu_torch.geometry.pnp import ransac_pnp, ransac_pnp_kernel, ransac_pnp_ref

    t0 = time.perf_counter()
    params = RansacParams()
    _build.set_counters({"ransac_pnp.launches": 0})
    rows, err = {}, 0.0
    for S, N in [(S, 128) for S in PNP_STREAMS] + [PNP_DENSE]:
        for share in (1.0, 0.7, 0.3):
            args = _pnp_problem(S, 19 * S + int(10 * share) + N, share, N)
            got = ransac_pnp(*args[:5], params, T_init=args[5])
            want = ransac_pnp_ref(*args[:5], params, T_init=args[5])
            torch.cuda.synchronize()
            for name, g, w in zip(got._fields, got, want):
                gap = _max_abs_err(g, w)
                err = max(err, gap)
                check(gap == 0.0 and torch.equal(g, w),
                      f"ransac_pnp S={S} {share:.0%} inliers: {name} differs from the plain "
                      f"version by {gap}")
        if S == STREAMS and N == 128:
            _, st8 = ransac_pnp_kernel(*args[:5], params, args[5], stages=True)
            for s in range(S):
                one = [a[s] for a in args[1:]]
                _, st1 = ransac_pnp_kernel(args[0], *one[:4], params, one[4], stages=True)
                for name in ("idx", "T_h", "msac", "best"):
                    check(torch.equal(getattr(st8, name)[s], getattr(st1, name)),
                          f"ransac_pnp: stream {s} of S=8 differs from its single call in {name}")
        fn = lambda: ransac_pnp(*args[:5], params, T_init=args[5])  # noqa: E731
        ms = median_ms(fn)
        plain_ms = median_ms(lambda: ransac_pnp_ref(*args[:5], params, T_init=args[5]),
                             reps=5, inner=1)
        n_before = _build.launches()["ransac_pnp"]
        evs = [e for e in device_events(lambda: [fn() for _ in range(20)]) if "pnp_" in e.key]
        n_dev = sum(e.count for e in evs)
        device_us = sum(e.self_device_time_total for e in evs) / max(n_dev, 1) * 2
        n_launched = _build.launches()["ransac_pnp"] - n_before
        check(n_launched == 40 and n_dev > 0,
              f"ransac_pnp S={S}: {n_launched} launches, {n_dev} traced")
        bound, by = bound_pnp(S, N)
        share = 100.0 * bound / (device_us / 1e3)
        rows[S if N == 128 else (S, N)] = dict(ms=ms, plain_ms=plain_ms, device_us=device_us,
                                               bound_ms=bound, bound_by=by, roofline_pct=share)
        same = " | S=8 streams equal single calls up to the LO sums" if S == STREAMS and N == 128 \
            else ""
        print(f"pnp S={S} x {N} slots x 128 hypotheses + 1 prior: bit-equal to plain at "
              f"100/70/30% inliers{same} | kernel {ms:.4f} ms a call (events) | device "
              f"{device_us:.2f} us a call (2 launches) | plain {plain_ms:.2f} ms | bound "
              f"{bound:.6f} ms ({by}), {share:.3f}% of it")
    launches = _build.launches()["ransac_pnp"]
    dense = phase_dense_chunk(frames, seq)
    print(f"pnp: {time.perf_counter() - t0:.1f} s | launches {launches} (+{dense['launches']} on "
          f"the dense chunk path) | max abs err against plain {err}")
    return dict(rows=rows, launches=launches, max_abs_err=err, dense=dense)


def phase_dense_chunk(frames, seq) -> dict:
    """The dense configuration's frame step (vobench/configs/kitti00-orb2k.json:
    ORB with 2,000 features, 2,048 slots and detections, the map sized for
    sequence 00, the fused engine) for 8 streams in captured cadenced chunks
    of 12 at full width: two chunks, each frame step two ransac_pnp
    launches of 8 x 2,048 slots (ransac_pnp.slots) and one threefry launch,
    each keyframe step one fast_nms launch an ORB level, every pose finite;
    the second chunk's replay timed."""
    import dataclasses

    from svo_tpu_torch.config import Capacity, OrbParams
    from svo_tpu_torch.parallel.batched import BatchedStereoVO

    staged = _stage_batched(frames, seq, "dense chunk path")
    cfg = dataclasses.replace(
        _config_and_camera(seq, use_orb=True)[0],
        orb_params=OrbParams(nfeatures=2000, scale_factor=1.2, pyr_levels=8, patch_size=31,
                             fast_treshold=20),
        capacity=Capacity(max_features=2048, max_detections=2048, max_points=1 << 20))
    cfg = dataclasses.replace(cfg, tracking=dataclasses.replace(cfg.tracking,
                                                                features_to_track=1120))
    bvo = BatchedStereoVO(cfg, staged.cam, STREAMS, chunk=CHUNK, kf_cadence=CADENCE,
                          lk_engine="fused")
    bvo.start(staged.l0, staged.r0)
    _build.reset_counters()
    bvo.process_chunk(*staged.chunks[0])
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    bvo.process_chunk(*staged.chunks[1])
    b.record()
    torch.cuda.synchronize()
    steps = 2 * CHUNK
    c = _build.counters()
    got = (c["ransac_pnp.launches"], c["ransac_pnp.slots"], c["threefry.launches"],
           c["fast_nms.launches"])
    want = (2 * steps, steps * STREAMS * 2048, steps, 8 * (steps // CADENCE))
    check(got == want, f"dense chunk path: ransac_pnp launches, slots, threefry launches and "
                       f"fast_nms launches (one an ORB level a keyframe step) {got}, "
                       f"expected {want}")
    poses = bvo.trajectories(steps + 1)
    check(bool(np.isfinite(poses).all()), "dense chunk path: a non-finite pose")
    n_feat = int(bvo.state.features.valid.sum())
    chunk_ms = a.elapsed_time(b)
    print(f"dense chunk path: {STREAMS} streams x 2048 slots, ORB 2000, fused; {steps} steps, "
          f"ransac_pnp {got[0]} launches ({got[1]} slots), threefry {got[2]}, fast_nms "
          f"{got[3]}; a replayed chunk "
          f"of {CHUNK} {chunk_ms:.2f} ms; {n_feat} live features at the end")
    return dict(launches=got[0], slots=got[1], fast_nms_launches=got[3], chunk_ms=chunk_ms,
                live_features=n_feat)


# the FAST kernel's main-path calls: a keyframe step's left images, 1, 8
# (the fleet's) and 64 streams (fleet64's), and ORB's 8-level 1.2 pyramid
FAST_STREAMS = (1, STREAMS, 64)


def bound_fast_nms(S: int, H: int, W: int, masked: bool) -> tuple[float, str]:
    """Least ms for one fast_nms launch: the image read once (and the mask,
    one byte a pixel), the score written once, at 3.35 TB/s."""
    return S * H * W * (4 + masked + 4) / HBM_BYTES_PER_S * 1e3, "bytes"


def phase_fast_nms(frames) -> dict:
    """The FAST + NMS kernel (csrc/fast_nms.cu, ops/fast.py::fast_nms)
    against the plain composition on the card, bit for bit (int32 views):
    376x1241 uint8-valued frames at S = 1, 8 and 64 with the suppression
    mask FAST's keyframe step builds, and every level of ORB's 8-level 1.2
    pyramid of 8 streams without one, thresholds 7 and 20 (min_threshold
    and FAST's); then per shape the device us a launch (profiler), the
    wall ms per call (events), the plain composition's ms and the bound."""
    from svo_tpu_torch.ops import nms
    from svo_tpu_torch.ops.fast import fast_nms, fast_nms_ref
    from svo_tpu_torch.ops.pyramid import scale_pyramid

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    _build.set_counters({"fast_nms.launches": 0, "fast_nms.pixels": 0})
    lefts = np.stack([_u8(frames[i % len(frames)][1]) for i in range(max(FAST_STREAMS))])
    rng = np.random.default_rng(23)
    cases = []
    for S in FAST_STREAMS:
        img = torch.from_numpy(lefts[:S].astype(np.float32)).to(dev)
        pos = torch.from_numpy(np.stack([rng.uniform(0, SHAPE[1], (S, 128)),
                                         rng.uniform(0, SHAPE[0], (S, 128))], -1)
                               .astype(np.float32)).to(dev)
        mask = nms.suppression_mask(SHAPE, pos, torch.ones(S, 128, dtype=torch.bool,
                                                           device=dev), 10)
        cases.append((f"S={S} {SHAPE[0]}x{SHAPE[1]} masked", img, mask))
    levels = scale_pyramid(torch.from_numpy(lefts[:STREAMS].astype(np.float32)).to(dev), 8, 1.2)
    cases += [(f"ORB level {lv} S={STREAMS} {x.shape[-2]}x{x.shape[-1]}", x, None)
              for lv, x in enumerate(levels)]
    rows = {}
    for tag, img, mask in cases:
        for thr in (7.0, 20.0):
            got, want = fast_nms(img, thr, mask), fast_nms_ref(img, thr, mask)
            torch.cuda.synchronize()
            n_diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            check(n_diff == 0, f"fast_nms {tag} thr {thr}: {n_diff} pixels differ from plain")
        fn = lambda: fast_nms(img, 20.0, mask)  # noqa: E731
        ms = median_ms(fn)
        plain_ms = median_ms(lambda: fast_nms_ref(img, 20.0, mask), reps=5, inner=2)
        n_before = _build.launches()["fast_nms"]
        evs = [e for e in device_events(lambda: [fn() for _ in range(20)]) if "fast_nms" in e.key]
        n_dev = sum(e.count for e in evs)
        device_us = sum(e.self_device_time_total for e in evs) / max(n_dev, 1)
        n_launched = _build.launches()["fast_nms"] - n_before
        check(n_launched == 20 and n_dev > 0,
              f"fast_nms {tag}: {n_launched} launches, {n_dev} traced")
        S, H, W = img.shape
        bound, by = bound_fast_nms(S, H, W, mask is not None)
        share = 100.0 * bound / (device_us / 1e3)
        rows[tag] = dict(ms=ms, plain_ms=plain_ms, device_us=device_us, bound_ms=bound,
                         bound_by=by, roofline_pct=share, pixels=S * H * W)
        print(f"fast_nms {tag}: bit-equal to plain at thresholds 7 and 20 | kernel {ms:.4f} ms "
              f"(events) | device {device_us:.2f} us a launch | plain {plain_ms:.3f} ms | bound "
              f"{bound:.6f} ms ({by}), {share:.2f}% of it")
    orb = [r for t, r in rows.items() if t.startswith("ORB")]
    launches = _build.launches()["fast_nms"]
    print(f"fast_nms: {time.perf_counter() - t0:.1f} s | launches {launches} | an ORB "
          f"keyframe's 8 levels: device {sum(r['device_us'] for r in orb):.2f} us, plain "
          f"{sum(r['plain_ms'] for r in orb):.3f} ms")
    return dict(rows=rows, launches=launches, max_abs_err=0.0)


def bound_klt_track(live, window: int, px: int, pys) -> tuple[float, str]:
    """Least ms for one klt_track launch: per level, every slot live
    entering it reads its three (w+1)^2 template windows and its py x px
    patch once (a dead slot's windows are zeros and read nothing); every
    slot reads pos, guess and valid and writes 4 floats. Its operations
    (~11 a template pixel, ~14 a pixel an iteration) take a third of the
    bytes' time or less at these shapes."""
    n = live[0].numel()
    nbytes = sum(int(v.sum()) * (3 * (window + 1) ** 2 + py * px) * 4
                 for v, py in zip(live, [p for p in pys[::-1] if p]))
    nbytes += n * (8 + 8 + 1 + 16)
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def phase_klt_track(frames) -> dict:
    """The patches engine's tracker call in one launch (csrc/klt_track.cu,
    ops/klt_track.py::klt_track) at the main path's shapes: temporal
    (window 21, 4 levels, N=128), stereo (window 11, margin_x 16, 4 levels,
    N=192) and the forward-backward call (1 level), for one stream and for
    8 in one launch, on _track_inputs (the detector's corners, four slots
    pinned at and past the borders, ~25% dead slots, a random incoming
    flow) with slot 4 at NaN. Held BIT-EQUAL (int32 views of d, min_eig,
    and status) to klt_track_ref, the chain of _patch_level calls the
    tracker ran before, on this card; one launch a call. Then the wall of
    one call (CUDA events, median of 25), the plain chain's wall, the
    device us a launch (profiler, 20 launches) and the bytes bound with
    the slots live entering each level in this run."""
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.ops import klt, klt_track

    cfg = Config(use_orb=False, image_height=SHAPE[0], image_width=SHAPE[1])
    pairs = [f[1:] for f in frames[: STREAMS + 1]]
    out = {"max_abs_err": 0.0, "rows": {}}
    t0 = time.perf_counter()
    for S in (1, STREAMS):
        for seed, kind in enumerate(("temporal", "stereo", "fb")):
            args, fkw = _track_inputs(pairs, S, kind, cfg, 20 * S + seed)
            levels, grads, currs, pos, guess0, valid = args
            pos = pos.clone()
            pos[..., 4, :] = float("nan")
            kw = {k: fkw[k] for k in ("window", "pys", "iters", "eps", "min_eig_threshold",
                                      "margin_x", "pad_x", "pad_y")}
            kw["px"] = klt._patch_cols(kw["window"], kw["margin_x"])
            call = (levels, grads, currs, pos, guess0, valid)
            before = _build.counters()
            got = klt_track.klt_track(*call, **kw)
            after = _build.counters()
            check(after["klt_track.launches"] == before["klt_track.launches"] + 1
                  and after["klt_track.slots"] == before["klt_track.slots"] + valid.numel(),
                  f"klt_track {kind} S={S}: not one launch of {valid.numel()} slots")
            live = []  # slots live entering each level, coarse to fine

            def level(*a, **k):
                live.append(a[7])
                return klt._patch_level(*a, **k)

            want = klt_track.klt_track_ref(*call, **kw)
            klt_track.klt_track_chain(level, *call, **kw)
            torch.cuda.synchronize()
            n_diff = sum(int((g.contiguous().view(torch.int32) != w.contiguous().view(torch.int32))
                             .sum()) if g.dtype == torch.float32 else int((g != w).sum())
                         for g, w in zip(got, want))
            tag = (f"kernel klt_track S={S} {kind:8s} {len(kw['pys'])} levels "
                   f"N={valid.shape[-1]} w={kw['window']} px={kw['px']}")
            check(n_diff == 0, f"{tag}: {n_diff} values differ from the plain chain")
            fn = lambda: klt_track.klt_track(*call, **kw)  # noqa: E731
            ms = median_ms(fn)
            plain_ms = median_ms(lambda: klt_track.klt_track_ref(*call, **kw), reps=5, inner=1)
            evs = [e for e in device_events(lambda: [fn() for _ in range(20)])
                   if "klt_track_kernel" in e.key]
            seen = sum(e.count for e in evs)
            check(0 < seen <= 20, f"{tag}: the profiler recorded {seen} of 20 launches")
            device_us = sum(e.self_device_time_total for e in evs) / seen
            bound, by = bound_klt_track(live, kw["window"], kw["px"], kw["pys"])
            share = 100.0 * bound / (device_us / 1e3)
            out["rows"][f"{kind}_{S}"] = dict(ms=ms, plain_ms=plain_ms, device_us=device_us,
                                              bound_ms=bound, bound_by=by, roofline_pct=share)
            print(f"{tag}: bit-equal to the plain chain (d, status, min_eig) | tracked "
                  f"{int(got[1].sum())} of {int(valid.sum())} live | kernel {ms:.4f} ms (events) | "
                  f"device {device_us:.2f} us a launch | plain {plain_ms:.3f} ms | bound "
                  f"{bound:.6f} ms ({by}; live per level {[int(v.sum()) for v in live]}), "
                  f"{share:.2f}% of it")
    print(f"klt_track: {time.perf_counter() - t0:.1f} s | launches {_build.launches()['klt_track']}")
    return out


def _max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| of two tensors of one shape; entries equal
    (NaN against NaN, inf against the same inf) count 0."""
    g, w = got.double(), want.double()
    same = (g == w) | (torch.isnan(g) & torch.isnan(w))
    d = (g - w).abs().nan_to_num(nan=float("inf"))
    return float(torch.where(same, 0.0, d).max()) if d.numel() else 0.0


def _close_poses(got, want) -> tuple[float, int]:
    """Max pose difference over (..., F, 4, 4) trajectories and the number
    of frames past 1e-4."""
    d = np.abs(got - want).reshape(-1, 16).max(axis=1)
    return float(d.max()), int((d > 1e-4).sum())


def phase_batched_rng() -> None:
    """BatchedStereoVO(S=3, seed=5) against StereoVO(seed=5+s) on the card,
    25 frames at 184x320 frame by frame (the dynamic rule, patches): keys
    bit-equal every frame and stream, keyframe flags identical, poses within
    1e-4 but on a frame whose final PnP pick is a raw 6-point DLT
    hypothesis, held to 2e-3 m (ROADMAP C's trap; test_torch_batched.py's
    bounds)."""
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.geometry import camera as cam_mod
    from svo_tpu_torch.io.synthetic import SyntheticSequence
    from svo_tpu_torch.parallel.batched import BatchedStereoVO
    from svo_tpu_torch.pipeline.odometry import StereoVO

    t0 = time.perf_counter()
    S, F, seed = 3, 25, 5
    seqs = [SyntheticSequence(n_frames=F, shape=(184, 320), fx=200.0, speed=0.2 + 0.02 * s, seed=s)
            for s in range(S)]
    frames = [list(q) for q in seqs]
    cfg = Config(use_orb=False, image_height=184, image_width=320)
    cam = cam_mod.from_intrinsics(200.0, 200.0, 160.0, 92.0, seqs[0].baseline)
    bvo = BatchedStereoVO(cfg, cam, S)
    singles = [StereoVO(cfg, cam, seed=seed + s) for s in range(S)]
    bvo.start(np.stack([fr[0][1] for fr in frames]), np.stack([fr[0][2] for fr in frames]),
              seed=seed)
    for s, vo in enumerate(singles):
        vo.start(*frames[s][0][1:])
    for t in range(1, F):
        bvo.process(np.stack([_u8(fr[t][1]) for fr in frames]),
                    np.stack([_u8(fr[t][2]) for fr in frames]))
        for s, vo in enumerate(singles):
            vo.process(_u8(frames[s][t][1]), _u8(frames[s][t][2]))
            check(torch.equal(bvo.state.rng[s], vo.state.rng),
                  f"batched stream {s} and StereoVO(seed={seed + s}): keys differ at frame {t}")
    trajs = bvo.trajectories(F)
    lone = np.stack([vo.state.poses[:F].cpu().numpy() for vo in singles])
    kf_b = bvo.state.kf_flags[:, :F].cpu().numpy()
    kf_s = np.stack([vo.state.kf_flags[:F].cpu().numpy() for vo in singles])
    dmax, n_over = _close_poses(trajs, lone)
    print(f"rng: BatchedStereoVO(S={S}, seed={seed}) against StereoVO(seed={seed}+s), {F} frames "
          f"184x320 on the card: keys bit-equal every frame | keyframes equal "
          f"{bool((kf_b == kf_s).all())} | max |pose diff| {dmax:.3g}, {n_over} frame(s) past "
          f"1e-4 | {time.perf_counter() - t0:.1f} s")
    check(bool((kf_b == kf_s).all()), "batched and single-stream keyframe flags differ")
    check(dmax <= 2e-3 and n_over <= S, f"batched against single: {dmax} m, {n_over} frames")

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

    lead = frames[0][1].shape[:-2]  # () for one stream, (S,) for stacks
    seeds = list(range(lead[0])) if lead else 0  # the noise is given: the keys only move
    st = frontend.make_bootstrap(cam, cfg, lk_engine)(img(frames[0][1]), img(frames[0][2]), seeds)
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
    from svo_tpu_torch.io.synthetic import SyntheticSequence
    from svo_tpu_torch.ops.random import gumbel, prng_key

    seq = SyntheticSequence(n_frames=13, shape=(96, 256), fx=120.0, speed=0.12, seed=3)
    frames = list(seq)
    noises = [gumbel(prng_key(100 + i), RNG_SHAPE) for i in range(len(frames) - 1)]
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
    from svo_tpu_torch.io.synthetic import SyntheticSequence
    from svo_tpu_torch.ops.random import gumbel, prng_key

    seqs = [SyntheticSequence(n_frames=13, shape=(96, 256), fx=120.0, speed=0.12, seed=3 + s)
            for s in range(S)]
    per_stream = [list(q) for q in seqs]
    stacked = [(t, np.stack([fr[t][1] for fr in per_stream]),
                np.stack([fr[t][2] for fr in per_stream])) for t in range(13)]
    noises = [gumbel(prng_key(100 * i + np.arange(S)), RNG_SHAPE) for i in range(1, 13)]
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
    steps, replayed (the first chunk runs eagerly and is captured, the
    second is the replay under the profiler; the replay's in-graph copy of
    the state into the step's buffers counts among the activities). The
    profiler counts every device activity: kernels, fills and copies.
    Also the mean device us per launch of the port's own kernels.
    first: the (left, right) f32 tensors of frame 0; chunks: two
    (lefts_u8, rights_u8) chunks of n frames, the first to warm up, the
    second profiled. Tensors that carry a stream axis drive the batched step,
    where a frame step serves all streams."""
    from svo_tpu_torch.pipeline import frontend

    cfg, cam = _config_and_camera(seq, "cuda")
    step = frontend.make_cadenced_chunk_step(cam, cfg, n, CADENCE, lk_engine)
    lead = first[0].shape[:-2]
    st = frontend.make_bootstrap(cam, cfg, lk_engine)(*first, list(range(lead[0])) if lead else 0)
    st = step(st, *chunks[0])  # warm-up chunk
    dev = device_events(lambda: step(st, *chunks[1]))
    launches = sum(e.count for e in dev)
    check(launches > 0, "the profiler saw no device activity")
    own = {}
    for name in ("klt_track_kernel", "lk_level_kernel", "threefry_split_gumbel_kernel",
                 "fast_nms_kernel"):
        evs = [e for e in dev if name in e.key]
        count = sum(e.count for e in evs)
        if count:
            own[name] = sum(e.self_device_time_total for e in evs) / count
    return launches / n, sum(e.self_device_time_total for e in dev) / n / 1e3, own


def _expected_launches(n_kf: int, steps: int = N_FRAMES - 1) -> int:
    """Launches of the path's kernel in a cadenced run of `steps` frame
    steps (bench.py's 97-frame run unless given) with n_kf keyframe steps,
    bootstraps included. Either engine makes a tracker call one launch:
    patches (klt_track) every level of any call, fused (lk_level) every
    level at 376x1241, where all qualify. So the temporal and the fb call
    per frame, the stereo call per keyframe. The count does not depend on
    the number of streams: a launch serves all of them."""
    return 2 * steps + n_kf


PATH_KERNEL = {"patches": "klt_track", "fused": "lk_level"}


def _levels(use_orb: bool) -> int:
    """The detector's fast_nms launches a keyframe step: one for FAST (the
    left image), one a pyramid level of Config()'s ORB."""
    from svo_tpu_torch.config import Config

    return Config().orb_params.pyr_levels if use_orb else 1


def _want(name: str, engine: str, n_kf: int, steps: int, levels: int) -> int:
    """The launch rule of one kernel in a run of `steps` frame steps with
    n_kf keyframe steps (bootstraps included): the engine's KLT kernel by
    _expected_launches, the other KLT kernel never, the threefry kernel once
    a frame step (a launch draws every stream's noise; a bootstrap draws
    none), the PnP kernel twice a frame step (hypotheses, then the choice;
    a bootstrap solves none), the FAST kernel `levels` times a keyframe step
    (_levels: a launch detects on every stream's image of one level)."""
    if name == "threefry":
        return steps
    if name == "ransac_pnp":
        return 2 * steps
    if name == "fast_nms":
        return levels * n_kf
    return _expected_launches(n_kf, steps) if name == PATH_KERNEL[engine] else 0


def _check_launches(tag, engine, counts, n_kf, steps: int = N_FRAMES - 1, *, levels: int):
    for name, count in counts.items():
        want = _want(name, engine, n_kf, steps, levels)
        check(count == want, f"{tag} {engine}: {name} launched {count} times, expected {want}")


def phase_main_path(frames, seq) -> tuple[dict, dict]:
    """bench.py's single-stream path once per KLT engine, then a profiled
    chunk of each. The runs are warm: the small agreement runs have driven
    the whole pipeline on the card before, and the kernels are built and
    loaded (no separate warm run, to keep the script inside its time).
    Returns the launches of each kernel in each engine's run, and
    each engine's ATE."""
    from svo_tpu_torch.eval.trajectory import ate_rmse

    launches, ates, warm = {}, {}, {}
    for engine in ENGINES:
        _build.reset_counters()
        torch.cuda.reset_peak_memory_stats()
        res = _run(frames, seq, "cuda", engine)
        peak = torch.cuda.max_memory_allocated()
        warm[engine] = res.fps
        counts = _build.launches()
        launches[engine] = counts
        poses = res.poses
        check(poses.shape == (N_FRAMES, 4, 4), f"poses shape {poses.shape}")
        check(bool(np.isfinite(poses).all()), f"{engine}: NaN/inf in the poses")
        ate = ates[engine] = float(ate_rmse(poses, seq.gt_poses))
        inl = float(res.metrics[1:, 1].mean())
        live = float(res.metrics[:, 2].mean())
        n_kf = int(res.kf_flags.sum())
        print(f"main path lk_engine={engine}: ATE {ate:.4f} m (limit {ATE_LIMIT_M}; the TPU's "
              f"{TPU_ATE_M}, BENCH_r05.json, the same PnP noise: {ate - TPU_ATE_M:+.4f} m) | "
              f"mean inlier ratio {inl:.4f} | mean live features {live:.1f} | "
              f"keyframes {n_kf} | {res.fps:.3f} frames/s, {1e3 / res.fps:.2f} ms/frame | "
              f"peak device memory {peak / 2**20:.1f} MiB | launches {counts}")
        check(np.isfinite(ate) and ate <= ATE_LIMIT_M, f"{engine}: ATE {ate} m > {ATE_LIMIT_M} m")
        check(inl >= 0.8, f"{engine}: mean inlier ratio {inl} < 0.8")
        check(live >= 60, f"{engine}: mean live features {live} < 60")
        _check_launches("single stream", engine, counts, n_kf, levels=1)

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


def _stage_batched(frames, seq, tag: str = "batched main path") -> SimpleNamespace:
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
    print(f"{tag}: {S} streams x {N_FRAMES} frames, {n_chunks} chunks of {CHUNK} "
          f"staged on the card, {staged / 2**20:.1f} MiB uint8")
    return SimpleNamespace(cfg=cfg, cam=cam, gts=gts, l0=l0, r0=r0, stage=stage, chunks=chunks,
                           n_stepped=n_chunks * CHUNK)


def _stream_ates(trajs, staged) -> list:
    from svo_tpu_torch.eval.trajectory import ate_rmse

    n = staged.n_stepped + 1
    return [float(ate_rmse(trajs[s], staged.gts[s][:n])) for s in range(len(trajs))]


def phase_batched_main_path(seq, staged) -> dict:
    """The batched main path: BatchedStereoVO with 8 streams in lockstep on
    bench.py's sequence (even streams forward, odd streams reversed), chunk
    12, keyframe cadence 6, all chunks staged on the card as uint8, once
    per KLT engine with accuracy and launch-count checks, each run timed
    (warm: the single-stream paths ran before), then a profiled 6-frame
    chunk of each engine. Returns the launches of each kernel in
    each engine's run, and each engine's aggregate frames/s and per-stream
    ATEs."""
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

    launches, warm, stream_ates = {}, {}, {}
    for engine in ENGINES:
        _build.reset_counters()
        torch.cuda.reset_peak_memory_stats()
        bvo, wall = drive(engine)
        peak = torch.cuda.max_memory_allocated()
        warm[engine] = S * n_stepped / wall
        counts = _build.launches()
        launches[engine] = counts
        trajs = bvo.trajectories(n_stepped + 1)
        check(trajs.shape == (S, N_FRAMES, 4, 4), f"batched poses shape {trajs.shape}")
        check(bool(np.isfinite(trajs).all()), f"batched {engine}: NaN/inf in the poses")
        ates = stream_ates[engine] = _stream_ates(trajs, staged)
        metrics = bvo.state.metrics[:, : n_stepped + 1].cpu().numpy()
        inl = metrics[:, 1:, 1].mean(axis=1)
        live = metrics[:, :, 2].mean(axis=1)
        n_kf = bvo.state.kf_flags[:, : n_stepped + 1].sum(dim=1).tolist()
        print(f"batched main path lk_engine={engine}: per-stream ATE "
              f"{' '.join(f'{a:.4f}' for a in ates)} m (limit {ATE_LIMIT_M}) | the TPU's per "
              f"stream, BENCH_r05.json, the same PnP noise: "
              f"{' '.join(f'{a:.4f}' for a in TPU_ATE_PER_STREAM_M)} m, port - TPU "
              f"{' '.join(f'{a - b:+.4f}' for a, b in zip(ates, TPU_ATE_PER_STREAM_M))} m | "
              f"mean inlier ratio per stream "
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
        _check_launches(f"batched S={S}", engine, counts, n_kf[0], levels=_levels(cfg.use_orb))

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
    return launches, {e: dict(fps=warm[e], ates=stream_ates[e]) for e in ENGINES}


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


# the refined arm's per-stream ATEs on an NVIDIA H100 80GB HBM3 (700 W) with
# the refiner run eagerly and the chunks replayed (two runs, the same to the
# digit), taken before the package preferred cuSOLVER for torch.linalg, with
# torch's default backend (MAGMA for the batched solves). They are printed
# beside the captured refiner's as a reading, with whether the two agree to
# the digit, and are not checked: the captured refiner is held bit-equal to
# the eager one, under the same backend, sweep by sweep in phase_refine_graph
EAGER_REFINER_ATE_M = (0.0421, 0.0742, 0.0424, 0.0752, 0.0415, 0.0721, 0.0413, 0.0756)


def _bent(state, F: int):
    """The state with every stream's last 20 frames (of F) bent by a
    growing yaw and side slip: the spans leave their map behind, the
    aggressive regime."""
    k = torch.arange(1, 21, dtype=torch.float32, device="cuda")
    bend = torch.eye(4, device="cuda").repeat(20, 1, 1)
    bend[:, 0, 0] = bend[:, 2, 2] = torch.cos(0.004 * k)
    bend[:, 0, 2] = torch.sin(0.004 * k)
    bend[:, 2, 0] = -torch.sin(0.004 * k)
    bend[:, 0, 3] = 0.02 * k
    poses = state.poses.clone()
    poses[:, F - 20: F] = poses[:, F - 20: F] @ bend
    return state._replace(poses=poses, pose=poses[:, F - 1])


def phase_refined_main_path(staged, without: dict) -> SimpleNamespace:
    """bench.py's refined arm at full width: 8 streams, 376x1241, 97 frames,
    chunk 12, cadence 6, the fused engine, refine() (span 22, the defaults)
    every 2 chunks and at the last chunk inside the timed loop, the chunks
    and the sweeps replayed (the refiner captured at its first sweep); beside
    it the same run without refine() in this call: `without`, the batched
    main path's fused run (frames/s and per-stream ATEs; a second unrefined
    run here would repeat it, so it was cut for the script's time), after a
    warm-up of one chunk and one sweep as bench.py.
    Every stream's refined ATE must stay under the limit (printed beside
    the eager refiner's earlier readings, EAGER_REFINER_ATE_M, a reading
    and not a check) and the state finite;
    refine() must leave the kernels' launch count what it was. Then the
    final state with every stream's last 20 poses bent by a growing yaw
    and side slip must be in the aggressive regime in every stream.
    Returns the engine after the refined run."""
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
    del warm

    fps = {False: [without["fps"]], True: []}
    ates = {False: without["ates"]}
    staged_mib = sum(t.numel() for c in staged.chunks for t in c) / 2**20
    for turn, refine in enumerate((True,), start=1):
        _build.reset_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bvo, wall, verdicts = drive(refine)
        peak = torch.cuda.max_memory_allocated() / 2**20
        counts = _build.launches()
        trajs = bvo.trajectories(n_stepped + 1)
        check(all(bool(torch.isfinite(x).all()) for x in _leaves(bvo.state)
                  if x.is_floating_point()), f"refined arm turn {turn}: non-finite state")
        n_kf = bvo.state.kf_flags[:, : n_stepped + 1].sum(dim=1).tolist()
        _check_launches(f"refined arm turn {turn}", "fused", counts, n_kf[0],
                        levels=_levels(staged.cfg.use_orb))
        ates[refine] = _stream_ates(trajs, staged)
        fps[refine].append(S * n_stepped / wall)
        line = (f"refined arm turn {turn}, refine {'every 2 chunks + flush' if refine else 'off'}: "
                f"{fps[refine][-1]:.3f} frames/s aggregate | {wall:.3f} s | per-stream ATE "
                f"{' '.join(f'{a:.4f}' for a in ates[refine])} m | launches {counts}")
        if refine:
            line += " | accepted per sweep " + " ".join(
                "".join(str(int(v)) for v in acc) for acc in verdicts)
            graph = bvo.refiner.graph
            line += (f" | refiner captured: graphs {sorted(graph.graphs)}, capture + instantiate s "
                     f"{ {k: round(v, 3) for k, v in graph.capture_s.items()} } | peak device "
                     f"memory {peak:.1f} MiB in this worker ({staged_mib:.1f} MiB of it the "
                     f"staged chunks)")
            check(sorted(graph.graphs) == ["aggressive", "healthy", "pre"],
                  f"the refiner's graphs: {sorted(graph.graphs)}")
            n_chunks = len(staged.chunks)  # the terminal flush adds a sweep to an odd count
            check(len(verdicts) == n_chunks // REFINE_EVERY + (n_chunks % REFINE_EVERY > 0),
                  f"{len(verdicts)} sweeps")
            refined_bvo = bvo
        print(line)
        for s, a in enumerate(ates[refine]):
            check(np.isfinite(a) and a <= ATE_LIMIT_M,
                  f"refined arm turn {turn}: stream {s} ATE {a} m > {ATE_LIMIT_M} m")
    with_, without = float(np.mean(fps[True])), float(np.mean(fps[False]))
    same = [round(a, 4) for a in ates[True]] == list(EAGER_REFINER_ATE_M)
    print(f"refined arm: per-stream ATE refined, refiner captured, "
          f"{' '.join(f'{a:.4f}' for a in ates[True])} m beside the eager refiner's "
          f"{' '.join(f'{a:.4f}' for a in EAGER_REFINER_ATE_M)} m (to the digit: {same}) and "
          f"unrefined {' '.join(f'{a:.4f}' for a in ates[False])} m in this call (limit "
          f"{ATE_LIMIT_M}; the TPU package's BENCH_r05.json, an accuracy reference: 0.0391-0.0968 "
          f"refined, 0.0444-0.0949 unrefined) | aggregate frames/s with refine "
          f"{' / '.join(f'{f:.3f}' for f in fps[True])}, without "
          f"{' / '.join(f'{f:.3f}' for f in fps[False])}: {with_ / without:.3f} of without "
          f"(one turn each: inside the host's spread)")

    from svo_tpu_torch.parallel.global_opt import refine_global

    F = n_stepped + 1
    drifted = _bent(refined_bvo.state, F)
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
    return refined_bvo


def phase_refine_graph(bvo) -> None:
    """svo_tpu's jitted, donated refiner (jax.jit(_refine,
    donate_argnums=(0,)); global_opt.make_refine_global): the conservative
    stage as one graph, the regime read once, one graph per regime, both
    captured at the first call; against refine_global (graph=False) on the
    same inputs, on the refined arm's final state (healthy in every stream)
    and on it with every stream's last 20 poses bent (aggressive in every
    stream): for S=8 (healthy first, then aggressive, then healthy again,
    replayed) and for stream 0 alone (S=1, aggressive first). Every leaf of
    each result bit-equal; each state in its regime; one regime read a
    sweep, the read the only host sync of a replayed sweep (torch's sync
    debug mode); for S=8 an aggressive sweep runs more device activities
    than a healthy one (profiler), eager and replayed; no counted kernel
    launched; the capture seconds of each graph."""
    from unittest import mock

    from svo_tpu_torch.parallel import global_opt
    from svo_tpu_torch.parallel.global_opt import make_refine_global
    from svo_tpu_torch.pipeline.state import clone, unstack

    K = bvo.camera.K
    bfx = K[0, 0] * bvo.camera.baseline
    F = int(bvo.state.frame_id[0]) + 1
    healthy = clone(bvo.state)
    drifted = _bent(healthy, F)
    eager = make_refine_global(K, bfx, graph=False)
    one = [unstack(st)[0] for st in (healthy, drifted)]
    cases = ((STREAMS, [(healthy, "healthy"), (drifted, "aggressive"), (healthy, "healthy")]),
             (1, [(one[1], "aggressive"), (one[0], "healthy")]))
    for S, order in cases:
        captured = make_refine_global(K, bfx)
        _build.reset_counters()
        with mock.patch.object(global_opt, "_read_regime", wraps=global_opt._read_regime) as read:
            for i, (st, want_regime) in enumerate(order):
                args = (st.map, st.poses, st.frame_id)
                n_before = read.call_count
                got = captured(*args)
                torch.cuda.synchronize()
                sweep_reads = read.call_count - n_before
                want = eager(*args)
                same = _bit_equal(got, want)
                aggressive = (want.cost_per_obs > 10.0).reshape(-1).tolist()
                regime = "aggressive" if any(aggressive) else "healthy"
                print(f"refine graph S={S}, sweep {i + 1} ({regime}"
                      f"{', the first call: every graph captured' if i == 0 else ', replayed'}): "
                      f"bit-equal to refine_global in every leaf {same} | regime reads {sweep_reads} "
                      f"| streams aggressive {sum(aggressive)} of {len(aggressive)} | accepted "
                      f"{want.accepted.int().reshape(-1).tolist()}")
                check(same, f"refine graph S={S} sweep {i + 1}: differs from refine_global")
                check(regime == want_regime,
                      f"refine graph S={S} sweep {i + 1}: the {want_regime} state is {regime}")
                check(sweep_reads == 1, f"refine graph S={S}: {sweep_reads} regime reads a sweep")
        if S == STREAMS:
            for name, fn in (("eager", eager), ("replayed", captured)):
                acts = {r: sum(e.count for e in device_events(
                            lambda st=st: fn(st.map, st.poses, st.frame_id)))
                        for st, r in order[:2]}
                print(f"refine graph S={S} {name}: device activities a sweep {acts}")
                check(acts["aggressive"] > acts["healthy"],
                      f"refine graph S={S} {name}: the aggressive regime ran no more device "
                      f"activities than the healthy one: {acts}")
        syncs = _host_syncs(lambda: captured(*args))
        check(syncs == 1, f"refine graph S={S}: {syncs} host syncs in a replayed sweep, expected 1")
        counts = _build.launches()
        check(not any(counts.values()), f"the refiner launched counted kernels: {counts}")
        graph = captured.graph
        print(f"refine graph S={S}: graphs {sorted(graph.graphs)}, capture + instantiate s "
              f"{ {k: round(v, 3) for k, v in graph.capture_s.items()} } | host syncs in a "
              f"replayed sweep {syncs} | counted kernel launches {counts}")
        check(sorted(graph.graphs) == ["aggressive", "healthy", "pre"],
              f"refine graph S={S}: graphs {sorted(graph.graphs)}")
        del captured, graph


def phase_ba_throughput(bvo) -> None:
    """bench.py's BA stage: solve_ba, 10 LM iterations, on the window of the
    last 10 frames (1024 point slots, 4096 observation slots) extracted
    from stream 0's live map after the refined run; 20 repetitions, eager
    and replayed (make_solve_ba: one graph, bit-equal to solve_ba; in this
    worker, beside the others on the card)."""
    from svo_tpu_torch.ba.solver import make_solve_ba, solve_ba
    from svo_tpu_torch.ba.window import extract_window
    from svo_tpu_torch.pipeline.state import unstack

    iters, reps = 10, 20
    st0 = unstack(bvo.state)[0]
    problem, _ = extract_window(st0.map, st0.poses, st0.frame_id, n_cams=10, n_points=1024, n_obs=4096)
    K = bvo.camera.K
    bfx = K[0, 0] * bvo.camera.baseline
    captured = make_solve_ba(K, bfx, iterations=iters)
    rates = {}
    for name, solve in (("eager", lambda p: solve_ba(p, K, bfx, iterations=iters)),
                        ("replayed", captured)):
        res = solve(problem)  # warm-up (the capture)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            res = solve(problem)
        torch.cuda.synchronize()
        rates[name] = iters * reps / (time.perf_counter() - t0)
    same = _bit_equal(captured(problem), solve_ba(problem, K, bfx, iterations=iters))
    dev = device_events(lambda: solve_ba(problem, K, bfx, iterations=iters))
    acts = sum(e.count for e in dev)
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
    check(bool(torch.isfinite(res.cost)) and float(res.cost) <= float(res.cost0),
          "BA throughput: the solve did not lower a finite cost")
    check(same, "BA throughput: the replayed solve differs from solve_ba")
    print(f"BA throughput: {rates['eager']:.1f} LM iterations/s eager, {rates['replayed']:.1f} "
          f"replayed (bit-equal {same}; capture + instantiate {captured.graph.capture_s[()]:.3f} s) "
          f"| window of {int(problem.obs_valid.sum())} valid "
          f"observations, {int(problem.pnt_valid.sum())} points, {int(problem.cam_valid.sum())} "
          f"cameras | cost {float(res.cost0):.1f} -> {float(res.cost):.1f} | eager: {acts / iters:.0f} "
          f"device activities and {dev_ms / iters:.3f} ms device time an iteration")


@contextlib.contextmanager
def _recording_keys():
    """Every branch key the frame steps read (frontend._read_key, the
    step's one host read), in order, into the list this yields."""
    from svo_tpu_torch.pipeline import frontend

    read, keys = frontend._read_key, []

    def recorded(flags):
        keys.append(read(flags))
        return keys[-1]

    frontend._read_key = recorded
    try:
        yield keys
    finally:
        frontend._read_key = read


def _solved_frames(keys, chunked: bool) -> list:
    """The frames whose step ran the window BA, from the keys read in
    order: a cadenced chunk's BA schedule (chunk c's keyframe step j is
    frame 1 + c * CHUNK + j * CADENCE), or a frame step's (any keyframe,
    any BA) (frame i + 1)."""
    if chunked:
        return [1 + c * CHUNK + j * CADENCE for c, k in enumerate(keys)
                for j, due in enumerate(k) if due]
    return [i + 1 for i, k in enumerate(keys) if k[1]]


def _ba_due(kf_flags, cfg) -> list:
    """The frames at which the window BA's rule fires, from a run's
    keyframe flags."""
    count = np.cumsum(kf_flags)
    return [f for f in range(1, len(kf_flags)) if kf_flags[f] and count[f] >= cfg.ba.window
            and count[f] % cfg.ba.interval == 0]


def phase_ba_main_path(frames, seq, ate_off: float) -> None:
    """One stream with the in-pipeline window BA at its defaults (window 8
    keyframes, every 4 keyframes, 10 iterations), fused engine, bench.py's
    sequence through run_chunked, each chunk a replay of the graph of its
    BA schedule. The BA solves are counted from the schedules the chunks
    read (a replay runs no Python) and held against what the rule gives
    from kf_flags."""
    from svo_tpu_torch.config import BaParams, Config
    from svo_tpu_torch.eval.trajectory import ate_rmse
    from svo_tpu_torch.geometry import camera as cam_mod
    from svo_tpu_torch.pipeline.odometry import StereoVO

    cfg = Config(use_orb=False, image_height=SHAPE[0], image_width=SHAPE[1], ba=BaParams(enabled=True))
    cam = cam_mod.from_intrinsics(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline)
    vo = StereoVO(cfg, cam, chunk=CHUNK, kf_cadence=CADENCE, lk_engine="fused")
    with _recording_keys() as keys:
        res = vo.run_chunked(frames)
    solved = _solved_frames(keys, True)
    check(vo._chunk_step.capture, "BA main path: the chunk was not captured")
    check(bool(np.isfinite(res.poses).all()), "BA main path: NaN/inf in the poses")
    due = _ba_due(res.kf_flags, cfg)
    ate = float(ate_rmse(res.poses, seq.gt_poses))
    print(f"BA main path (ba.enabled, window {cfg.ba.window}, interval {cfg.ba.interval}, fused): "
          f"ATE {ate:.4f} m beside {ate_off:.4f} m with BA off (limit {ATE_LIMIT_M}) | keyframes "
          f"{int(res.kf_flags.sum())} | BA solves at frames {solved}, the rule gives {due} | "
          f"schedules captured {sorted(vo._chunk_step.graphs)} | {res.fps:.3f} frames/s | mean "
          f"inlier ratio {float(res.metrics[1:, 1].mean()):.4f}")
    check(solved == due, f"BA solves at {solved}, the rule gives {due}")
    check(len(due) == 3, f"expected 3 BA solves in {N_FRAMES} frames, the rule gives {len(due)}")
    check(np.isfinite(ate) and ate <= ATE_LIMIT_M, f"BA main path: ATE {ate} m > {ATE_LIMIT_M} m")


def phase_checkpoint(staged) -> None:
    """Checkpoint on the card: 8 streams, fused engine, refine() after every
    2 chunks. The state (its PnP keys included) is saved after chunk 2; a
    fresh engine (started with another seed) loads it; both run chunks 3-4:
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
        save_state(path, a.state)
        size = os.path.getsize(path)
        b = engine(1)
        check(not torch.equal(a.state.rng, b.state.rng), "the fresh engine has the same keys")
        b.state = load_state(path, b.state)
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
    st = frontend.make_bootstrap(cam, cfg, engine)(*imgs[0], 0)

    def step(st, i, mode):
        return frontend.step_body(st, *imgs[i], cam, cfg, kf_mode=mode, lk_engine=engine)

    st = step(step(st, 1, "always"), 2, "never")  # warm
    out = {}
    for i, mode in ((3, "always"), (4, "never")):
        dev = device_events(lambda: step(st, i, mode))
        out[mode] = (sum(e.count for e in dev), sum(e.self_device_time_total for e in dev) / 1e3)
    return out


def phase_shipping_main_path(frames, seq) -> dict:
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
            _build.reset_counters()
            rc = run_synthetic.main([
                "--frames", str(N_FRAMES), "--chunk", str(CHUNK), "--cadence", str(cadence),
                "--lk-engine", engine, "--device", "cuda", "--seed", "0",
                "--out-json", path])
            counts = _build.launches()
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
            for name, count in counts.items():
                want = _want(name, engine, r["keyframes"], N_FRAMES - 1, _levels(True))
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


def phase_shipping_batched(staged) -> dict:
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

    _build.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    bvo, wall = drive()
    peak = torch.cuda.max_memory_allocated()
    counts = _build.launches()
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
    _check_launches(f"batched ORB S={S}", "fused", counts, n_kf[0], levels=_levels(cfg.use_orb))
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

def phase_soak() -> dict:
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

    _build.reset_counters()
    argv = ["--frames", str(SOAK_FRAMES), "--refine-every", str(REFINE_EVERY), "--ckpt-at", "10",
            "--resume-chunks", "4", "--lk-engine", "fused", "--device", "cuda"]
    t0 = time.perf_counter()
    r, vo = soak.soak(soak.parse_args(argv))
    wall = time.perf_counter() - t0
    counts = _build.launches()
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
    _check_launches("soak", "fused", counts, r["steps"]["keyframes"], r["steps"]["frames"],
                    levels=1)
    return dict(counts=counts, result=r)


def phase_worlds() -> dict:
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

    _build.reset_counters()
    argv = ["--frames", "241", "--limit", str(WORLDS_FRAMES), "--refine-every", str(REFINE_EVERY),
            "--skip-ref", "--lk-engine", "fused", "--device", "cuda"]
    t0 = time.perf_counter()
    r, _ = eval_worlds.evaluate(eval_worlds.parse_args(argv))
    wall = time.perf_counter() - t0
    counts = _build.launches()
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
    _check_launches("worlds", "fused", counts, r["steps"]["keyframes"], r["steps"]["frames"],
                    levels=1)
    return dict(counts=counts, result=r)


RECOVERY_FRAMES, RECOVERY_INJECT_AT = 97, 49   # eval_recovery's 241 / 121, depth cut
# svo_tpu's reading of the same run (fused, PnP seed 0: the noise the port
# now draws), on the CPU: SVO_TPU_FUSED_LK=1 SVO_TPU_FUSED_INTERPRET=1
# python3 tests/recovery_reference.py --frames 97 --inject-at 49
# --lk-engine fused --device cpu (the port's fused CPU path beside it read
# every number within 5e-4 m)
SVO_TPU_RECOVERY = {"span_abs_err_after_m": 0.4650324848444315,
                    "post_abs_err_no_backend_m": 1.8314095896513976,
                    "post_abs_err_recovered_m": 0.7666799738626442, "recovered": True}
EUROC_MINI_ATE_M = 0.0455  # svo_tpu's EUROC_r05.json on tests/fixtures/euroc_mini


def phase_recovery() -> dict:
    """svo_tpu_torch.eval_recovery at 376x1241, fused, cut to 97 frames:
    corridor-base run healthily to frame 48, 4 degrees and 0.8 m of drift
    injected over frames 27-48 (the poses and the points born there), one
    refine_global sweep, then arm A without a back-end and arm B from the
    swept state with refine_global every 2 chunks, to frame 96. Held: the
    aggressive regime fired and its sweep was accepted, the span's error
    fell, arm B recovered: under half the error of the arm without a
    back-end, taken from svo_tpu's run of the same frames, injection and
    noise (SVO_TPU_RECOVERY; the port's own arm A is printed beside it: an
    arm without a back-end after 1.8 m of drift may re-lock on the older
    points or not, a draw that rounding decides, so the card's arm A is a
    reading), both arms started from the same PnP key, and lk_level was
    launched by the launch rule over the healthy run and both arms."""
    from svo_tpu_torch import eval_recovery

    _build.reset_counters()
    argv = ["--frames", str(RECOVERY_FRAMES), "--inject-at", str(RECOVERY_INJECT_AT),
            "--span", "22", "--lk-engine", "fused", "--device", "cuda"]
    t0 = time.perf_counter()
    r, _ = eval_recovery.recovery(eval_recovery.parse_args(argv))
    wall = time.perf_counter() - t0
    counts = _build.launches()
    print(f"recovery: {r['frames']} frames 376x1241 fused, drift at frame {r['inject_at']} over "
          f"{r['span']} frames: newest pose {r['newest_pose_err_m']:.4f} m off | sweep cost "
          f"{r['refine_cost_per_obs_px']:.4f} px/obs, aggressive {r['aggressive_fired']}, accepted "
          f"{r['accepted']}, span error {r['span_abs_err_before_m']:.4f} -> "
          f"{r['span_abs_err_after_m']:.4f} m | after the injection: no back-end "
          f"{r['post_abs_err_no_backend_m']:.4f} m, recovered {r['post_abs_err_recovered_m']:.4f} m, "
          f"recovered {r['recovered']} | PnP key at each arm {r['arm_rng_keys']} | "
          f"{wall:.1f} s | launches {counts}")
    check(r["aggressive_fired"] and r["accepted"],
          f"recovery: aggressive {r['aggressive_fired']}, accepted {r['accepted']}")
    check(r["span_abs_err_after_m"] < r["span_abs_err_before_m"],
          f"recovery: the sweep did not reduce the span's error ({r['span_abs_err_before_m']} -> "
          f"{r['span_abs_err_after_m']} m)")
    ref = SVO_TPU_RECOVERY
    print(f"recovery beside svo_tpu's (CPU, same frames, injection and noise): span error after "
          f"the sweep {r['span_abs_err_after_m']:.4f} / {ref['span_abs_err_after_m']:.4f} m | arm A "
          f"(no back-end) {r['post_abs_err_no_backend_m']:.4f} / "
          f"{ref['post_abs_err_no_backend_m']:.4f} m | arm B {r['post_abs_err_recovered_m']:.4f} / "
          f"{ref['post_abs_err_recovered_m']:.4f} m | recovered {r['recovered']} / "
          f"{ref['recovered']}")
    check(r["post_abs_err_recovered_m"] < 0.5 * ref["post_abs_err_no_backend_m"],
          f"recovery: arm B {r['post_abs_err_recovered_m']} m is not under half of svo_tpu's arm "
          f"without a back-end, {ref['post_abs_err_no_backend_m']} m")
    keys = r["arm_rng_keys"]
    check(len(keys) == 2 and keys[0] == keys[1], f"recovery: the arms' keys differ {keys}")
    _check_launches("recovery", "fused", counts, r["steps"]["keyframes"], r["steps"]["frames"],
                    levels=1)
    return dict(counts=counts, result=r)


def phase_eval_ba(frames, seq) -> dict:
    """svo_tpu_torch.eval_ba on the 97 frames rendered above: run_chunked
    (fused), then refine_global swept over the finished trajectory in
    22-frame spans (frames 21, 42, 63, 84 and 96) with eval_ba's sizes.
    Held: every swept pose finite, one sweep per span end, lk_level
    launched by the launch rule; ATE before and after printed."""
    from svo_tpu_torch import eval_ba

    _build.reset_counters()
    args = eval_ba.parse_args(["--frames", str(N_FRAMES), "--lk-engine", "fused",
                               "--device", "cuda"])
    t0 = time.perf_counter()
    r, _ = eval_ba.evaluate(args, frames=frames, seq=seq)
    wall = time.perf_counter() - t0
    counts = _build.launches()
    his = eval_ba.schedule(N_FRAMES, args.blocks, args.cams_per_block)
    print(f"eval_ba: {eval_ba.summary_line(r)} | spans ending at {r['his']}, accepted "
          f"{r['accepted']}, cost/obs {[round(c, 3) for c in r['cost_per_obs']]} | {wall:.1f} s | "
          f"launches {counts}")
    check(r["finite"], "eval_ba: a swept pose is not finite")
    check(r["sweeps"] == len(his) == 5 and r["his"] == his,
          f"eval_ba: {r['sweeps']} sweeps at {r['his']}, expected {his}")
    _check_launches("eval_ba", "fused", counts, r["steps"]["keyframes"], r["steps"]["frames"],
                    levels=1)
    return dict(counts=counts, result=r)


def phase_eval_tables() -> dict:
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
            _build.reset_counters()
            r, _ = eval_fleet.evaluate(eval_fleet.parse_args(
                argv + ["--lk-engine", engine, "--device", "cuda"]))
            per_run[tag] = _build.launches()
            check(len(r["rows"]) == (1 if tag == "kitti_mini" else 2), f"fleet {tag}: {r['rows']}")
            for row in r["rows"]:
                rows.append((tag, row))
                check(row["finite"] and np.isfinite(row["ate_m"]),
                      f"fleet {tag} {row['seq']}: ATE {row['ate_m']}")
            _check_launches(f"fleet {tag}", engine, per_run[tag],
                            sum(row["keyframes"] for row in r["rows"]),
                            sum(row["frames"] - 1 for row in r["rows"]), levels=1)
    _build.reset_counters()
    e, _ = eval_euroc.evaluate(eval_euroc.parse_args(["--lk-engine", "patches", "--device", "cuda"]))
    per_run["euroc_mini"] = _build.launches()
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
    _check_launches("euroc_mini", "patches", per_run["euroc_mini"], e["keyframes"], e["frames"] - 1,
                    levels=1)
    counts = {k: sum(c[k] for c in per_run.values()) for k in per_run["euroc_mini"]}
    check(counts["klt_track"] > 0 and counts["lk_level"] > 0, f"eval tables: launches {counts}")
    return dict(counts=counts, fleet=rows, euroc=e)


TOOLS_FRAMES = 49  # the timing tools' depth on main's 97 frames: 4 chunks of 12


def phase_tools(frames, seq) -> dict:
    """The port's developer tools on the card, each through its function, at
    the main path's width and cut depth (the first 49 frames of each of 8
    streams of main's 97-frame sequence, even forward, odd reversed):
    patch_extraction_selftest on frame 1's left image (exactly 0.0, one
    klt_patches launch); bench_batched with each engine and time_chunk with
    both engines in turns, 2 reps (every stream's ATE within 0.273 m, each
    engine's two reps bit-equal, each kernel launched by the launch rule);
    profile_chunk (fused): lk_level 26 times in the traced 12-frame chunk
    (2 a frame + 1 for each of its 2 keyframe steps), by the wrapper's count
    and by the profiler's, a device total > 0 and a busy share in (0, 1];
    klt_bench with each engine against the same pair on the CPU path (the
    plain versions): survival equal, median error within 1e-3 px; microbench
    (every stage finite); soak_ref over 25 frames (finite)."""
    from svo_tpu_torch import (bench_batched, klt_bench, microbench, profile_chunk, soak_ref,
                               time_chunk)
    from svo_tpu_torch.ops.klt import patch_extraction_selftest

    _build.reset_counters()
    t0 = time.perf_counter()
    selftest = patch_extraction_selftest(torch.from_numpy(frames[1][1]).cuda())
    n_self = _build.launches()["klt_patches"]
    print(f"tools | patch_extraction_selftest on frame 1 ({SHAPE[0]}x{SHAPE[1]}, 64 features): max "
          f"|diff| {selftest} | klt_patches launches {n_self}")
    check(selftest == 0.0 and n_self == 1, f"self-test: {selftest}, {n_self} launches")
    argv = ["--streams", str(STREAMS), "--frames", str(TOOLS_FRAMES), "--device", "cuda"]
    steps = TOOLS_FRAMES - 1

    def check_run(tag, engine, before, starts, n_steps):
        """The kernel launches since `before` against the launch rule."""
        n_kf = starts + n_steps // CADENCE  # each start is a bootstrap (stereo) step
        got = {k: n - before.get(k, 0) for k, n in _build.launches().items()}
        for name, count in got.items():
            want = _want(name, engine, n_kf, n_steps, 1)
            check(count == want, f"{tag} {engine}: {name} launched {count} times, expected {want}")

    def check_ates(tag, ates):
        check(all(np.isfinite(a) and a <= ATE_LIMIT_M for a in ates),
              f"{tag}: per-stream ATE {ates} (limit {ATE_LIMIT_M})")

    for engine in ENGINES:
        before = _build.launches()
        # [0]: the engine, and its graph's memory pool, go before the next one
        r = bench_batched.bench(bench_batched.parse_args(argv + ["--lk-engine", engine]),
                                seq=seq, frames=frames)[0]
        print(f"tools | bench_batched: {bench_batched.summary_line(r)} | per-stream ATE "
              f"{' '.join(f'{a:.4f}' for a in r['ate_per_stream_m'])} m")
        check_ates(f"bench_batched {engine}", r["ate_per_stream_m"])
        check_run("bench_batched", engine, before, 2, CHUNK + steps)  # warm chunk + timed run
    before = _build.launches()
    r, _ = time_chunk.time_chunks(time_chunk.parse_args(argv + ["--reps", "2", "--lk-engine", "both"]),
                                  seq=seq, frames=frames)
    for line in time_chunk.summary_lines(r):
        print(f"tools | time_chunk S={STREAMS} x {r['frames']} frames, 2 reps: {line}")
    for engine, v in r["engines"].items():
        check_ates(f"time_chunk {engine}", v["ate_per_stream_m"])
        check(v["reps_bit_equal"], f"time_chunk {engine}: the two reps differ")
    got = {k: n - before.get(k, 0) for k, n in _build.launches().items()}
    n_kf = 3 + (CHUNK + 2 * steps) // CADENCE  # each engine: a warm chunk and 2 timed runs, 3 starts
    for engine in ENGINES:
        want = _expected_launches(n_kf, CHUNK + 2 * steps)
        check(got[PATH_KERNEL[engine]] == want,
              f"time_chunk: {PATH_KERNEL[engine]} launched {got[PATH_KERNEL[engine]]}, expected {want}")
    check(got["fast_nms"] == 2 * n_kf,  # both engines' keyframe steps, FAST
          f"time_chunk: fast_nms launched {got['fast_nms']}, expected {2 * n_kf}")
    for name, per_step in (("threefry", 1), ("ransac_pnp", 2)):  # both engines' steps
        want = 2 * per_step * (CHUNK + 2 * steps)
        check(got[name] == want, f"time_chunk: {name} launched {got[name]}, expected {want}")

    p = profile_chunk.profile(profile_chunk.parse_args(argv + ["--lk-engine", "fused"]),
                              seq=seq, frames=frames)
    print("\n".join(f"tools | profile_chunk | {line}" for line in profile_chunk.report(p, 12)))
    want = 2 * CHUNK + CHUNK // CADENCE
    seen = sum(x["count"] for x in p["by_kind"] if x["name"] == "lk_level_kernel")
    check(p["launches"] == {"klt_patches": 0, "klt_track": 0, "lk_level": want, "threefry": CHUNK,
                            "ransac_pnp": 2 * CHUNK, "fast_nms": CHUNK // CADENCE}
          and seen == want,
          f"profile_chunk: launches {p['launches']}, lk_level_kernel in the trace {seen}, "
          f"expected {want}")
    check(p["device_ms"] > 0 and 0 < p["busy_share"] <= 1,
          f"profile_chunk: device {p['device_ms']} ms, busy share {p['busy_share']}")

    klt = {}
    for engine in ENGINES:
        card, _ = klt_bench.bench(klt_bench.parse_args(["--device", "cuda", "--lk-engine", engine]))
        plain, _ = klt_bench.bench(klt_bench.parse_args(["--device", "cpu", "--lk-engine", engine,
                                                         "--reps", "1"]))
        print("\n".join(f"tools | klt_bench | {line}" for line in klt_bench.report(card)))
        for a, b in zip(card["calls"], plain["calls"]):
            print(f"tools | klt_bench {engine} {a['name']}: card survived {a['survived_pct']:.2f}%, "
                  f"median err {a['median_err_px']:.6f} px | CPU plain {b['survived_pct']:.2f}%, "
                  f"{b['median_err_px']:.6f} px")
            check(a["survived_pct"] == b["survived_pct"]
                  and abs(a["median_err_px"] - b["median_err_px"]) <= 1e-3,
                  f"klt_bench {engine} {a['name']}: card {a} against the CPU path {b}")
        klt[engine] = card
    mb = microbench.bench(microbench.parse_args(["--device", "cuda", "--reps", "3"]))
    print("tools | microbench (fused) | " + " | ".join(f"{x['name']} {x['ms']:.3f} ms"
                                                      for x in mb["stages"]))
    check(all(np.isfinite(x["ms"]) and x["ms"] > 0 for x in mb["stages"]),
          f"microbench: {mb['stages']}")
    sr = soak_ref.soak_ref(soak_ref.parse_args(["--frames", "25"]))
    print(f"tools | soak_ref 25 frames: ATE {sr['ate_m']} m ({sr['ate_pct_of_traveled']}% of "
          f"{sr['traveled_m']} m), {sr['fps']} frames/s, finite {sr['finite']}")
    check(sr["finite"] and np.isfinite(sr["ate_m"]), f"soak_ref: {sr}")
    counts = _build.launches()
    print(f"tools: {time.perf_counter() - t0:.1f} s | launches {counts}")
    return dict(counts=counts, selftest=selftest, profile=p, klt=klt, microbench=mb)


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
    the same seed on 13 frames of the sequence, bit-equal, and its eager
    steps (graph=False) against its captured ones, bit-equal. Then two gloo
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
    from svo_tpu_torch.ba.solver import solve_ba
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
        fleet = {}
        for graph in (None, False):
            multi = MultiStereoVO(cfg, cam, device="cuda", graph=graph)
            multi.start(frames[0][1][None], frames[0][2][None], seed=5)
            health = []
            for f in frames[1:n_ms]:
                multi.process(f[1][None], f[2][None])
                health.append(multi.fleet_health)
            fleet[graph] = (multi.trajectories(n_ms), np.stack(health))
        lone = StereoVO(cfg, cam, seed=5, device="cuda").run(frames[:n_ms])
        same = np.array_equal(fleet[None][0][0], lone.poses)
        eager_same = all(np.array_equal(a, b) for a, b in zip(fleet[None], fleet[False]))
        print(f"MultiStereoVO, world of one, {n_ms} frames 376x1241 against StereoVO(seed=5): "
              f"bit-equal {same} | fleet health {fleet[None][1][-1].tolist()} | its eager steps "
              f"(graph=False) against its captured ones: trajectories and fleet health of every "
              f"step bit-equal {eager_same}")
        check(same, "MultiStereoVO's stream differs from StereoVO with the same seed")
        check(np.array_equal(fleet[None][1][-1], lone.metrics[n_ms - 1]),
              "fleet_health of a world of one is not its stream's metrics row")
        check(eager_same, "MultiStereoVO(graph=False) differs from its captured run")
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


SCALING_FRONTEND_FRAMES = 31  # svo_tpu's frontend scaling worker's depth


def phase_scaling() -> dict:
    """The scaling harness (svo_tpu_torch/scaling_eff.py) on the card, each
    arm a set of fresh processes. The 2-stream frontend fleet at 31 frames
    (184x320, patches), both streams in one process
    (MultiStereoVO(n_streams=2)) against one a process: every rank's fleet
    health finite, the arms' trajectories bit-equal, stream s equal to
    StereoVO(seed=s) on the same frames in this process, and each process's
    klt_track launches by the launch rule (lk_level none). With 2 cards
    (placement `cards`, one NCCL rank a card) also the distributed BA at the
    sweep's first point (12 cameras x 4,096 points, ~41k observations, 20
    LM iterations, 2 timed reps), one process against two: the two ranks'
    costs bit-equal, the arms within 1e-3 relative (1 and 2 point blocks
    sum in another order). On one card (placement `shared`, gloo ranks on
    cuda:0) the BA half is left to phase_distributed, which holds two gloo
    ranks sharing the card against this process's NCCL solve bit for bit;
    scaling_eff --placement shared reads it in full. Returns the launches,
    by kernel."""
    from svo_tpu_torch import frontend_scaling_worker as fsw
    from svo_tpu_torch import scaling_eff
    from svo_tpu_torch.pipeline.odometry import StereoVO

    n_cards = torch.cuda.device_count()
    placement = "cards" if n_cards >= 2 else "shared"
    p = scaling_eff.plan("cuda", placement)
    print(f"scaling: {n_cards} card(s), placement {placement}: every arm {p['backend']}"
          + ("" if placement == "cards" else
             " on cuda:0 (exchange through host memory); the BA half is phase_distributed's"))
    t0 = time.perf_counter()
    point = None
    if placement == "cards":
        cams, pts, _ = scaling_eff.SWEEP[0]
        point, _ = scaling_eff.measure(cams, pts, reps=2, device="cuda", placement=placement)
        costs = point["final_cost_2proc"]
        rel = abs(costs[0] - point["final_cost_1proc"]) / point["final_cost_1proc"]
        print(f"scaling | BA {point['cams']} cams x {point['pts']} pts ({point['n_obs']} obs), "
              f"{scaling_eff.ITERS} LM iterations x 2 reps: T1 {point['t1_s']:.4f} s, T2 "
              f"{point['t2_s']:.4f} s, efficiency {point['efficiency']:.4f}, speedup "
              f"{point['speedup']:.4f}, LM iterations/s {point['lm_iters_per_s_1proc']:.2f} / "
              f"{point['lm_iters_per_s_2proc_effective']:.2f} (2 procs effective), comm overhead "
              f"{point['comm_overhead_ms_per_iter']:.3f} ms an iteration | final cost "
              f"{point['final_cost_1proc']!r} (1 proc), {costs} (2 procs), {rel:.2e} relative | "
              f"{time.perf_counter() - t0:.1f} s")
        check(costs[0] == costs[1], f"scaling BA: the two ranks' costs differ: {costs}")
        check(rel <= 1e-3, f"scaling BA: the arms differ by {rel:.2e} relative (bound 1e-3)")

    fe, fworkers, trajs = scaling_eff.measure_frontend(SCALING_FRONTEND_FRAMES, device="cuda",
                                                       placement=placement)
    print(f"scaling | frontend {fe['streams']} streams x {SCALING_FRONTEND_FRAMES} frames "
          f"({fe['steps']} timed steps): T1 {fe['t1_s']:.4f} s, T2 {fe['t2_s']:.4f} s, efficiency "
          f"{fe['efficiency']:.4f}, frames/s aggregate {fe['fps_aggregate_1proc']:.2f} (1 proc) / "
          f"{fe['fps_aggregate_2proc']:.2f} (2 procs) | trajectories bit-equal "
          f"{fe['trajectories_bit_equal']} | health finite {fe['health_finite']} | launches "
          f"{fe['launches']} | {time.perf_counter() - t0:.1f} s")
    check(fe["health_finite"], "scaling frontend: a fleet health row is not finite")
    check(fe["trajectories_bit_equal"], "scaling frontend: the arms' trajectories differ")
    for n, ws in fworkers.items():
        for w in ws:
            want = _expected_launches(sum(w["keyframes"]),
                                      len(w["keyframes"]) * (w["frames"] - 1))
            steps = len(w["keyframes"]) * (w["frames"] - 1)  # one draw a stream's step
            n_kf = sum(w["keyframes"])  # a stream's launch a keyframe step, FAST
            check(w["launches"] == {"klt_patches": 0, "klt_track": want, "lk_level": 0,
                                    "threefry": steps, "ransac_pnp": 2 * steps, "fast_nms": n_kf},
                  f"scaling frontend, {n}-process arm, rank {w['rank']}: launches "
                  f"{w['launches']}, expected {want} klt_track, {steps} threefry, "
                  f"{2 * steps} ransac_pnp and {n_kf} fast_nms")
    cfg, cam, lefts, rights = fsw.fleet(SCALING_FRONTEND_FRAMES)
    for s in range(fsw.STREAMS):
        lone = StereoVO(cfg, cam, seed=s, device="cuda").run(
            [(i, lefts[i][s], rights[i][s]) for i in range(SCALING_FRONTEND_FRAMES)])
        check(np.array_equal(trajs[s], lone.poses),
              f"scaling frontend: stream {s} differs from StereoVO(seed={s})")
    launches = {k: sum(a[k] for a in fe["launches"].values()) for k in fe["launches"]["1proc"]}
    print(f"scaling: {time.perf_counter() - t0:.1f} s | each stream equals StereoVO(seed=s) on "
          f"the card | launches {launches}")
    return dict(launches=launches, ba=point, frontend=fe)


def _state_diff(a, b) -> tuple[bool, float]:
    """Whether every leaf of two states is bit-equal, and the largest pose
    difference (m, translation) between their trajectories."""
    from svo_tpu_torch.pipeline.state import leaves

    same = all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    dt = (a.poses[..., :3, 3] - b.poses[..., :3, 3]).norm(dim=-1).max()
    return same, float(dt)


def phase_graph(frames, seq) -> dict:
    """svo_tpu's compiled chunk dispatch (jax.jit with the state donated;
    svo_tpu_torch/pipeline/graph.py): the cadenced chunk captured once as a
    CUDA graph and replayed, against the eager loop (graph=False) on the
    same inputs, at bench.py's configuration and full width (97 frames
    376x1241, chunk 12, cadence 6): one stream through StereoVO.run_chunked
    and 8 streams (even forward, odd reversed) through
    BatchedStereoVO.process_chunk, each KLT engine, and Config() (ORB) for
    one stream, fused. Each captured run's final state must equal the
    eager run's leaf for leaf, bit for bit (the same kernels in the same
    order), every kernel must be launched as often in both, and by the
    launch rule, and every ATE must stay under its limit. Returns the
    launches of the captured runs."""
    from svo_tpu_torch.eval.trajectory import ate_rmse
    from svo_tpu_torch.parallel.batched import BatchedStereoVO
    from svo_tpu_torch.pipeline.odometry import StereoVO

    staged = _stage_batched(frames, seq)

    def single(engine, graph, use_orb):
        cfg, cam = _config_and_camera(seq, use_orb=use_orb)
        vo = StereoVO(cfg, cam, chunk=CHUNK, kf_cadence=CADENCE, lk_engine=engine, graph=graph)
        res = vo.run_chunked(frames)
        ate = float(ate_rmse(res.poses, seq.gt_poses))
        limit = ORB_ATE_LIMIT_M["forward"] if use_orb else ATE_LIMIT_M
        check(np.isfinite(ate) and ate <= limit, f"graph {engine}: ATE {ate} m > {limit} m")
        return vo, [ate], int(res.kf_flags.sum())

    def batched(engine, graph, use_orb):
        bvo = BatchedStereoVO(staged.cfg, staged.cam, STREAMS, chunk=CHUNK, kf_cadence=CADENCE,
                              lk_engine=engine, graph=graph)
        bvo.start(staged.l0, staged.r0)
        for c in staged.chunks:
            bvo.process_chunk(*c)
        ates = _stream_ates(bvo.trajectories(staged.n_stepped + 1), staged)
        check(all(np.isfinite(a) and a <= ATE_LIMIT_M for a in ates),
              f"graph batched {engine}: per-stream ATE {ates}")
        return bvo, ates, int(bvo.state.kf_flags[0, : staged.n_stepped + 1].sum())

    out = {}
    cases = [(f"S=1 {e}", single, e, False) for e in ENGINES]
    cases += [(f"S={STREAMS} {e}", batched, e, False) for e in ENGINES]
    cases.append(("S=1 fused ORB", single, "fused", True))
    for tag, drive, engine, use_orb in cases:
        run = {}
        for graph in (False, None):
            _build.reset_counters()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng, ates, n_kf = drive(engine, graph, use_orb)
            torch.cuda.synchronize()
            run[graph] = dict(eng=eng, ates=ates, n_kf=n_kf, wall=time.perf_counter() - t0,
                              counts=_build.launches(), peak=torch.cuda.max_memory_allocated())
        eager, cap = run[False], run[None]
        step = cap["eng"]._chunk_step
        check(step.capture, f"graph {tag}: the default step was not captured")
        same, dt = _state_diff(cap["eng"].state, eager["eng"].state)
        print(f"graph {tag}: captured against the eager loop: every leaf bit-equal {same} | max "
              f"|pose diff| {dt:.3g} m | ATE {' '.join(f'{a:.4f}' for a in cap['ates'])} m | "
              f"launches {cap['counts']} (eager {eager['counts']}) | capture + instantiate "
              f"{step.capture_s[()]:.3f} s, launches a replay {step.launches_per_replay[()]} | "
              f"run wall "
              f"{cap['wall']:.2f} s (eager {eager['wall']:.2f} s) | peak device memory "
              f"{cap['peak'] / 2**20:.1f} MiB with the graph's pool (eager "
              f"{eager['peak'] / 2**20:.1f} MiB)", flush=True)
        check(same, f"graph {tag}: the captured run differs from the eager loop by {dt} m")
        check(cap["counts"] == eager["counts"],
              f"graph {tag}: launches {cap['counts']}, eager {eager['counts']}")
        _check_launches(f"graph {tag}", engine, cap["counts"], cap["n_kf"],
                        levels=_levels(use_orb))
        out[tag] = cap["counts"]
        del run, eager, cap, step
    return out


# the ATE these runs gave on the card before their frame steps were
# captured (the shipping path (b), the window BA's path), which the
# captured runs must give to the digit
EAGER_ATE_M = {"shipping (b)": 0.0904, "ba": 0.0384}


def phase_frame_graph(frames, seq) -> dict:
    """svo_tpu's jitted frame step (jax.jit with the state donated, its
    lax.conds inside; svo_tpu_torch/pipeline/graph.py::FrameGraph): one
    whole-frame graph per branch key (any stream keyframes, any runs the
    window BA), read once a frame, against the eager step (graph=False) on
    the same inputs, at bench.py's full width (97 frames 376x1241): (a) one
    stream, StereoVO.run frame by frame, each engine; (b) Config() (ORB),
    the dynamic rule inside chunks of 12, patches (the shipping path (b));
    (c) 8 streams (even forward, odd reversed), BatchedStereoVO.process
    frame by frame, fused; (d) ba.enabled at its defaults, one stream,
    fused: chunks of 12 at cadence 6 (one graph per BA schedule) and frame
    by frame. Each captured run's final state must equal the eager run's
    leaf for leaf, bit for bit, every kernel be launched as often in both
    and by the launch rule, every ATE stay under its limit (and equal to
    the digit what the same run gave eagerly, EAGER_ATE_M), the keys read
    be the same and one a frame step (one a chunk for (d)'s chunks), and
    the BA solve at the frames its rule gives. Returns the launches of the captured
    runs."""
    from svo_tpu_torch.config import BaParams
    from svo_tpu_torch.eval.trajectory import ate_rmse
    from svo_tpu_torch.parallel.batched import BatchedStereoVO
    from svo_tpu_torch.pipeline.odometry import StereoVO

    staged = _stage_batched(frames, seq)
    fast, cam = _config_and_camera(seq)
    orb, _ = _config_and_camera(seq, use_orb=True)
    ba = dataclasses.replace(fast, ba=BaParams(enabled=True))

    def single(engine, graph, cfg, chunk, cadence):
        vo = StereoVO(cfg, cam, chunk=chunk, kf_cadence=cadence, lk_engine=engine, graph=graph)
        res = vo.run_chunked(frames) if chunk else vo.run(frames)
        step = vo._chunk_step if cadence else vo._step
        return vo, step, [float(ate_rmse(res.poses, seq.gt_poses))], res.kf_flags[None]

    def batched(engine, graph, cfg, chunk, cadence):
        bvo = BatchedStereoVO(cfg, cam, STREAMS, lk_engine=engine, graph=graph)
        bvo.start(staged.l0, staged.r0)
        for lefts, rights in staged.chunks:
            for i in range(CHUNK):
                bvo.process(lefts[i], rights[i])
        n = staged.n_stepped + 1
        ates = _stream_ates(bvo.trajectories(n), staged)
        return bvo, bvo._step, ates, bvo.state.kf_flags[:, :n].cpu().numpy()

    cases = [(f"(a) S=1 {e} frame by frame", single, e, fast, 0, 0, None) for e in ENGINES]
    cases += [("(b) S=1 ORB dynamic chunks", single, "patches", orb, CHUNK, 0,
               EAGER_ATE_M["shipping (b)"]),
              (f"(c) S={STREAMS} fused frame by frame", batched, "fused", fast, 0, 0, None),
              ("(d) S=1 ba.enabled chunks", single, "fused", ba, CHUNK, CADENCE,
               EAGER_ATE_M["ba"]),
              ("(d) S=1 ba.enabled frame by frame", single, "fused", ba, 0, 0, None)]
    out = {}
    for tag, drive, engine, cfg, chunk, cadence, eager_ate in cases:
        run = {}
        for graph in (False, None):
            _build.reset_counters()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _recording_keys() as keys:
                eng, step, ates, kf = drive(engine, graph, cfg, chunk, cadence)
            torch.cuda.synchronize()
            run[graph] = dict(eng=eng, step=step, ates=ates, kf=kf, keys=keys,
                              wall=time.perf_counter() - t0, counts=_build.launches(),
                              peak=torch.cuda.max_memory_allocated())
        eager, cap = run[False], run[None]
        step = cap["step"]
        check(step.capture, f"frame graph {tag}: the default step was not captured")
        same, dt = _state_diff(cap["eng"].state, eager["eng"].state)
        n_kf = int(cap["kf"].any(axis=0).sum())  # steps where any stream keyframes, boot included
        reads = len(cap["keys"]) / (N_FRAMES - 1)  # 1 a frame step; 1 a chunk with a schedule
        limit = ORB_ATE_LIMIT_M["forward"] if cfg.use_orb else ATE_LIMIT_M
        line = (f"frame graph {tag}, {engine}: captured against the eager step: every leaf "
                f"bit-equal {same} | max |pose diff| {dt:.3g} m | ATE "
                f"{' '.join(f'{a:.4f}' for a in cap['ates'])} m (limit {limit:.4f}) | keyframe "
                f"steps {n_kf} | launches {cap['counts']} (eager {eager['counts']}) | graphs per "
                f"key {sorted(step.graphs)}, capture + instantiate s "
                f"{ {k: round(v, 3) for k, v in step.capture_s.items()} } | keys read "
                f"{reads:.4f} a frame step | run wall "
                f"{cap['wall']:.2f} s (eager {eager['wall']:.2f} s) | peak device memory "
                f"{cap['peak'] / 2**20:.1f} MiB with the graphs' pool (eager "
                f"{eager['peak'] / 2**20:.1f} MiB)")
        if cfg.ba.enabled:
            solved = _solved_frames(cap["keys"], bool(cadence))
            due = _ba_due(cap["kf"][0], cfg)
            line += f" | BA solves at frames {solved}, the rule gives {due}"
            check(solved == due and len(due) >= 1, f"frame graph {tag}: BA solves at {solved}, "
                                                   f"the rule gives {due}")
        print(line, flush=True)
        check(same, f"frame graph {tag}: the captured run differs from the eager step by {dt} m")
        check(cap["keys"] == eager["keys"], f"frame graph {tag}: the keys read differ")
        check(reads == (1 / CHUNK if cadence else 1.0),
              f"frame graph {tag}: {len(cap['keys'])} key reads in {N_FRAMES - 1} frame steps")
        check(cap["counts"] == eager["counts"],
              f"frame graph {tag}: launches {cap['counts']}, eager {eager['counts']}")
        _check_launches(f"frame graph {tag}", engine, cap["counts"], n_kf,
                        levels=_levels(cfg.use_orb))
        check(all(np.isfinite(a) and a <= limit for a in cap["ates"]),
              f"frame graph {tag}: ATE {cap['ates']} m > {limit} m")
        if eager_ate is not None:
            check(round(cap["ates"][0], 4) == eager_ate,
                  f"frame graph {tag}: ATE {cap['ates'][0]:.4f} m, eagerly {eager_ate} m")
        out[tag] = cap["counts"]
        del run, eager, cap, step
    return out


def _group_single(ctx) -> dict:
    """One stream's main paths: the small agreement runs, bench.py's path
    with each engine, the window BA, the shipping configuration through
    run_synthetic."""
    for engine in ENGINES:
        phase_small_agreement(engine)
    for engine in ENGINES:
        phase_small_agreement_batched(engine)
    ctx.done("small agreement runs")
    single, single_ates = phase_main_path(ctx.frames, ctx.seq)
    ctx.done("single-stream main path")
    phase_ba_main_path(ctx.frames, ctx.seq, single_ates["fused"])
    ctx.done("single-stream main path with the window BA")
    shipping = phase_shipping_main_path(ctx.frames, ctx.seq)
    ctx.done("shipping configuration (ORB) through run_synthetic")
    return {"launches_single_stream": [single[e] for e in ENGINES],
            "launches_shipping_orb": [shipping["a"]["counts"], shipping["b"]["counts"]]}


def _group_batched(ctx) -> dict:
    """The batched paths: the 8-stream main path, its ORB configuration,
    the refined arm and the BA throughput, the checkpoint; the ORB detector
    and the back-end against the CPU path; the recovery and the refinement
    sweep."""
    phase_orb_agreement(ctx.frames)
    ctx.done("ORB detector, card against CPU")
    phase_backend_agreement()
    ctx.done("back-end agreement")
    staged = _stage_batched(ctx.frames, ctx.seq)
    multi, batched_runs = phase_batched_main_path(ctx.seq, staged)
    ctx.done("batched main path")
    shipping_batched = phase_shipping_batched(staged)
    ctx.done("batched shipping configuration (ORB)")
    refined_bvo = phase_refined_main_path(staged, batched_runs["fused"])
    phase_ba_throughput(refined_bvo)
    ctx.done("refined batched main path and BA throughput")
    phase_refine_graph(refined_bvo)
    ctx.done("captured refiner against refine_global")
    del refined_bvo
    phase_checkpoint(staged)
    ctx.done("checkpoint and resume")
    del staged
    recovery = phase_recovery()
    ctx.done("aggressive recovery on live state")
    eval_ba_run = phase_eval_ba(ctx.frames, ctx.seq)
    ctx.done("refinement sweep over the finished trajectory")
    return {"launches_batched": [multi[e] for e in ENGINES],
            "launches_shipping_orb": [shipping_batched["counts"]],
            "launches_recovery": [recovery["counts"]],
            "launches_eval_ba": [eval_ba_run["counts"]]}


def _group_long(ctx) -> dict:
    """The long runs and the tables: the soak, the worlds suite, the fleet
    table and the EuRoC artifact."""
    soak = phase_soak()
    ctx.done("soak")
    worlds = phase_worlds()
    ctx.done("worlds suite")
    tables = phase_eval_tables()
    ctx.done("fleet table and EuRoC artifact")
    return {"launches_soak": [soak["counts"]], "launches_worlds": [worlds["counts"]],
            "launches_eval_tables": [tables["counts"]]}


def _group_graph(ctx) -> dict:
    """The captured chunk dispatch against the eager loop, then run_kitti
    on the fixture."""
    graph = phase_graph(ctx.frames, ctx.seq)
    ctx.done("captured chunk dispatch against the eager loop")
    phase_cli_fixture()
    ctx.done("run_kitti on the KITTI fixture")
    return {"launches_graph": list(graph.values())}


def _group_frames(ctx) -> dict:
    """The captured frame steps (the dynamic rule, the window BA) against
    the eager step, then the distributed paths."""
    frame_graph = phase_frame_graph(ctx.frames, ctx.seq)
    ctx.done("captured frame steps against the eager step")
    phase_distributed(ctx.frames, ctx.seq)
    ctx.done("distributed paths")
    return {"launches_frame_graph": list(frame_graph.values())}


def _group_tools(ctx) -> dict:
    """The developer tools and the scaling harness."""
    tools = phase_tools(ctx.frames, ctx.seq)
    ctx.done("developer tools")
    scaling = phase_scaling()
    ctx.done("scaling harness")
    return {"launches_tools": [tools["counts"]], "selftest": tools["selftest"],
            "scaling_launches": scaling["launches"]}


# The phases after the kernel checks, in worker processes that share the
# card, started together: the phases are host-bound (the card is busy for
# a small share of a frame step), so six run side by side in about the
# time of the longest. Each worker runs its phases in order, each phase
# with its own launch counts, and writes what the kernel line needs.
WORKER_GROUPS = {"single": _group_single, "batched": _group_batched,
                 "long": _group_long, "tools": _group_tools, "graph": _group_graph,
                 "frames": _group_frames}


def _marker(t_start: float, walls: dict):
    """done(phase): the phase's own wall on a line of its own, and the time
    since t_start (time.time()) so far."""
    last = [time.time()]

    def done(phase: str) -> None:
        now = time.time()
        walls[phase] = now - last[0]
        last[0] = now
        print(f"[{now - t_start:.0f} s] {phase} done | phase wall {walls[phase]:.1f} s",
              flush=True)

    return done


def worker(group: str, tmp: str, t_start: float) -> int:
    """One worker: the group's phases on the frames main() rendered, its
    result to tmp/<group>.json."""
    from svo_tpu_torch.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(n_frames=N_FRAMES, shape=SHAPE, fx=718.856)
    pairs = np.load(os.path.join(tmp, "frames.npy"))
    frames = [(i, pairs[i, 0], pairs[i, 1]) for i in range(N_FRAMES)]
    walls = {}
    ctx = SimpleNamespace(frames=frames, seq=seq, done=_marker(t_start, walls))
    out = WORKER_GROUPS[group](ctx)
    out["walls"] = walls
    with open(os.path.join(tmp, f"{group}.json"), "w") as f:
        json.dump(out, f)
    return 0


def run_workers(tmp: str, t_start: float) -> dict:
    """Starts every worker, prints each one's output when it ends, and
    returns their results by group. A worker that fails fails the run;
    every worker still running is then stopped, with the processes it
    started."""
    import signal
    import subprocess

    procs, results = {}, {}
    try:
        for group in WORKER_GROUPS:
            log = open(os.path.join(tmp, f"{group}.log"), "w")
            procs[group] = (subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker", group, tmp,
                 repr(t_start)],
                cwd=REPO, stdout=log, stderr=subprocess.STDOUT, start_new_session=True), log)
        while procs:
            for group, (proc, log) in list(procs.items()):
                if proc.poll() is None:
                    continue
                del procs[group]
                log.close()
                print(f"---- worker {group} exited {proc.returncode} at "
                      f"{time.time() - t_start:.0f} s; its output: ----")
                with open(log.name) as f:
                    sys.stdout.write(f.read())
                sys.stdout.flush()
                check(proc.returncode == 0, f"worker {group} failed (exit {proc.returncode})")
                with open(os.path.join(tmp, f"{group}.json")) as f:
                    results[group] = json.load(f)
            time.sleep(0.5)
    finally:
        for proc, log in procs.values():
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
            log.close()
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "needs a CUDA device", file=sys.stderr)
        return 1
    import tempfile

    from svo_tpu_torch.io.synthetic import SyntheticSequence

    t_start = time.time()
    walls = {}
    done = _marker(t_start, walls)
    name, smi = phase_device()
    phase_build()
    t0 = time.perf_counter()
    seq = SyntheticSequence(n_frames=N_FRAMES, shape=SHAPE, fx=718.856)
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:  # numpy frees the GIL
        frames = [(i, *lr) for i, lr in enumerate(pool.map(seq.frame, range(N_FRAMES)))]
    print(f"rendered {N_FRAMES} frames {SHAPE[0]}x{SHAPE[1]} in "
          f"{time.perf_counter() - t0:.1f} s")
    # the kernels' checks and times first, alone on the card
    frame = frames[0][1:]
    kern = phase_kernel(frame)
    lk = phase_lk_level(frame)
    done("single-stream kernels")
    batched = phase_batched_kernels(frames)
    track = phase_lk_track(frames)
    probes = phase_probe()
    done("batched kernels, whole-call launches and probes")
    rng = phase_rng()
    phase_batched_rng()
    done("threefry kernel and batched streams against single streams")
    pnp = phase_pnp(frames, seq)
    done("RANSAC-PnP kernel against its plain version")
    fst = phase_fast_nms(frames)
    done("FAST + NMS kernel against its plain version")
    kt = phase_klt_track(frames)
    done("the patches engine's tracker kernel against its plain version")
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "frames.npy"), np.stack([f[1:] for f in frames]))
        del frames
        results = run_workers(tmp, t_start)
    for group in WORKER_GROUPS:
        walls.update(results[group].pop("walls"))
    # the kernel launches of every run on each path
    runs = {}
    for key in ("launches_single_stream", "launches_batched", "launches_shipping_orb",
                "launches_soak", "launches_worlds", "launches_recovery", "launches_eval_ba",
                "launches_eval_tables", "launches_tools", "launches_graph",
                "launches_frame_graph"):
        runs[key] = [c for r in results.values() for c in r.get(key, ())]
    scaling_launches = results["tools"]["scaling_launches"]

    def path_launches(name: str, main: bool = True) -> dict:
        """launches_<path>: the kernel's launches on each path; a kernel of
        the main paths launched on each, one off them (main False) on none
        but the tools'."""
        per = {k: sum(c[name] for c in cs) for k, cs in runs.items()}
        per["launches_scaling"] = scaling_launches[name]
        if main:
            check(per["launches_single_stream"] > 0 and per["launches_batched"] > 0
                  and per["launches_shipping_orb"] > 0, f"{name} was not launched on a main path")
        else:
            check(all(n == 0 for k, n in per.items() if k != "launches_tools"),
                  f"{name} was launched on a main path: {per}")
        return per

    def row(name, source, replaces, rows, key, main=True):
        """One kernel's line: its numbers at the temporal level-0 shape of
        one stream, and of the 8-stream launch beside them."""
        r0 = next(r for r in rows["rows"] if r["kind"] == "temporal" and r["level"] == 0)
        b = batched[key]
        per = path_launches(name, main)
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(per.values()), **per,
            "max_abs_err": max(rows["max_abs_err"], batched[f"{name}_max_abs_err"]),
            "ms": r0["ms"], "plain_ms": r0["plain_ms"], "bound_ms": r0["bound_ms"],
            "bound_by": r0.get("bound_by", "bytes"), "library_ms": None,
            "batched_ms": b["ms"], "batched_singles_ms": b["ms_singles"],
            "batched_plain_ms": b["plain_ms"], "batched_bound_ms": b["bound_ms"],
        }

    # the whole temporal tracker call in one lk_level launch, beside the
    # chain of per-level launches it replaces on the main path
    lk_row = row("lk_level", "svo_tpu_torch/csrc/lk_level.cu", "svo_tpu/ops/lk_pallas.py:432",
                 lk, "lk_level_temporal")
    lk_row["max_abs_err"] = max(lk_row["max_abs_err"], track["max_abs_err"])
    for suffix, t in (("", track["temporal_1"]), ("_batched", track[f"temporal_{STREAMS}"]),
                      ("_worlds", track[f"temporal_{WORLD_STREAMS}"])):
        lk_row[f"track{suffix}_ms"] = t["ms"]
        lk_row[f"track_chain{suffix}_ms"] = t["chain_ms"]
        lk_row[f"track_plain{suffix}_ms"] = t["plain_ms"]
        lk_row[f"track_bound{suffix}_ms"] = t["bound_ms"]
        lk_row[f"track_device{suffix}_us"] = t["device_us"]

    # the extraction: off the main paths since klt_track, the self-test's
    kp_row = row("klt_patches", "svo_tpu_torch/csrc/klt_patches.cu", "svo_tpu/ops/klt_pallas.py:139",
                 kern, "klt_patches_temporal", main=False)
    kp_row["max_abs_err"] = max(kp_row["max_abs_err"], results["tools"]["selftest"])
    # the patches engine's tracker call: one launch a call on every patches
    # path; its times at the temporal call of one stream, 8 streams beside
    kt_per = path_launches("klt_track")
    k1, k8 = kt["rows"]["temporal_1"], kt["rows"][f"temporal_{STREAMS}"]
    kt_row = {
        "name": "klt_track", "route": "cuda", "source": "svo_tpu_torch/csrc/klt_track.cu",
        "replaces": "the patches engine's tracker call: svo_tpu/ops/klt_pallas.py:139's "
                    "extraction a level and ops/klt.py::_patch_level's tensor ops (plain jnp in "
                    "svo_tpu)",
        "launches": sum(kt_per.values()), **kt_per, "max_abs_err": kt["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None, "device_us": k1["device_us"],
        "batched_ms": k8["ms"], "batched_plain_ms": k8["plain_ms"],
        "batched_bound_ms": k8["bound_ms"], "batched_device_us": k8["device_us"],
        **{f"{kind}_{S}_device_us": kt["rows"][f"{kind}_{S}"]["device_us"]
           for kind in ("stereo", "fb") for S in (1, STREAMS)},
    }

    # the threefry kernel: one launch a frame step on every path, for one
    # stream or all; its times at one stream, the 8-stream launch beside them
    tf = path_launches("threefry")
    r1, r8 = rng["rows"][1], rng["rows"][STREAMS]
    tf_row = {
        "name": "threefry", "route": "cuda", "source": "svo_tpu_torch/csrc/threefry.cu",
        "replaces": "jax.random.split + jax.random.gumbel (svo_tpu/pipeline/frontend.py:317, "
                    "geometry/pnp.py:168); not a Pallas kernel",
        "launches": sum(tf.values()), **tf, "max_abs_err": rng["max_abs_err"],
        "ms": r1["ms"], "plain_ms": r1["plain_ms"], "bound_ms": r1["bound_ms"],
        "bound_by": r1["bound_by"], "library_ms": None,
        "device_us": r1["device_us"], "wall_ms": r1["wall_ms"],
        "batched_ms": r8["ms"], "batched_plain_ms": r8["plain_ms"],
        "batched_bound_ms": r8["bound_ms"], "batched_device_us": r8["device_us"],
        "batched_wall_ms": r8["wall_ms"],
    }
    # the PnP kernel: two launches a frame step on every path, for one
    # stream or all; its times at one stream, the 8-stream call beside them
    pp = path_launches("ransac_pnp")
    p1, p8 = pnp["rows"][1], pnp["rows"][STREAMS]
    pnp_row = {
        "name": "ransac_pnp", "route": "cuda", "source": "svo_tpu_torch/csrc/ransac_pnp.cu",
        "replaces": "svo_tpu/geometry/pnp.py::ransac_pnp (plain jnp); not a Pallas kernel",
        "launches": sum(pp.values()), **pp, "max_abs_err": pnp["max_abs_err"],
        "ms": p1["ms"], "plain_ms": p1["plain_ms"], "bound_ms": p1["bound_ms"],
        "bound_by": p1["bound_by"], "library_ms": None, "device_us": p1["device_us"],
        "batched_ms": p8["ms"], "batched_plain_ms": p8["plain_ms"],
        "batched_bound_ms": p8["bound_ms"], "batched_device_us": p8["device_us"],
    }
    # the FAST kernel: one launch a FAST keyframe step, one an ORB level a
    # keyframe step, on every path; its times at one stream, the 8-stream
    # call beside them
    fp = path_launches("fast_nms")
    f1, f8 = (fst["rows"][f"S={S} {SHAPE[0]}x{SHAPE[1]} masked"] for S in (1, STREAMS))
    f64 = fst["rows"][f"S=64 {SHAPE[0]}x{SHAPE[1]} masked"]
    fast_row = {
        "name": "fast_nms", "route": "cuda", "source": "svo_tpu_torch/csrc/fast_nms.cu",
        "replaces": "svo_tpu/ops/fast.py::fast_score + svo_tpu/ops/nms.py::nms3x3 (plain jnp); "
                    "not a Pallas kernel",
        "launches": sum(fp.values()), **fp, "max_abs_err": fst["max_abs_err"],
        "ms": f1["ms"], "plain_ms": f1["plain_ms"], "bound_ms": f1["bound_ms"],
        "bound_by": f1["bound_by"], "library_ms": None, "device_us": f1["device_us"],
        "batched_ms": f8["ms"], "batched_plain_ms": f8["plain_ms"],
        "batched_bound_ms": f8["bound_ms"], "batched_device_us": f8["device_us"],
        "fleet64_device_us": f64["device_us"], "fleet64_plain_ms": f64["plain_ms"],
        "fleet64_bound_ms": f64["bound_ms"],
    }
    total = time.time() - t_start
    print("phase walls (s): " + json.dumps({k: round(v, 1) for k, v in walls.items()}))
    print(f"chip_smoke: all phases passed in {total:.0f} s")
    print(smi)
    print(json.dumps({"kernels": [
        kp_row,
        kt_row,
        lk_row,
        tf_row,
        pnp_row,
        fast_row,
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
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker(sys.argv[2], sys.argv[3], float(sys.argv[4])))
    sys.exit(main())
