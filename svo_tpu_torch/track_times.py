"""Time the tracker layer on the card: one KLT call, either engine.

    python3 -m svo_tpu_torch.track_times            # this tree
    PYTHONPATH=<another tree> python3 svo_tpu_torch/track_times.py

The second form times another checkout's package with this same script
(it uses only KltTracker.track, build_pyramid, detect_fast and
extract_klt_patches), so two commits can be compared within one call on
one card, in turns. At the main path's shapes (376x1241, 4 levels, N=128
temporal features; one stream and 8 in lockstep) it prints, per engine:

- the wall of one KltTracker.track call (CUDA events around 10 calls,
  median of 15), the temporal call and the level-0 forward-backward call;
- the device activities one such call issues and their device time
  (torch.profiler over 5 calls);
- the wall of one extract_klt_patches call on the tracker's own corners.

Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch


def _load_measure():
    """_measure.py from beside this file, whichever tree the package under
    test comes from (it imports nothing of the package)."""
    spec = importlib.util.spec_from_file_location(
        "_svo_measure", Path(__file__).with_name("_measure.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    if not torch.cuda.is_available():
        print("track_times: needs a CUDA device", file=sys.stderr)
        return 1
    import svo_tpu_torch
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.io.synthetic import SyntheticSequence
    from svo_tpu_torch.ops import klt
    from svo_tpu_torch.ops.detect import detect_fast
    from svo_tpu_torch.ops.klt_patches import extract_klt_patches

    measure = _load_measure()

    def wall_ms(fn, inner: int = 10) -> float:
        return measure.median_ms(fn, reps=15, inner=inner)

    def activities(fn, n: int = 5) -> tuple[float, float]:
        """Device activities and device microseconds per call."""
        fn()
        dev = measure.device_events(lambda: [fn() for _ in range(n)])
        return sum(e.count for e in dev) / n, sum(e.self_device_time_total for e in dev) / n

    smi = measure.smi_line()
    print(f"{smi} | package {svo_tpu_torch.__file__}")
    shape = (376, 1241)
    cfg = Config(use_orb=False, image_height=shape[0], image_width=shape[1])
    seq = SyntheticSequence(n_frames=9, shape=shape, fx=718.856)
    frames = [seq.frame(i) for i in range(9)]
    params = cfg.temporal_klt
    fb = dataclasses.replace(params, max_level=0, max_iters=8)
    rows = []
    for S in (1, 8):
        pick = (lambda a: a[0]) if S == 1 else (lambda a: a)
        prev = pick(torch.from_numpy(np.stack([f[0] for f in frames[:S]])).cuda())
        curr = pick(torch.from_numpy(np.stack([f[0] for f in frames[1:S + 1]])).cuda())
        pyr_p = klt.KltTracker.build_pyramid(prev, params.max_level)
        pyr_c = klt.KltTracker.build_pyramid(curr, params.max_level)
        pos, _, valid = detect_fast(prev, 20.0, None, cfg)
        pos, valid = pos[..., :128, :].contiguous(), valid[..., :128].contiguous()
        for engine in ("patches", "fused"):
            def temporal():
                return klt.KltTracker.track(pyr_p, pyr_c, pos, valid, params, engine=engine)

            res = temporal()

            def fb_call():
                return klt.KltTracker.track(pyr_c, pyr_p, res.pos, res.status, fb,
                                            init_flow=pos - res.pos, engine=engine)

            for name, fn in (("temporal", temporal), ("fb", fb_call)):
                ms = wall_ms(fn)
                acts, dev_us = activities(fn)
                print(f"S={S} track {name:8s} engine={engine:7s}: wall {ms:.4f} ms | "
                      f"{acts:.0f} device activities, {dev_us:.1f} us device time a call | "
                      f"tracked {int(fn().status.sum())} of {int(valid.sum())}")
                rows.append(dict(S=S, call=name, engine=engine, wall_ms=ms,
                                 activities=acts, device_us=dev_us))
        H, W = pyr_p[0][0].shape[-2:]
        py, px = klt._level_rows(params.window, H), klt._patch_cols(params.window, params.margin_x)
        p_pad = pos + torch.tensor([klt._PAD_X, klt._PAD_Y], dtype=torch.float32).cuda()
        corners = klt._corners(p_pad, torch.zeros_like(pos), H, W, py, px,
                               params.window, params.margin_x)
        gx, gy = pyr_p[1][0]

        def extract():
            return extract_klt_patches(pyr_p[0][0], gx, gy, pyr_c[0][0], *corners, valid,
                                       py=py, px=px)

        ms = wall_ms(extract, inner=20)
        acts, dev_us = activities(extract)
        print(f"S={S} extract_klt_patches L0 N=128 {py}x{px}: wall {ms:.4f} ms | "
              f"{acts:.0f} device activities, {dev_us:.1f} us device time a call")
        rows.append(dict(S=S, call="extract", wall_ms=ms, activities=acts, device_us=dev_us))
    print(json.dumps({"device": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
