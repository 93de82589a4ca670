"""Per-stage microbenchmarks: each pipeline stage timed in isolation.

    python3 -m svo_tpu_torch.microbench [--reps 10] [--small] [--device cuda|cpu]
        [--lk-engine fused|patches] [--out F]

The counterpart of scripts/microbench.py. On one 376x1241 pair of uniform
noise images (--small: 184x320) with N=256 features, points and pixels
drawn from np.random.default_rng(0) in the script's order, it gives the
warm, synchronised mean time of --reps calls (CUDA events; the host clock
with --device cpu) of: the pyramid and its gradients; KLT temporal (21x21)
and stereo (11x11), 12 iterations, 4 levels, with the chosen engine; the
FAST score map; detect with FAST and with ORB; triangulate_dlt and
triangulate_rectified; ransac_pnp with 128 hypotheses, its Gumbel noise
drawn on each call from PRNGKey(0) (ops/random.gumbel, as svo_tpu's
ransac_pnp draws from the key it is given); and the full
non-keyframe frame step (step_body with kf_mode="never", 5 reps) from
example_state after one step has moved it on. svo_tpu's script times that
step under the data-dependent rule, which on this state (an empty
feature table after a non-keyframe step) replenishes: a keyframe step
despite its label, so the port names the mode. The uniform noise images
are not a scene, so the KLT stages' status is no accuracy reading
(klt_bench.py has that). It runs on the card unless --device cpu is
given.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

N = 256


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m svo_tpu_torch.microbench")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--small", action="store_true", help="184x320 images (the CPU tests' size)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--lk-engine", default="fused", choices=("patches", "fused"))
    p.add_argument("--out", default="", help="write the result JSON here")
    return p.parse_args(argv)


def example_state(cfg, device=None):
    """The empty single-stream state of svo_tpu's __graft_entry__.py:38-60
    (_example_state): no features, an empty map, the pyramid of a zero
    image, frame 0 a keyframe, identity poses, PRNGKey(0)."""
    import torch

    from svo_tpu_torch.ops.klt import KltTracker
    from svo_tpu_torch.ops.random import prng_key
    from svo_tpu_torch.pipeline.state import FeatureSet, MapState, VoState

    H, W = cfg.image_height, cfg.image_width
    F = cfg.capacity.max_frames
    eye = torch.eye(4, dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return VoState(
        features=FeatureSet.empty(cfg.capacity.max_features, device),
        map=MapState.empty(cfg, device),
        prev_pyramid=KltTracker.build_pyramid(
            torch.zeros((H, W), dtype=torch.float32, device=device), cfg.temporal_klt.max_level),
        frame_id=torch.zeros((), **i32),
        prev_is_kf=torch.ones((), dtype=torch.bool, device=device),
        last_kf_id=torch.zeros((), **i32),
        pose=eye,
        rel_motion=eye.clone(),
        prior_ok=torch.zeros((), dtype=torch.bool, device=device),
        poses=eye.repeat(F, 1, 1),
        kf_flags=torch.zeros((F,), dtype=torch.bool, device=device),
        metrics=torch.zeros((F, 5), dtype=torch.float32, device=device),
        rng=prng_key(0, device),
    )


def bench(args: argparse.Namespace) -> dict:
    """The stages' times; returns the result dict."""
    import torch

    from svo_tpu_torch._measure import device_name, mean_ms
    from svo_tpu_torch.config import Config, KltParams, RansacParams
    from svo_tpu_torch.geometry import camera as cam_mod
    from svo_tpu_torch.geometry.pnp import ransac_pnp
    from svo_tpu_torch.geometry.triangulate import triangulate_dlt, triangulate_rectified
    from svo_tpu_torch.ops.detect import detect
    from svo_tpu_torch.ops.fast import fast_score
    from svo_tpu_torch.ops.klt import KltTracker
    from svo_tpu_torch.ops.random import gumbel, prng_key
    from svo_tpu_torch.pipeline import frontend
    from svo_tpu_torch.pipeline.odometry import resolve_device

    dev = resolve_device(args.device)
    H, W = (184, 320) if args.small else (376, 1241)
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    img = t(rng.uniform(0, 255, (H, W)))
    img2 = t(rng.uniform(0, 255, (H, W)))
    pos = t(np.stack([rng.uniform(30, W - 30, N), rng.uniform(30, H - 30, N)], -1))
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    camera = cam_mod.from_intrinsics(718.0, 718.0, W / 2, H / 2, 0.54, device=dev)
    Xw = t(np.stack([rng.uniform(-10, 10, N), rng.uniform(-3, 3, N), rng.uniform(5, 40, N)], -1))
    uv = t(rng.uniform(0, 300, (N, 2)))
    uv_r = uv - 10.0
    key = prng_key(0, dev)
    cfg = Config(use_orb=False)
    cfg_orb = Config(use_orb=True)
    tkl = KltParams(window=21, max_level=3, max_iters=12)
    skl = KltParams(window=11, max_level=3, max_iters=12)
    rp = RansacParams()
    pyr1 = KltTracker.build_pyramid(img, 3)
    pyr2 = KltTracker.build_pyramid(img2, 3)
    eng = args.lk_engine
    stages = [
        ("pyramid+grads (4 levels)", lambda: KltTracker.build_pyramid(img, 3)),
        (f"KLT temporal ({N} feats, 21x21, 12it)",
         lambda: KltTracker.track(pyr1, pyr2, pos, valid, tkl, engine=eng)),
        (f"KLT stereo ({N} feats, 11x11, 12it)",
         lambda: KltTracker.track(pyr1, pyr2, pos, valid, skl, engine=eng)),
        ("FAST score map", lambda: fast_score(img, 20.0)),
        ("FAST+NMS+suppress+bucket (detect)", lambda: detect(img, pos, valid, cfg)),
        ("ORB detect (8 levels)", lambda: detect(img, pos, valid, cfg_orb)),
        (f"triangulate DLT ({N})",
         lambda: triangulate_dlt(camera.P_left, camera.P_right, uv, uv_r)),
        (f"triangulate rectified ({N})",
         lambda: triangulate_rectified(camera.fx, camera.baseline, uv, uv_r, camera.K)),
        (f"RANSAC-PnP ({N} pts, {rp.num_hypotheses} hyp)",
         lambda: ransac_pnp(camera.K, Xw, uv, valid,
                            gumbel(key, (rp.num_hypotheses, N)), rp)),
    ]
    rows = [{"name": name, "ms": mean_ms(fn, dev, args.reps)} for name, fn in stages]

    cfg_full = Config(use_orb=False, image_height=H, image_width=W)

    def step(s, kf_mode):
        return frontend.step_body(s, img, img2, camera, cfg_full, kf_mode=kf_mode, lk_engine=eng)

    state = step(example_state(cfg_full, dev), "dynamic")
    rows.append({"name": "FULL STEP (non-KF path)",
                 "ms": mean_ms(lambda: step(state, "never"), dev, 5)})
    return {
        "metric": "stage_times",
        "image": f"{H}x{W}",
        "features": N,
        "lk_engine": eng,
        "reps": args.reps,
        "device": device_name(dev),
        "stages": rows,
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    result = bench(args)
    for x in result["stages"]:
        print(f"{x['name']:38s} {x['ms']:9.3f} ms")
    print(f"({result['image']}, lk_engine={result['lk_engine']}, {result['device']})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
