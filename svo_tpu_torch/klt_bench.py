"""KLT microbenchmark with live features on a textured image pair of known shift.

    python3 -m svo_tpu_torch.klt_bench [--reps 20] [--small] [--device cuda|cpu]
        [--lk-engine fused|patches] [--out F]

The counterpart of scripts/klt_bench.py. A smooth but textured 376x1241
image (--small: 184x320) and the same image shifted by (5, 2) px (x, y),
scaled by 0.99 and offset by 1.3, with N=256 live features (inputs(),
svo_tpu's draws from np.random.default_rng(0) in its order). It times the
pyramid build and KltTracker.track with the chosen engine at the three
parameter sets of the script (temporal 21x21 with 12 and with 8
iterations, stereo 11x11 with 12; 4 levels): the mean wall of --reps warm
calls between CUDA events (on the host clock with --device cpu). For each
set it prints the share of features that survived and the median error
of the survivors' flow against the known shift. It runs on the card
unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

N_FEATURES = 256
SHIFT = (5.0, 2.0)  # (x, y) px of the second image against the first


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m svo_tpu_torch.klt_bench")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--small", action="store_true", help="184x320 images (the CPU tests' size)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--lk-engine", default="fused", choices=("patches", "fused"))
    p.add_argument("--out", default="", help="write the result JSON here")
    return p.parse_args(argv)


def inputs(H: int, W: int, N: int = N_FEATURES):
    """(img0, img1, pos): the float32 pair, img1 = img0 moved by SHIFT, and
    (N, 2) positions (x, y) at least 40 px inside the image."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, (H // 4 + 1, W // 4 + 1)).astype(np.float32)
    img0 = np.kron(base, np.ones((4, 4), np.float32))[:H, :W]
    img0 += rng.uniform(-10, 10, (H, W)).astype(np.float32)
    for _ in range(2):
        img0 = 0.25 * (np.roll(img0, 1, 0) + np.roll(img0, -1, 0)
                       + np.roll(img0, 1, 1) + np.roll(img0, -1, 1))
    img1 = np.roll(img0, (int(SHIFT[1]), int(SHIFT[0])), (0, 1)) * 0.99 + 1.3
    pos = np.stack([rng.uniform(40, W - 40, N), rng.uniform(40, H - 40, N)], -1).astype(np.float32)
    return img0, img1, pos


def param_sets():
    """(name, KltParams) of the three call sites timed."""
    from svo_tpu_torch.config import KltParams

    return [
        ("temporal 21x21/12it", KltParams(window=21, max_level=3, max_iters=12)),
        ("temporal 21x21/8it", KltParams(window=21, max_level=3, max_iters=8)),
        ("stereo 11x11/12it", KltParams(window=11, max_level=3, max_iters=12)),
    ]


def accuracy(pos: np.ndarray, out_pos: np.ndarray, status: np.ndarray) -> tuple[float, float]:
    """(survived %, median px error of the survivors' flow against SHIFT)."""
    err = np.linalg.norm((out_pos - pos)[status] - np.array(SHIFT), axis=-1)
    return 100.0 * float(status.mean()), float(np.median(err)) if err.size else float("nan")


def bench(args: argparse.Namespace):
    """Returns (result dict, {set name: KltResult})."""
    import torch

    from svo_tpu_torch._measure import device_name, mean_ms
    from svo_tpu_torch.ops.klt import KltTracker
    from svo_tpu_torch.pipeline.odometry import resolve_device

    dev = resolve_device(args.device)
    H, W = (184, 320) if args.small else (376, 1241)
    img0, img1, pos = inputs(H, W)
    i0, i1 = torch.from_numpy(img0).to(dev), torch.from_numpy(img1).to(dev)
    p = torch.from_numpy(pos).to(dev)
    valid = torch.ones(len(pos), dtype=torch.bool, device=dev)
    p0, p1 = KltTracker.build_pyramid(i0, 3), KltTracker.build_pyramid(i1, 3)
    pyr_ms = mean_ms(lambda: KltTracker.build_pyramid(i0, 3), dev, args.reps)
    rows, outs = [], {}
    for name, prm in param_sets():
        def call(prm=prm):
            return KltTracker.track(p0, p1, p, valid, prm, engine=args.lk_engine)

        ms = mean_ms(call, dev, args.reps)
        out = outs[name] = call()
        survived, med = accuracy(pos, out.pos.cpu().numpy(), out.status.cpu().numpy())
        rows.append({"name": name, "window": prm.window, "max_iters": prm.max_iters, "ms": ms,
                     "survived_pct": survived, "median_err_px": med})
    result = {
        "metric": "klt_live_features",
        "image": f"{H}x{W}",
        "features": len(pos),
        "shift_px": list(SHIFT),
        "lk_engine": args.lk_engine,
        "reps": args.reps,
        "device": device_name(dev),
        "pyramid_ms": pyr_ms,
        "calls": rows,
    }
    return result, outs


def report(r: dict) -> list[str]:
    lines = [f"{'pyramid+grads':42s} {r['pyramid_ms']:8.3f} ms   ({r['image']}, "
             f"lk_engine={r['lk_engine']}, {r['device']})"]
    for x in r["calls"]:
        label = f"KLT {x['name']} ({r['features']} live feats)"
        lines.append(f"{label:42s} {x['ms']:8.3f} ms")
        lines.append(f"    survived {x['survived_pct']:.0f}%  median err {x['median_err_px']:.3f}px")
    return lines


def main(argv=None) -> int:
    args = parse_args(argv)
    result, _ = bench(args)
    print("\n".join(report(result)))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
