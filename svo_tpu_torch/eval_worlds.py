"""Multi-world robustness suite: eight synthetic worlds, forward and reversed.

    python3 -m svo_tpu_torch.eval_worlds [--frames 241] [--limit N] [--chunk 12]
        [--cadence 6] [--config default|anchored] [--refine-every N]
        [--worlds a,b] [--skip-ref] [--small] [--device cuda|cpu]
        [--lk-engine fused|patches] [--out F]

The counterpart of scripts/eval_worlds.py. The worlds vary texture scale,
geometry (narrow corridor, open box with turns, loop, atrium), speed and
rotation content; each runs forward and reversed. svo_tpu runs the
sequences one after the other; here all of them (2 per world) run as the
streams of one BatchedStereoVO (stream 2w forward, 2w+1 reversed),
rendered one chunk at a time in threads, with refine() between chunks
every --refine-every chunks. Each sweep's regime per stream is recorded:
a span whose mean initial cost per observation passes the refiner's
threshold (10) is refined aggressively, and whether that sweep was
accepted is noted. Unless --skip-ref, the reference-equivalent CPU pipeline
(eval/reference_cpu.py) runs each sequence on the same frames, frame by
frame as they are rendered, for the ref_ate_* columns.

The batched streams draw their PnP noise from one generator (ROADMAP C),
so a world's ATE is comparable with svo_tpu's WORLDS_r05.json in order of
magnitude, not to the digit. It runs on the card unless --device cpu is
given; --small renders 184x320 frames. --limit N runs the first N frames
of each --frames-long sequence: the loop, slalom and turns trajectories are
spread over the whole sequence, so a shorter --frames would make them
sharper, not shorter. The result is a JSON object with one row per world;
--out writes it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# name -> (world kind, trajectory kind, speed), svo_tpu's WORLDS
# (scripts/eval_worlds.py): the last two rows are its held-out set
WORLDS = {
    "corridor-base": ("corridor", "wobble", 0.3),
    "corridor-narrow-coarse": ("corridor-narrow", "wobble", 0.45),
    "box-turns": ("box", "turns", 0.3),
    "box-loop": ("box", "loop", 0.3),
    "box-fine-fast": ("box-fine", "turns", 0.6),
    "corridor-lowtex": ("corridor-lowtex", "wobble", 0.3),
    "atrium-slalom": ("atrium", "slalom", 0.4),
    "box-vfast": ("box", "wobble", 0.9),
}
HELD_OUT = {"atrium-slalom", "box-vfast"}
RECOVER_COST_PER_OBS = 10.0  # refine_global's aggressive-regime threshold


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m svo_tpu_torch.eval_worlds")
    p.add_argument("--frames", type=int, default=241, help="frames of each sequence")
    p.add_argument("--limit", type=int, default=0,
                   help="run only the first N frames of each sequence, forward or reversed "
                        "(0 = all); the worlds stay those of --frames")
    p.add_argument("--chunk", type=int, default=12)
    p.add_argument("--cadence", type=int, default=6)
    p.add_argument("--config", default="default", choices=["default", "anchored"],
                   help="pipeline config variant under test")
    p.add_argument("--refine-every", type=int, default=0,
                   help="global refinement every N chunks (0 = off)")
    p.add_argument("--skip-ref", action="store_true", help="no reference CPU pipeline")
    p.add_argument("--worlds", default="", help="comma-separated subset of the worlds")
    p.add_argument("--small", action="store_true", help="184x320 images")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--lk-engine", default="fused", choices=("patches", "fused"))
    p.add_argument("--out", default="", help="write the result JSON here")
    return p.parse_args(argv)


def _log(t_start: float, msg: str) -> None:
    print(f"[worlds +{time.perf_counter() - t_start:6.1f}s] {msg}", file=sys.stderr, flush=True)


def evaluate(args: argparse.Namespace):
    """Run the suite; returns (result dict, the batched engine)."""
    import torch

    from svo_tpu_torch.config import Config
    from svo_tpu_torch.eval.reference_cpu import ReferenceCpuPipeline
    from svo_tpu_torch.eval.trajectory import ate_rmse
    from svo_tpu_torch.geometry import camera as cam_mod
    from svo_tpu_torch.io.synthetic import SyntheticSequence
    from svo_tpu_torch.parallel.batched import BatchedStereoVO

    t_start = time.perf_counter()
    shape = (184, 320) if args.small else (376, 1241)
    fx = 200.0 if args.small else 718.856
    names = [w.strip() for w in args.worlds.split(",") if w.strip()] or list(WORLDS)
    F, CH = args.frames, args.chunk
    # the trajectory of a loop, a slalom or the turns is spread over the
    # whole sequence: a shorter run is a prefix of it, not a shorter world
    n = 1 + (((args.limit or F) - 1) // CH) * CH
    seqs = [
        SyntheticSequence(n_frames=F, shape=shape, fx=fx, speed=WORLDS[w][2],
                          world=WORLDS[w][0], traj=WORLDS[w][1], seed=7)
        for w in names
    ]
    S = 2 * len(seqs)
    cfg = Config(use_orb=False, image_height=shape[0], image_width=shape[1])
    if args.config == "anchored":
        cfg = dataclasses.replace(
            cfg, tracking=dataclasses.replace(cfg.tracking, anchored_klt=True)
        )
    # every world renders with the same intrinsics and baseline
    K = seqs[0].K
    camera = cam_mod.from_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], seqs[0].baseline)

    def frame_index(s, t):
        return t if s % 2 == 0 else F - 1 - t

    # a rendered frame is kept until every stream that runs it has read it:
    # the forward one at step i, the reversed one at step F-1-i (if < n)
    cache: dict = {}
    pool = ThreadPoolExecutor(min(8, os.cpu_count() or 1))  # numpy frees the GIL

    def render(ts):
        """(len(ts), S, H, W) uint8 lefts and rights of time steps ts."""
        keys = [(s // 2, frame_index(s, t)) for t in ts for s in range(S)]
        todo = sorted({k for k in keys if k not in cache})

        def one(k):
            l, r = seqs[k[0]].frame(k[1])
            return np.clip(l, 0, 255).astype(np.uint8), np.clip(r, 0, 255).astype(np.uint8)

        for k, lr in zip(todo, pool.map(one, todo)):
            cache[k] = [lr, 0]
        out = np.empty((2, len(ts), S) + shape, np.uint8)
        for i, k in enumerate(keys):
            entry = cache[k]
            out[0, i // S, i % S], out[1, i // S, i % S] = entry[0]
            entry[1] += 1
            if entry[1] == (k[1] < n) + (F - 1 - k[1] < n):
                del cache[k]
        return out[0], out[1]

    refs = [] if args.skip_ref else [
        ReferenceCpuPipeline(cfg, camera.K.numpy(), camera.P_left.numpy(), camera.P_right.numpy())
        for _ in range(S)
    ]
    ref_s = 0.0

    def feed_refs(ls, rs):
        nonlocal ref_s
        t0 = time.perf_counter()
        for i in range(ls.shape[0]):
            for s, ref in enumerate(refs):
                ref.process(ls[i, s], rs[i, s])
        ref_s += time.perf_counter() - t0

    bvo = BatchedStereoVO(cfg, camera, S, chunk=CH, kf_cadence=args.cadence,
                          device=args.device, lk_engine=args.lk_engine)
    if args.refine_every:
        bvo.make_refiner()

    def sync():
        if bvo.device.type == "cuda":
            torch.cuda.synchronize(bvo.device)

    l0, r0 = render([0])
    feed_refs(l0, r0)
    bvo.start(l0[0].astype(np.float32), r0[0].astype(np.float32))
    _log(t_start, f"{S} streams ({len(names)} worlds, forward and reversed), {n} frames, "
         f"{shape[0]}x{shape[1]}, {bvo.device}, lk_engine={args.lk_engine}")
    step_s = 0.0
    sweeps = []
    for c in range((n - 1) // CH):
        ls, rs = render(range(1 + c * CH, 1 + (c + 1) * CH))
        feed_refs(ls, rs)
        sync()
        t0 = time.perf_counter()
        bvo.process_chunk(ls, rs)
        if args.refine_every and (c + 1) % args.refine_every == 0:
            accepted = bvo.refine()
            per_obs = bvo.last_refine.cost_per_obs.cpu().numpy()
            sweeps.append((c, accepted, per_obs))
        sync()
        step_s += time.perf_counter() - t0
    pool.shutdown()
    trajs = bvo.trajectories(n)
    metrics = bvo.state.metrics[:, :n].cpu().numpy()
    _log(t_start, f"stepped {n - 1} frames x {S} streams in {step_s:.1f} s "
         f"({S * (n - 1) / step_s:.1f} frames/s aggregate)")

    rows, aggressive = [], []
    for w, (name, seq) in enumerate(zip(names, seqs)):
        gt = seq.gt_poses
        traveled = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())
        row = {"world": name, "kind": WORLDS[name][0], "traj": WORLDS[name][1],
               "speed": WORLDS[name][2], "frames": n, "sequence_frames": F,
               "traveled_m": round(traveled, 1),
               "held_out": name in HELD_OUT}
        for d, direction in enumerate(("fwd", "rev")):
            s = 2 * w + d
            gtd = (gt if d == 0 else gt[::-1])[:n]
            row[f"ate_{direction}_m"] = round(float(ate_rmse(trajs[s], gtd)), 4)
            row[f"finite_{direction}"] = bool(np.isfinite(trajs[s]).all())
            row[f"tracked_last_{direction}"] = int(metrics[s, n - 1, 0])
            row[f"inlier_ratio_last_{direction}"] = round(float(metrics[s, n - 1, 1]), 3)
            if refs:
                poses = np.stack(refs[s].poses)
                row[f"ref_ate_{direction}_m"] = round(float(ate_rmse(poses, gtd[:len(poses)])), 4)
            for c, accepted, per_obs in sweeps:
                if per_obs[s] > RECOVER_COST_PER_OBS:
                    aggressive.append({"world": name, "dir": direction, "chunk": c,
                                       "frame": 1 + (c + 1) * CH - 1,
                                       "cost_per_obs": float(per_obs[s]),
                                       "accepted": bool(accepted[s])})
        rows.append(row)
        _log(t_start, json.dumps(row))

    wins = sum(1 for r in rows for d in ("fwd", "rev")
               if f"ref_ate_{d}_m" in r and r[f"ate_{d}_m"] <= r[f"ref_ate_{d}_m"])
    total = sum(1 for r in rows for d in ("fwd", "rev") if f"ref_ate_{d}_m" in r)
    device = str(bvo.device)
    if bvo.device.type == "cuda":
        from svo_tpu_torch._measure import smi_line

        device = smi_line()
    result = {
        "metric": "multi_world_ate",
        "config": args.config,
        "refine_every": args.refine_every,
        "frames_per_world": n,
        "sequence_frames": F,
        "image": f"{shape[0]}x{shape[1]}",
        "streams": S,
        "lk_engine": args.lk_engine,
        "device": device,
        "port_wins": wins,
        "comparisons": total,
        "fps_aggregate_excl_render": S * (n - 1) / step_s,
        "ref_fps": S * n / ref_s if refs and ref_s else None,
        "refine": {
            "sweeps": len(sweeps),
            "accepted_per_stream": [int(sum(a[s] for _, a, _ in sweeps)) for s in range(S)],
            "aggressive": aggressive,
        } if args.refine_every else None,
        "steps": {"frames": n - 1, "keyframes": int(bvo.state.kf_flags[0, :n].sum())},
        "chunk": CH,
        "kf_cadence": args.cadence,
        "resolved_config": dataclasses.asdict(cfg),
        "worlds": rows,
    }
    return result, bvo


def main(argv=None) -> int:
    args = parse_args(argv)
    result, _ = evaluate(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in ("metric", "streams", "frames_per_world")}
                     | {r["world"]: [r["ate_fwd_m"], r["ate_rev_m"]] for r in result["worlds"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
