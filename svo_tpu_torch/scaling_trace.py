"""Where an LM iteration of the distributed BA spends its time in each arm
of the strong-scaling split (scaling_eff.py), on one device.

    python3 -m svo_tpu_torch.scaling_trace [--pts 16384|32768] [--device cuda|cpu] [--out F]

scaling_eff.py times one process solving the whole problem against two
processes each solving one point block of it. Between its exchanges a
rank's work is the solve over its own block, so this tool runs, in one
process (a world of one), the solve scaling_worker.py runs, over three
problems: the whole (shard_problem(problem, 1), the 1-process arm) and
block 0 and block 1 of shard_problem(problem, 2) (each rank's share of the
2-process arm; alone, a block's camera system holds only its own terms,
which changes the numbers but not the shapes or the work). The problem is
scaling_worker's: make_problem(seed 42, 16 cameras x --pts, 0.4 px), 20
LM iterations a solve (scaling_eff.SWEEP's two larger sizes and ITERS).

Per arm: the wall of an LM iteration over 3 solves between two
synchronisations, in two rounds over the arms (the second is the
reading); one solve under torch.profiler: device ms per LM
iteration, by kernel kind (profile_chunk.kind) and by kernel; and the key
tables the solver sums by (ops/index.segment_sum): their rows, the padding
rows among them (obs_valid false, keys camera 0 and point 0) and the
longest run of each table (cameras, points, camera-point pairs). With
--device cpu the device is the CPU and its table is the ops' self CPU time.
"""

from __future__ import annotations

import argparse
import json
import socket
import sys
import time

import numpy as np


TOP = 8  # kernels and kinds kept per arm


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m svo_tpu_torch.scaling_trace")
    p.add_argument("--pts", type=int, default=16384, choices=(16384, 32768))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--out", default="", help="write the result JSON here")
    return p.parse_args(argv)


def key_runs(problem) -> dict:
    """Rows, padding rows and the longest run of each key table of a
    one-block problem, as the solver builds them (clamped keys, padding
    rows included)."""
    cam = problem.obs_cam[0].long().numpy()
    pnt = problem.obs_pnt[0].long().numpy()
    n_pts = problem.points.shape[-2]
    longest = {name: int(np.bincount(keys).max())
               for name, keys in (("camera", cam), ("point", pnt), ("camera_point", cam * n_pts + pnt))}
    valid = problem.obs_valid[0].numpy()
    return {"rows": int(cam.size), "padding_rows": int((~valid).sum()), "longest_run": longest}


def trace(cams: int = 16, pts: int = 16384, iters: int = 20, reps: int = 3,
          device: str = "cuda") -> dict:
    """The three arms' readings on cams x pts (see the module docstring)."""
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from svo_tpu_torch._measure import device_name
    from svo_tpu_torch.ba import synthetic
    from svo_tpu_torch.parallel import ba as dist_ba
    from svo_tpu_torch.parallel import multihost
    from svo_tpu_torch.pipeline.odometry import resolve_device
    from svo_tpu_torch.profile_chunk import kind, table

    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    problem, _, _ = synthetic.make_problem(np.random.default_rng(42), n_cams=cams, n_pts=pts,
                                           noise_px=0.4)
    halves = dist_ba.shard_problem(problem, 2)
    arms = {"whole": dist_ba.shard_problem(problem, 1),
            **{f"block_{b}_of_2": type(halves)(*(x[b:b + 1] for x in halves)) for b in (0, 1)}}
    K = torch.tensor(synthetic.VGA_K_MAT, device=device)
    bfx = synthetic.VGA_FX * synthetic.VGA_BASELINE
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    multihost.init(f"localhost:{port}", 1, 0, "nccl" if device.type == "cuda" else "gloo")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = {"metric": "ba_lm_iteration_trace", "cams": cams, "pts": pts,
           "n_obs": int(problem.obs_valid.sum()), "iters": iters, "reps": reps,
           "device": device_name(device), "arms": {}}
    try:
        fn = dist_ba.solve_ba_on_mesh(K, bfx, multihost.global_mesh(), iterations=iters)
        local = {name: multihost.put_sharded(arm, 1, device=device) for name, arm in arms.items()}
        walls = {name: [] for name in arms}
        for _ in range(2):  # two rounds over the arms, so no arm is only ever first
            for name in arms:
                fn(local[name])  # warm
                sync()
                t0 = time.perf_counter()
                for _ in range(reps):
                    res = fn(local[name])
                sync()
                walls[name].append((time.perf_counter() - t0) * 1e3 / (reps * iters))
        for name, arm in arms.items():
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
            with torch.profiler.profile(activities=acts) as prof:
                res = fn(local[name])
                sync()
            evs = prof.key_averages()
            want = DeviceType.CUDA if device.type == "cuda" else DeviceType.CPU
            timed = "self_device_time_total" if device.type == "cuda" else "self_cpu_time_total"
            acts_dev = [(e.key, getattr(e, timed), e.count) for e in evs
                        if e.device_type == want and getattr(e, timed) > 0]
            if not acts_dev:
                raise RuntimeError(f"the profiler saw no device activity in arm {name}")
            per_it = [(k, us / iters, n / iters) for k, us, n in acts_dev]
            by_name = table(per_it)
            out["arms"][name] = {
                **key_runs(arm),
                "wall_ms_per_iter": walls[name][-1],
                "wall_ms_per_iter_rounds": walls[name],
                "device_ms_per_iter": sum(r["ms"] for r in by_name),
                "activities_per_iter": sum(r["count"] for r in by_name),
                "by_kind": table([(kind(k), us, n) for k, us, n in per_it])[:TOP],
                "by_name": by_name[:TOP],
                "final_cost": float(res.cost[0]),
            }
    finally:
        dist.destroy_process_group()
    whole = out["arms"]["whole"]
    halves_max = [max(out["arms"][f"block_{b}_of_2"][k] for b in (0, 1))
                  for k in ("wall_ms_per_iter", "device_ms_per_iter")]
    out["wall_ratio_whole_to_block"] = whole["wall_ms_per_iter"] / halves_max[0]
    out["device_ratio_whole_to_block"] = whole["device_ms_per_iter"] / halves_max[1]
    return out


def report(r: dict) -> list[str]:
    lines = [f"BA {r['cams']} cams x {r['pts']} pts ({r['n_obs']} obs), {r['iters']} LM iterations "
             f"a solve, on {r['device']}"]
    for name, a in r["arms"].items():
        lines.append(
            f"{name}: {a['rows']} rows ({a['padding_rows']} padding), longest runs "
            f"{a['longest_run']} | wall {a['wall_ms_per_iter']:.4f} ms, device "
            f"{a['device_ms_per_iter']:.4f} ms, {a['activities_per_iter']:.1f} activities an "
            f"LM iteration")
        for row in a["by_kind"]:
            lines.append(f"    {row['ms']:10.4f} ms  {row['count']:7.1f}  {row['name']}")
    lines.append(f"whole / slower block: wall {r['wall_ratio_whole_to_block']:.4f}, device "
                 f"{r['device_ratio_whole_to_block']:.4f}")
    return lines


def main(argv=None) -> int:
    args = parse_args(argv)
    r = trace(pts=args.pts, device=args.device)
    print("\n".join(report(r)), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(r, f, indent=1)
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
