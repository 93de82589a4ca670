"""One process of the distributed-BA strong-scaling measurement
(svo_tpu_torch/scaling_eff.py).

    python3 -m svo_tpu_torch.scaling_worker --rank R --nprocs 2 --port PORT \
        --backend gloo --device cpu --out scale_R.json

The counterpart of scripts/scaling_worker.py. A FIXED global problem
(ba/synthetic.make_problem, seed 42, --cams x --pts, 0.4 px noise; the same
bytes on every process) is split into --nprocs point blocks
(parallel/ba.shard_problem), one a process, and each process times the same
distributed solve over its block: per LM iteration the only cross-process
traffic is the Schur-reduced camera system, all-gathered and folded in
block order (parallel/collective.py). One warm solve, then --reps solves
of --iters LM iterations each between two synchronisations of this
process's device; the JSON has svo_tpu's keys (rank, nprocs, wall_s,
lm_iters_per_s, iters, reps, cams, pts, n_obs, final_cost).

It runs on the card unless --device cpu is given; --device cuda:R names
the card (one card a process with --backend nccl, the default; several
processes may share one card with --backend gloo, whose exchange passes
through host memory on every call). On the CPU it runs one thread.
"""

from __future__ import annotations

import argparse
import json
import time


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m svo_tpu_torch.scaling_worker")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--nprocs", type=int, required=True)
    p.add_argument("--port", type=int, required=True,
                   help="a free localhost port, the same for every process")
    p.add_argument("--out", required=True, help="JSON report")
    p.add_argument("--cams", type=int, default=12)
    p.add_argument("--pts", type=int, default=4096)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--reps", type=int, default=6)
    p.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    p.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import numpy as np
    import torch
    import torch.distributed as dist

    from svo_tpu_torch.ba import synthetic
    from svo_tpu_torch.parallel import ba as dist_ba
    from svo_tpu_torch.parallel import multihost
    from svo_tpu_torch.pipeline.odometry import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)  # NCCL gathers on the current card
    else:
        torch.set_num_threads(1)  # one pinned core a process
    # the same problem on every process (same seed, same bytes), built
    # before the group forms and before the clock
    problem, _, _ = synthetic.make_problem(np.random.default_rng(42), n_cams=args.cams,
                                           n_pts=args.pts, noise_px=0.4)
    sharded = dist_ba.shard_problem(problem, args.nprocs)
    K = torch.tensor(synthetic.VGA_K_MAT, device=device)
    bfx = synthetic.VGA_FX * synthetic.VGA_BASELINE
    multihost.init(f"localhost:{args.port}", args.nprocs, args.rank, args.backend)
    try:
        local = multihost.put_sharded(sharded, args.nprocs, device=device)
        fn = dist_ba.solve_ba_on_mesh(K, bfx, multihost.global_mesh(), iterations=args.iters)

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        res = fn(local)  # warm
        sync()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            res = fn(local)
        sync()
        wall = time.perf_counter() - t0
        n_obs = int(problem.obs_valid.sum())
        out = {
            "rank": args.rank,
            "nprocs": args.nprocs,
            "wall_s": wall,
            "lm_iters_per_s": args.iters * args.reps / wall,
            "iters": args.iters,
            "reps": args.reps,
            "cams": args.cams,
            "pts": args.pts,
            "n_obs": n_obs,
            "final_cost": float(res.cost[0]),
            "backend": args.backend,
            "device": str(device),
        }
        with open(args.out, "w") as f:
            json.dump(out, f)
        print(f"rank {args.rank}/{args.nprocs} on {device}: {out['lm_iters_per_s']:.2f} LM it/s "
              f"({n_obs} obs)", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
