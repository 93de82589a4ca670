"""One process of the multi-process distributed BA check.

    python3 -m svo_tpu_torch.multihost_ba_worker --rank R --nprocs 2 \
        --port PORT --backend gloo --device cpu --out mh_R.json

The counterpart of scripts/multihost_ba_worker.py. Every process builds the
same seeded problem (ba/synthetic.py: 6 cameras, 128 points), splits it
into 8 point blocks (parallel/ba.shard_problem) and owns 8/nprocs of
them; the process group spans all processes, so the
Schur-reduced camera system crosses the process boundary in every LM
iteration. Each process also solves the whole problem alone (solve_ba) and
all shards on a group of itself alone (the one-process sharded solve), and
reports whether its shards' cameras, points and costs equal that solve bit
for bit, and how far the sharded solve is from the single one (the bounds
of tests/test_dist_ba.py: cameras 5e-4, points 5e-2, cost 1e-3 relative).
It runs on the card unless --device cpu is given; --backend gloo lets
several processes share one card (the exchange then passes through host
memory, parallel/collective.py). --reps N also times N solves of each
kind. --arrays writes this process's results as .npz.
"""

from __future__ import annotations

import argparse
import json

SHARDS = 8        # point blocks over all processes (128 points: 16 each)
ITERATIONS = 12   # LM iterations, as scripts/multihost_ba_worker.py


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m svo_tpu_torch.multihost_ba_worker")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--nprocs", type=int, default=2)
    p.add_argument("--port", type=int, required=True,
                   help="a free localhost port, the same for every process")
    p.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--reps", type=int, default=0, help="timed solves of each kind")
    p.add_argument("--timeout", type=float, default=300.0, help="seconds to wait for the others")
    p.add_argument("--out", required=True, help="JSON report")
    p.add_argument("--arrays", default="", help="this process's results as .npz")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import numpy as np
    import torch
    import torch.distributed as dist

    from svo_tpu_torch._measure import per_second
    from svo_tpu_torch.ba import synthetic
    from svo_tpu_torch.ba.solver import BAProblem, solve_ba
    from svo_tpu_torch.parallel import ba as dist_ba
    from svo_tpu_torch.parallel import multihost
    from svo_tpu_torch.pipeline.odometry import resolve_device

    device = resolve_device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(2)  # the ranks share one host's cores
    multihost.init(f"localhost:{args.port}", args.nprocs, args.rank, args.backend, args.timeout)
    try:
        # one group of each process alone, made by every process in order
        alone = [dist.new_group([r]) for r in range(args.nprocs)][args.rank]
        problem = synthetic.ba_problem(42, n_cams=6, n_pts=128, noise_px=0.3)
        K = torch.tensor(synthetic.K_MAT, device=device)
        bfx = synthetic.FX * synthetic.BASELINE
        on_dev = BAProblem(*(x.to(device) for x in problem))
        sharded = dist_ba.shard_problem(problem, SHARDS)
        on_dev_sh = BAProblem(*(x.to(device) for x in sharded))

        def solve_single():
            return solve_ba(on_dev, K, bfx, iterations=ITERATIONS)

        def solve_alone():
            return dist_ba.solve_ba_distributed(on_dev_sh, K, bfx, group=alone, iterations=ITERATIONS)

        def solve_world():
            return multihost.solve_ba_multihost(sharded, K, bfx, SHARDS, device=device,
                                                iterations=ITERATIONS)

        single, ref, res = solve_single(), solve_alone(), solve_world()
        per = SHARDS // args.nprocs
        mine = slice(args.rank * per, (args.rank + 1) * per)
        bit_equal = all(torch.equal(a, b[mine]) for a, b in zip(res, ref))
        cpu = [x.cpu().numpy() for x in (single.T_cw, single.points, single.cost, res.T_cw,
                                           res.points, res.cost)]
        s_T, s_pts, s_cost, T, pts, cost = cpu
        report = {
            "rank": args.rank,
            "world": dist.get_world_size(),
            "backend": args.backend,
            "device": str(device),
            "exchange": "host" if args.backend == "gloo" and device.type == "cuda" else "direct",
            "n_local_shards": int(T.shape[0]),
            "bit_equal_to_one_process": bool(bit_equal),
            "cam_err_vs_single": float(np.abs(T - s_T[None]).max()),
            "point_err_vs_single": float(np.abs(pts - s_pts.reshape(SHARDS, -1, 3)[mine]).max()),
            "cost_dev_vs_single": float(np.abs(cost - s_cost).max()),
            "single_cost": float(s_cost),
            "n_obs": int(res.n_obs[0]),
        }
        report["ok"] = bool(
            bit_equal and report["cam_err_vs_single"] < 5e-4
            and report["point_err_vs_single"] < 5e-2
            and report["cost_dev_vs_single"] < 1e-3 * float(s_cost)
        )
        if args.reps:
            report["lm_iterations_per_s"] = {
                "single": per_second(solve_single, ITERATIONS, args.reps, device),
                "one_process_sharded": per_second(solve_alone, ITERATIONS, args.reps, device),
                "all_processes": per_second(solve_world, ITERATIONS, args.reps, device),
            }
        if args.arrays:
            np.savez(args.arrays, T_cw=T, points=pts, cost=cost)
        with open(args.out, "w") as f:
            json.dump(report, f)
        print(f"rank {args.rank}: ok={report['ok']} bit_equal={bit_equal} "
              f"cam_err={report['cam_err_vs_single']:.2e}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
