"""Strong-scaling efficiency of the distributed BA and of the data-parallel
frontend, 1 process against 2: the measurement of BASELINE.json's
north-star target, ">= 80% scaling efficiency at 2 hosts".

    python3 -m svo_tpu_torch.scaling_eff --device cpu --out scaling_cpu.json
    python3 -m svo_tpu_torch.scaling_eff --placement shared --out scaling.json

The counterpart of scripts/scaling_eff.py, with the same method:
- the distributed BA (scaling_worker.py) on a FIXED global problem, for
  each size of SWEEP: T1 is the wall of one process solving it whole, T2
  the slowest rank's wall when 2 processes each solve one point block of
  it; efficiency = T1 / (2 * T2), the speedup over twice the resources;
  comm_overhead_ms_per_iter = max(T2 - T1/2, 0) per LM iteration;
- the frontend (frontend_scaling_worker.py): a fixed fleet of 2 VO
  streams, both in one process against one a process, efficiency as
  above on the timed steps.
Each process is pinned to its own core (taskset -c rank), so the reading
is the program's scaling, not the host's core count. The headline is the
largest problem.

Placement, recorded in the JSON (`placement`, `backend`, `cards`, `card`):
- `--device cpu` is svo_tpu's method: gloo, one pinned core and one torch
  thread a process; absolute rates are CPU rates.
- `--device cuda --placement cards` (the default): one NCCL rank a card
  (the 1-process frontend holds 2 cards, one a stream). It refuses, with a
  non-zero exit, on a machine with fewer than 2 cards.
- `--device cuda --placement shared`: every process a gloo rank on cuda:0
  (the 2-process arm's exchange passes through host memory on every
  call). It measures contention for one card, not scaling: `shared_card`
  is true and `met` is null.
Nothing falls back from one placement to another.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = 0.80
# Size sweep, svo_tpu's: the small point is a sliding-WINDOW BA problem
# (latency-sensitive, comm-dominated), the large points GLOBAL-map BA
# blocks, the workload multi-process partitioning exists for (a full KITTI
# sequence allocates ~50k+ points). The headline efficiency is the largest.
SWEEP = [(12, 4096, 6), (16, 16384, 4), (16, 32768, 3)]
ITERS = 20
FRONTEND_FRAMES = 31
HAVE_TASKSET = shutil.which("taskset") is not None
TIMEOUT_S = 1800


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m svo_tpu_torch.scaling_eff")
    p.add_argument("--out", default="", help="JSON result")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--placement", default="cards", choices=("cards", "shared"),
                   help="with --device cuda: one card a rank, or both ranks on cuda:0")
    return p.parse_args(argv)


def plan(device: str, placement: str) -> dict:
    """Where each arm runs: the backend of both arms and the number of
    cards. Raises RuntimeError where the machine cannot
    give the placement asked for."""
    if device == "cpu":
        return {"placement": "cpu", "backend": "gloo", "cards": 0}
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if placement == "cards":
        if n < 2:
            raise RuntimeError(
                f"--placement cards needs 2 CUDA cards, this machine has {n}; "
                f"--placement shared runs both ranks on one card (a contention reading)")
        return {"placement": "cards", "backend": "nccl", "cards": 2}
    if n < 1:
        raise RuntimeError("--device cuda needs a CUDA card; --device cpu is the CPU method")
    return {"placement": "shared", "backend": "gloo", "cards": 1}


def _device(p: dict, slot: int) -> str:
    """The device of slot `slot` (a rank of the 2-process arm, or a stream
    of the 1-process frontend)."""
    return {"cpu": "cpu", "cards": f"cuda:{slot}", "shared": "cuda:0"}[p["placement"]]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_config(module: str, nprocs: int, argv_of_rank, tmp: str) -> list[dict]:
    """Start `nprocs` processes of `python3 -m module`, rank r pinned to
    core r, each with argv_of_rank(r) plus the group's arguments and an
    --out under tmp; wait for all; return their reports in rank order."""
    port = _free_port()
    outs = [os.path.join(tmp, f"{module.rsplit('.', 1)[-1]}_{nprocs}_{r}.json")
            for r in range(nprocs)]
    logs = [os.path.join(tmp, f"{os.path.basename(o)}.log") for o in outs]
    procs = []
    try:
        for r in range(nprocs):
            cmd = [sys.executable, "-m", module, "--rank", str(r), "--nprocs", str(nprocs),
                   "--port", str(port), "--out", outs[r], *argv_of_rank(r)]
            if HAVE_TASKSET:
                cmd = ["taskset", "-c", str(r)] + cmd
            with open(logs[r], "w") as log:  # a file: a full pipe would stall a rank
                procs.append(subprocess.Popen(cmd, cwd=REPO, stdout=log,
                                              stderr=subprocess.STDOUT, text=True))
        for r, p in enumerate(procs):
            code = p.wait(timeout=TIMEOUT_S)
            with open(logs[r]) as log:
                text = log.read()
            if code != 0:
                raise RuntimeError(f"{module} rank {r} of {nprocs} exited {code}\n{text[-3000:]}")
            print(text, end="", file=sys.stderr, flush=True)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = []
    for o in outs:
        with open(o) as f:
            reports.append(json.load(f))
    return reports


def _arms(t1: float, ranks_2: list[dict]) -> dict:
    t2 = max(w["wall_s"] for w in ranks_2)
    return {"efficiency": t1 / t2 / 2.0, "speedup": t1 / t2, "t1_s": t1, "t2_s": t2}


def measure(cams: int, pts: int, reps: int, iters: int = ITERS, *, device: str = "cuda",
            placement: str = "cards") -> tuple[dict, dict]:
    """The distributed BA on cams x pts, 1 process against 2. Returns the
    sweep point (scripts/scaling_eff.py's keys, plus each arm's final cost)
    and the workers' reports by process count."""
    p = plan(device, placement)

    def argv(nprocs):
        def of_rank(r):
            return ["--cams", str(cams), "--pts", str(pts), "--iters", str(iters),
                    "--reps", str(reps), "--device", _device(p, r), "--backend", p["backend"]]
        return of_rank

    with tempfile.TemporaryDirectory() as tmp:
        workers = {n: run_config("svo_tpu_torch.scaling_worker", n, argv(n), tmp) for n in (1, 2)}
    r1 = workers[1][0]
    t1 = r1["wall_s"]
    point = {"cams": cams, "pts": pts, "n_obs": r1["n_obs"], **_arms(t1, workers[2])}
    n_it = r1["iters"] * r1["reps"]
    point["lm_iters_per_s_1proc"] = r1["lm_iters_per_s"]
    point["lm_iters_per_s_2proc_effective"] = n_it / point["t2_s"]
    # the fixed per-iteration cross-process cost implied by T2 - T1/2
    point["comm_overhead_ms_per_iter"] = max(point["t2_s"] - t1 / 2.0, 0.0) / n_it * 1e3
    point["final_cost_1proc"] = r1["final_cost"]
    point["final_cost_2proc"] = [w["final_cost"] for w in workers[2]]
    return point, workers


def measure_frontend(frames: int = FRONTEND_FRAMES, *, device: str = "cuda",
                     placement: str = "cards") -> tuple[dict, dict, np.ndarray]:
    """The 2-stream fleet, 1 process against 2. Returns
    scripts/scaling_eff.py's frontend keys, plus whether the two arms'
    trajectories are bit-equal and each arm's kernel launches; the
    workers' reports by process count; and the 1-process arm's
    trajectories, (2, frames, 4, 4)."""
    p = plan(device, placement)
    if device == "cuda":  # build the kernels once, before the pinned workers load them
        from svo_tpu_torch import _build

        _build.library_path()

    def argv(nprocs, tmp):
        def of_rank(r):
            dev = (",".join(_device(p, s) for s in range(2)) if nprocs == 1 else _device(p, r))
            return ["--frames", str(frames), "--device", dev, "--backend", p["backend"],
                    "--arrays", os.path.join(tmp, f"traj_{nprocs}_{r}.npz")]
        return of_rank

    with tempfile.TemporaryDirectory() as tmp:
        workers = {n: run_config("svo_tpu_torch.frontend_scaling_worker", n, argv(n, tmp), tmp)
                   for n in (1, 2)}
        trajs = [np.load(os.path.join(tmp, f"traj_{n}_{r}.npz"))["trajectories"]
                 for n in (1, 2) for r in range(n)]
    r1 = workers[1][0]
    res = {"streams": r1["streams"], "steps": r1["steps"], **_arms(r1["wall_s"], workers[2])}
    res["fps_aggregate_1proc"] = r1["frames_per_s_aggregate"]
    res["fps_aggregate_2proc"] = r1["streams"] * r1["steps"] / res["t2_s"]
    res["health_finite"] = all(w["health_finite"] for ws in workers.values() for w in ws)
    res["trajectories_bit_equal"] = all(np.array_equal(t, trajs[0]) for t in trajs[1:])
    res["launches"] = {f"{n}proc": {k: sum(w["launches"][k] for w in ws)
                                    for k in ws[0]["launches"]}
                       for n, ws in workers.items()}
    return res, workers, trajs[0]


def result(points: list[dict], frontend: dict, p: dict, card: str | None) -> dict:
    """scripts/scaling_eff.py's result from the sweep and the frontend, with
    the placement, its backends and the card's nvidia-smi line."""
    head = points[-1]
    shared = p["placement"] == "shared"
    met = None if shared else head["efficiency"] >= TARGET
    where = {
        "cpu": "1 pinned core and 1 torch thread per process (taskset), gloo over localhost; "
               "absolute rates are CPU rates",
        "cards": "1 card and 1 pinned core per process (taskset), NCCL; the 1-process "
                 "frontend holds 2 cards, one a stream",
        "shared": "every process a gloo rank on cuda:0 (the 2-process arm's exchange "
                  "through host memory), 1 pinned core per process (taskset); a reading of "
                  "contention for one card, not of scaling",
    }[p["placement"]]
    return {
        "metric": "distributed_ba_scaling_efficiency_2proc",
        "efficiency": head["efficiency"],
        "speedup": head["speedup"],
        "target": TARGET,
        "met": met,
        "scope": "offline/global-map BA (>= ~200k observations)",
        "met_at_scope": met,
        "online_window_note": (
            "window-sized problems (sweep[0]) are latency-bound at 2 processes and are "
            "served by one process instead"),
        "method": (
            "strong scaling of the distributed BA (point-block partitioning, per-LM-iteration "
            "all-gather of the Schur-reduced camera system folded in block order); fixed "
            f"global problem; {where}; efficiency = T1/(2*T2) with T2 = slowest rank; "
            "headline = largest (global-map-scale) problem, full size sweep in `sweep`"
            + ("" if HAVE_TASKSET else "; WARNING: taskset unavailable, unpinned")),
        "headline_problem": {k: head[k] for k in ("cams", "pts", "n_obs")},
        "sweep": points,
        "small_problem_note": (
            "the smallest sweep point (window-BA-sized, ~41k obs) is comm-dominated and is "
            "held to the target only as a reading (see sweep[0]); distributed BA pays off at "
            "global-map sizes, the workload it exists for"),
        "frontend": frontend | {
            "metric": "data_parallel_frontend_scaling_2proc",
            "method": (
                "strong scaling of parallel/multi_seq.py: fixed 2-stream fleet, 1 process "
                "(both streams) vs 2 processes (one stream each); per-step cross-process "
                f"traffic is one fleet-health row a stream; {where}"),
        },
        "placement": p["placement"],
        "backend": p["backend"],
        "cards": p["cards"],
        "shared_card": shared,
        "card": card,
        "host_cores": os.cpu_count(),
        "pinned": HAVE_TASKSET,
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        p = plan(args.device, args.placement)
    except RuntimeError as e:
        print(f"scaling_eff: {e}", file=sys.stderr)
        return 1
    card = None
    if args.device == "cuda":
        from svo_tpu_torch._measure import smi_line

        card = smi_line()
        print(card)
    print(f"placement {p['placement']}: backend {p['backend']}, {p['cards']} card(s)"
          + ("" if HAVE_TASKSET else "; WARNING: taskset unavailable, unpinned"), flush=True)
    points = []
    for cams, pts, reps in SWEEP:
        print(f"measuring cams={cams} pts={pts}...", file=sys.stderr, flush=True)
        point, _ = measure(cams, pts, reps, ITERS, device=args.device, placement=args.placement)
        points.append(point)
        print(f"  eff={point['efficiency']}", file=sys.stderr, flush=True)
    print("measuring data-parallel frontend 1 vs 2 procs...", file=sys.stderr, flush=True)
    frontend, _, _ = measure_frontend(FRONTEND_FRAMES, device=args.device, placement=args.placement)
    print(f"  frontend eff={frontend['efficiency']}", file=sys.stderr, flush=True)
    res = result(points, frontend, p, card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
        print(f"wrote {args.out}", file=sys.stderr)
    print(json.dumps({k: res[k] for k in ("metric", "efficiency", "speedup", "met", "placement")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
