"""Readings the output check's limits are set from, on the card.

    python3 -m vobench.calibrate --workload kitti00-fast.fleet8 --seeds 101-112 \
        --control-seeds 101-103 --seconds 6 --out chiprun_out/cal.json

For each seed, one short run of the cell (the benchmark's own harness,
window and check) reads the numbers compared, the program against the
reference; for each control seed it also reads each control, the
reference computed one precision step below float32 (TF32; bfloat16) in
the program's place, against the same reference.
All in one process: the set-up that is paid once (imports, the CUDA
context, the kernels' library) is paid once. The benchmark's runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from vobench import harness, spec
from vobench.check import CONTROLS


def seed_list(text: str) -> list[int]:
    """"101-112" or "5,9,13" -> the seeds."""
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    controls = set(seed_list(args.control_seeds)) if args.control_seeds else set()
    rows = []
    for seed in seed_list(args.seeds):
        t0 = time.perf_counter()
        r = harness.run(cell, seed, args.seconds, False, args.device, control=seed in controls)
        row = {"seed": seed, "correct_as_limited": r["correct"], "failed": r["failed"],
               "attempted": r["attempted"],
               "program": r["_readings"],
               "control": r["_control"], "frames_per_s": r["metrics"]["frames_per_s"]["value"],
               "wall_s": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "rows": rows}
    for name in rows[0]["program"]:
        prog = [r["program"][name] for r in rows]
        summary[name] = {"program_max": max(prog), "program_sorted": sorted(prog)}
        for mode in CONTROLS:
            ctl = sorted(r["control"][mode][name] for r in rows if r["control"])
            summary[name][f"{mode}_min"] = ctl[0] if ctl else None
            summary[name][f"{mode}_sorted"] = ctl
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
