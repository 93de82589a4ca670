"""Run one cell of BENCHMARK.json on the card and print its result.

    python3 -m vobench.run --workload kitti00-fast.fleet8 --seed 7 --seconds 30 --trace 0

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), device (and with --trace 1 breakdown), and last `checks`,
each number of the output check with its limit; the same numbers are the
last lines of standard error. Without a CUDA device, or with fewer than
the cell asks for, it prints no result and exits 2.
"""

from __future__ import annotations

import time

T_PROCESS0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout, so that
# only a cell's first run in a checkout builds (the port's nvcc library goes
# to build/svo_tpu_torch/ by itself)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "vobench" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "vobench" / "triton")
# one process with few threads: the card's host shares its cores, and a
# CPU thread pool spinning beside the frame loop only adds to the spread
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"


def render(result: dict) -> tuple[str, list[str]]:
    """The result line (JSON, `checks` last) and the check lines of a
    harness.run() result."""
    out = {k: v for k, v in result.items() if not k.startswith("_")}
    for c in out["checks"].values():
        if not math.isfinite(c["value"]):
            c["value"] = str(c["value"])  # JSON has no inf
    out["checks"] = out.pop("checks")
    lines = [f"check {name}: {c['value']!r} limit {c['limit']!r}"
             for name, c in out["checks"].items()]
    return json.dumps(out), lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from vobench import harness, spec

    torch.set_num_threads(1)

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"vobench: {args.workload} needs {cell.chips} CUDA device(s); this machine has "
              f"{n} (torch.cuda.is_available() is {torch.cuda.is_available()})",
              file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                         t_process0=T_PROCESS0)
    line, checks = render(result)
    for c in checks:
        print(c, file=sys.stderr)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
