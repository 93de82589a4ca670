"""Time the cadenced chunk step precisely, rep after rep.

    python3 -m svo_tpu_torch.time_chunk [--streams 8] [--chunk 12] [--cadence 6]
        [--frames 49] [--reps 3] [--small] [--device cuda|cpu]
        [--lk-engine fused|patches|both] [--out F]

The counterpart of scripts/time_chunk.py. S streams (even forward, odd
reversed) are staged on the device in chunks (_staging.py); the engine is
warmed with a bootstrap and one chunk. Each rep restarts it with
BatchedStereoVO.start (which keys the state anew, so every rep draws
the same PnP noise and gives the same trajectories bit for bit) and times
the whole run, synchronised at both ends. It prints the best rep's time,
the aggregate frames/s and every stream's ATE. svo_tpu's script compares a
second engine variant through an environment switch of its TPU build;
here the variant is the KLT engine: --lk-engine both runs the two engines
in turns, rep by rep, within the one call, and prints each engine's times
and ATEs. It runs on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from svo_tpu_torch import _staging
from svo_tpu_torch.ops.klt import ENGINES


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m svo_tpu_torch.time_chunk")
    _staging.add_args(p, frames=49)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--lk-engine", default="fused", choices=ENGINES + ("both",),
                   help="the KLT engine, or both in turns")
    p.add_argument("--out", default="", help="write the result JSON here")
    return p.parse_args(argv)


def time_chunks(args: argparse.Namespace, seq=None, frames=None):
    """The reps; returns (result dict, {engine: [each rep's (S, n, 4, 4)
    trajectories]}). A sequence and its rendered frames may be given
    (_staging.stage)."""
    from svo_tpu_torch._measure import device_name
    from svo_tpu_torch.parallel.batched import BatchedStereoVO

    if args.reps < 1:
        raise ValueError(f"--reps must be >= 1, got {args.reps}")
    shape, fx = _staging.shape_and_fx(args)
    st = _staging.stage(args, shape, fx, seq=seq, frames=frames)
    S, CH = args.streams, args.chunk
    engines = ENGINES if args.lk_engine == "both" else (args.lk_engine,)
    bvos = {e: BatchedStereoVO(st.cfg, st.camera, S, chunk=CH, kf_cadence=args.cadence,
                               device=args.device, lk_engine=e) for e in engines}
    dev = next(iter(bvos.values())).device
    for bvo in bvos.values():
        bvo.start(st.l0, st.r0)
        bvo.process_chunk(*st.chunks[0])  # warm-up
    _staging.sync(dev)
    n_chunks = len(st.chunks)
    steps = n_chunks * CH
    times = {e: [] for e in engines}
    trajs = {e: [] for e in engines}
    for r in range(args.reps):
        for e, bvo in bvos.items():
            bvo.start(st.l0, st.r0)
            _staging.sync(dev)
            t0 = time.perf_counter()
            for c in st.chunks:
                bvo.process_chunk(*c)
            _staging.sync(dev)
            dt = time.perf_counter() - t0
            times[e].append(dt)
            trajs[e].append(bvo.trajectories(st.n_frames))
            print(f"rep {r} {e}: {dt * 1e3:.1f} ms for {n_chunks} chunks ({dt / steps * 1e3:.2f} "
                  f"ms/step, {S * steps / dt:.1f} fps agg)", file=sys.stderr, flush=True)
    per_engine = {}
    for e in engines:
        best = min(times[e])
        per_engine[e] = {
            "times_s": times[e],
            "best_s": best,
            "aggregate_fps": S * steps / best,
            "ms_per_step": 1e3 * best / steps,
            "ate_per_stream_m": _staging.stream_ates(trajs[e][-1], st.gts),
            "reps_bit_equal": all(np.array_equal(t, trajs[e][0]) for t in trajs[e][1:]),
        }
    result = {
        "metric": "chunk_step_time",
        "streams": S,
        "chunk": CH,
        "kf_cadence": args.cadence,
        "chunks": n_chunks,
        "frames": st.n_frames,
        "image": f"{shape[0]}x{shape[1]}",
        "reps": args.reps,
        "device": device_name(dev),
        "engines": per_engine,
    }
    return result, trajs


def summary_lines(r: dict) -> list[str]:
    return [
        f"{e}: best {v['best_s'] * 1e3:.1f} ms  agg_fps {v['aggregate_fps']:.1f}  ate "
        f"{[round(a, 4) for a in v['ate_per_stream_m']]}  reps bit-equal {v['reps_bit_equal']}"
        for e, v in r["engines"].items()
    ]


def main(argv=None) -> int:
    args = parse_args(argv)
    result, _ = time_chunks(args)
    for line in summary_lines(result):
        print(line)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
