"""Time the batched cadenced chunk step.

    python3 -m svo_tpu_torch.bench_batched [--streams 8] [--chunk 12] [--cadence 6]
        [--frames N] [--height 376] [--width 1241] [--small] [--device cuda|cpu]
        [--lk-engine fused|patches] [--out F]

The counterpart of scripts/bench_batched.py. S streams of one synthetic
sequence (even forward, odd reversed; --frames 0 means 1 + 4 x chunk) are
staged on the device in chunks (_staging.py). BatchedStereoVO runs a
warm-up bootstrap and one chunk, is started again, and then runs every
staged chunk between two synchronisations: that wall gives aggregate
frames/s (S x stepped frames / wall) and ms per chunk. It prints those and
the ATE of stream 0 (forward) and stream 1 (reversed), and adds each
stream's ATE, the card's name and power limit and the peak device memory
of the timed run (staged chunks included) to the result. The reversed
stream is scored against the reversed ground truth's first frames
(svo_tpu's script reverses the first frames instead, which is the same
only when the frames fill whole chunks). It runs on the card unless
--device cpu is given.
"""

from __future__ import annotations

import argparse
import json
import time

from svo_tpu_torch import _staging


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m svo_tpu_torch.bench_batched")
    _staging.add_args(p, frames=0, frames_help="0 -> 1 + 4 x chunk")
    p.add_argument("--height", type=int, default=376)
    p.add_argument("--width", type=int, default=1241)
    p.add_argument("--lk-engine", default="fused", choices=("patches", "fused"))
    p.add_argument("--out", default="", help="write the result JSON here")
    args = p.parse_args(argv)
    args.frames = args.frames or 1 + 4 * args.chunk
    return args


def bench(args: argparse.Namespace, seq=None, frames=None):
    """The timed run; returns (result dict, the engine after it). A
    sequence and its rendered frames may be given (_staging.stage)."""
    import torch

    from svo_tpu_torch._measure import device_name
    from svo_tpu_torch.parallel.batched import BatchedStereoVO

    shape, fx = _staging.shape_and_fx(args) if args.small else ((args.height, args.width), 718.856)
    st = _staging.stage(args, shape, fx, seq=seq, frames=frames)
    S, CH = args.streams, args.chunk
    bvo = BatchedStereoVO(st.cfg, st.camera, S, chunk=CH, kf_cadence=args.cadence,
                          device=args.device, lk_engine=args.lk_engine)
    dev = bvo.device
    bvo.start(st.l0, st.r0)
    bvo.process_chunk(*st.chunks[0])  # warm-up
    _staging.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    bvo.start(st.l0, st.r0)
    _staging.sync(dev)
    t0 = time.perf_counter()
    for c in st.chunks:
        bvo.process_chunk(*c)
    _staging.sync(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    n_chunks = len(st.chunks)
    ates = _staging.stream_ates(bvo.trajectories(st.n_frames), st.gts)
    result = {
        "metric": "batched_chunk_throughput",
        "streams": S,
        "chunk": CH,
        "kf_cadence": args.cadence,
        "chunks": n_chunks,
        "frames": st.n_frames,
        "image": f"{shape[0]}x{shape[1]}",
        "lk_engine": args.lk_engine,
        "device": device_name(dev),
        "wall_s": wall,
        "aggregate_fps": S * n_chunks * CH / wall,
        "ms_per_chunk": 1e3 * wall / n_chunks,
        "ate_fwd_m": ates[0],
        "ate_rev_m": ates[1] if S > 1 else None,
        "ate_per_stream_m": ates,
        "peak_memory_bytes": peak,
    }
    return result, bvo


def summary_line(r: dict) -> str:
    rev = f"{r['ate_rev_m']:.4f}" if r["ate_rev_m"] is not None else "nan"
    peak = (f"{r['peak_memory_bytes'] / 2**20:.1f} MiB" if r["peak_memory_bytes"] is not None
            else "not measured")
    return (f"aggregate {r['aggregate_fps']:8.1f} frames/s | per-chunk {r['ms_per_chunk']:7.2f} ms | "
            f"S={r['streams']} chunk={r['chunk']} cadence={r['kf_cadence']} | ate_fwd "
            f"{r['ate_fwd_m']:.4f} m ate_rev {rev} m | lk_engine={r['lk_engine']} | peak device "
            f"memory {peak} | {r['device']}")


def main(argv=None) -> int:
    args = parse_args(argv)
    result, _ = bench(args)
    print(summary_line(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
