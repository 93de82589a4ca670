"""Profile one batched cadenced chunk: where the milliseconds of a lockstep
frame step go, on the device and on the host.

    python3 -m svo_tpu_torch.profile_chunk [--streams 8] [--chunk 12] [--cadence 6]
        [--frames 49] [--top 40] [--small] [--device cuda|cpu]
        [--lk-engine fused|patches] [--out F]

The counterpart of scripts/profile_chunk.py. S streams (even forward, odd
reversed) of one staged chunk (_staging.py) go through BatchedStereoVO:
one chunk to warm up, one timed chunk (wall between two
synchronisations), then one chunk under torch.profiler with CPU and CUDA
activities, the port's kernels' launches (_build.launches(), by csrc
stem) beside it. From the trace's device activities (kernels, fills, copies;
_measure.device_events reads the same records) it prints their count and
total device ms, device time and count by kernel name (top --top) and by
kind: a kernel's function name without its template arguments and
parameters (`void at::native::elementwise_kernel<...>(...)` is
`at::native::elementwise_kernel`), the counterpart of the script's op-kind
prefix. A step that is host-bound on the card needs its host side too, so
it also gives the traced chunk's wall, the device busy share (device ms
over that wall; the profiler slows the host, so also over the untraced
chunk's wall) and the host ops by self CPU time from the same trace.

On the card a trace with no device activity is an error. With --device
cpu the device is the CPU: its activities are the ops' self CPU times, so
the device and host tables read the same records.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

from svo_tpu_torch import _staging


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m svo_tpu_torch.profile_chunk")
    _staging.add_args(p, frames=49)
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--lk-engine", default="fused", choices=("patches", "fused"))
    p.add_argument("--out", default="", help="write the result JSON here")
    return p.parse_args(argv)


def kind(name: str) -> str:
    """A kernel's function name without its return type, namespaces'
    `(anonymous namespace)::`, template arguments and parameters
    (`void at::native::elementwise_kernel<128, 2, ...>(int, ...)` is
    `at::native::elementwise_kernel`); other activities (`Memcpy HtoD
    (Pageable -> Device)`) up to their first parenthesis."""
    name = name.replace("(anonymous namespace)::", "")
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif depth == 0:
            out.append(ch)
    head = "".join(out).split("(", 1)[0].strip()
    if " " in head and (head.startswith("void ") or "::" in head):
        return head.split()[-1]
    return head


def table(events) -> list[dict]:
    """Rows {name, ms, count} of the events, summed by name, longest first
    (ties by name)."""
    ms, count = defaultdict(float), defaultdict(int)
    for name, us, n in events:
        ms[name] += us / 1e3
        count[name] += n
    return sorted(({"name": k, "ms": ms[k], "count": count[k]} for k in ms),
                  key=lambda r: (-r["ms"], r["name"]))


def records(prof) -> tuple[list, list]:
    """(device, host) rows (name, us, 1) of a finished trace, read from its
    raw records: each device activity with its duration, each host op with
    its self time (its duration less its children's on the same thread),
    the times key_averages() gives, without the tree of every op that it
    builds first (tens of seconds for a traced chunk on the card). An op
    nested in the only call of an op of its own name counts as a call of its
    own, where key_averages() merges the two."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name

    device, host = [], defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if _filter_name(e.name()):
            continue
        is_async = e.is_async() or e.start_thread_id() != e.end_thread_id()
        if e.device_type() == DeviceType.CUDA:
            device.append((e.name(), 0.0 if is_async else e.duration_ns() / 1e3, 1))
        elif e.device_type() == DeviceType.CPU and not is_async:
            host[e.start_thread_id()].append(e)
    rows = []
    for evs in host.values():
        evs.sort(key=lambda e: (e.start_ns(), -e.end_ns()))
        stack = []  # [end_ns, row index] of the ops open at this start
        for e in evs:
            while stack and stack[-1][0] <= e.start_ns():
                stack.pop()
            dur = e.duration_ns() / 1e3
            if stack:
                parent = rows[stack[-1][1]]
                rows[stack[-1][1]] = (parent[0], parent[1] - dur, 1)
            rows.append((e.name(), dur, 1))
            stack.append([e.end_ns(), len(rows) - 1])
    return device, rows


def profile(args: argparse.Namespace, seq=None, frames=None) -> dict:
    """The warm, timed and traced chunks; returns the result dict. A
    sequence and its rendered frames may be given (_staging.stage)."""
    import torch
    from torch.profiler import ProfilerActivity

    from svo_tpu_torch import _build
    from svo_tpu_torch._measure import device_name
    from svo_tpu_torch.parallel.batched import BatchedStereoVO

    shape, fx = _staging.shape_and_fx(args)
    st = _staging.stage(args, shape, fx, n_chunks=1, seq=seq, frames=frames)
    S, CH = args.streams, args.chunk
    bvo = BatchedStereoVO(st.cfg, st.camera, S, chunk=CH, kf_cadence=args.cadence,
                          device=args.device, lk_engine=args.lk_engine)
    dev = bvo.device
    chunk = st.chunks[0]
    bvo.start(st.l0, st.r0)
    bvo.process_chunk(*chunk)  # warm-up
    _staging.sync(dev)
    t0 = time.perf_counter()
    bvo.process_chunk(*chunk)
    _staging.sync(dev)
    warm_ms = (time.perf_counter() - t0) * 1e3
    print(f"warm chunk: {warm_ms:.1f} ms ({warm_ms / CH:.1f} ms per {S}-stream step)",
          file=sys.stderr, flush=True)

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    before = _build.launches()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        bvo.process_chunk(*chunk)
        _staging.sync(dev)
        traced_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: n - before.get(k, 0) for k, n in _build.launches().items()}
    device, host = records(prof)
    host = [r for r in table(host) if r["ms"] > 0]
    if dev.type == "cuda":
        if not device:
            raise RuntimeError("the profiler saw no device activity in the traced chunk")
    else:
        device = [(r["name"], 1e3 * r["ms"], r["count"]) for r in host]
    by_name = table(device)
    by_kind = table([(kind(k), us, n) for k, us, n in device])
    device_ms = sum(r["ms"] for r in by_name)
    return {
        "metric": "chunk_profile",
        "streams": S,
        "chunk": CH,
        "kf_cadence": args.cadence,
        "image": f"{shape[0]}x{shape[1]}",
        "lk_engine": args.lk_engine,
        "device": device_name(dev),
        "warm_wall_ms": warm_ms,
        "traced_wall_ms": traced_ms,
        "device_activities": sum(r["count"] for r in by_name),
        "launches": launches,
        "device_ms": device_ms,
        "busy_share": device_ms / traced_ms,
        "busy_share_untraced": device_ms / warm_ms,
        "by_name": by_name,
        "by_kind": by_kind,
        "host_ops": host,
    }


def report(r: dict, top: int) -> list[str]:
    lines = [
        f"device activities: {r['device_activities']}, total {r['device_ms']:.3f} ms | traced "
        f"chunk wall {r['traced_wall_ms']:.1f} ms (untraced {r['warm_wall_ms']:.1f} ms) | device "
        f"busy share {r['busy_share']:.4f} ({r['busy_share_untraced']:.4f} of the untraced wall) | "
        f"kernel launches {r['launches']} | "
        f"S={r['streams']} chunk={r['chunk']} "
        f"lk_engine={r['lk_engine']} | {r['device']}",
        "-- by kind --",
    ]
    lines += [f"  {x['ms']:9.3f} ms x{x['count']:6d}  {x['name']}" for x in r["by_kind"][:18]]
    lines.append("-- top kernels --")
    lines += [f"  {x['ms']:9.3f} ms x{x['count']:6d}  {x['name'][:90]}" for x in r["by_name"][:top]]
    lines.append("-- top host ops by self CPU time --")
    lines += [f"  {x['ms']:9.3f} ms x{x['count']:6d}  {x['name'][:90]}"
              for x in r["host_ops"][:top]]
    return lines


def main(argv=None) -> int:
    args = parse_args(argv)
    result = profile(args)
    print("\n".join(report(result, args.top)))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
