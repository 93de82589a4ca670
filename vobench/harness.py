"""One run of one cell: set-up, the timed window, the output check, the
metrics, the result line.

run() takes the device as an argument so that the CPU tests can drive the
whole path at a small size (run.py, on the card, refuses to run without
one). Set-up is everything from process start to the window: imports, the
CUDA context, the kernels' library (built into build/ of the checkout at
the first run, loaded after), the frames rendered on the device, the
engine, and a warm-up that captures every graph the window replays.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from vobench import check, drivers, frames, spec, trace

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "svo_tpu")


def forbidden_loaded() -> list[str]:
    """Top-level modules of sys.modules that the run must not hold, compared
    by whole name (svo_tpu_torch is not svo_tpu)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def _log(msg: str) -> None:
    print(f"[vobench] {msg}", file=sys.stderr, flush=True)


def _port_config(config: dict):
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.geometry.camera import from_intrinsics

    cam = config["camera"]
    return (spec.with_overrides(Config(), config["pipeline"]),
            lambda device: from_intrinsics(cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                                           cam["baseline"], device=device))


def _reference(config: dict, traffic: dict, device, lk_engine: str):
    from vobench.reference.config import Config
    from vobench.reference.drive import Reference

    cam = config["camera"]
    fleet = traffic["kind"] == "fleet_chunk"
    return Reference(spec.with_overrides(Config(), config["pipeline"]),
                     (cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["baseline"]), device,
                     lk_engine, chunk=traffic["chunk"] if fleet else 0,
                     cadence=traffic["cadence"] if fleet else 0)


def _lk_launches(rows: np.ndarray, cfg, S: int) -> list:
    """Each lk_level launch of the profiled fleet slice as [slots, live,
    window, margin_x, margin_y, iterations, levels]: a frame's temporal call
    (live: the features valid on entry, the frame before's final count), its
    forward-backward call (live: at least the features it kept, n_tracked)
    and a keyframe's stereo call (live: at least the points it added).
    rows: (S, frames + 1, 5) metrics rows from the frame before the slice."""
    from svo_tpu_torch.ops.klt import _MY

    tk, sk = cfg.temporal_klt, cfg.stereo_klt
    slots, det = S * cfg.capacity.max_features, S * cfg.capacity.max_detections
    out = []
    for j in range(1, rows.shape[1]):
        prev, cur = rows[:, j - 1], rows[:, j]
        out.append([slots, int(prev[:, 2].sum()), tk.window, tk.margin_x, _MY, tk.max_iters,
                    tk.max_level + 1])
        if cfg.tracking.fb_check:
            out.append([slots, int(cur[:, 0].sum()), tk.window, tk.margin_x, _MY, 8, 1])
        if cur[:, 3].any():
            new = int(np.clip(cur[:, 4] - prev[:, 4], 0, None).sum())
            out.append([det, new, sk.window, sk.margin_x, _MY, sk.max_iters, sk.max_level + 1])
    return out


def run(cell: spec.Cell, seed: int, seconds: float, trace_on: bool, device="cuda",
        t_process0: float | None = None, log=_log, control: bool = False) -> dict:
    """The result of one run: the keys of the result line, and `checks`
    (each number compared with its limit) last. control=True also reads
    the control (vobench/calibrate.py; never in a benchmark run) into
    `control`."""
    t_process0 = time.perf_counter() if t_process0 is None else t_process0
    device = torch.device(device)
    seed = int(seed) % 2**63
    import svo_tpu_torch  # noqa: F401  (the port: TF32 off, cuSOLVER preferred)

    phases = [("imports", time.perf_counter())]

    cfg, make_camera = _port_config(cell.config)
    camera = make_camera(device)
    t = cell.traffic
    cam = cell.config["camera"]
    K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1.0]])
    seq = frames.make_sequence(seed, spec.n_frames(cell.config),
                               (cfg.image_height, cfg.image_width), K, cam["baseline"], device,
                               t["world"], t["trajectory"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    phases.append(("frames", time.perf_counter()))
    if t.get("kind") not in drivers.DRIVERS:
        raise ValueError(f"{cell.name}: traffic kind {t.get('kind')!r} is not one of "
                         f"{sorted(drivers.DRIVERS)}")
    drv = drivers.DRIVERS[t["kind"]](t, seq, seed, cfg, camera, device, cell.config["lk_engine"])
    phases.append(("engine", time.perf_counter()))
    drv.warm()
    if trace_on:
        drivers.warm_profiler(device)
    phases.append(("warm-up", time.perf_counter()))
    captured = drivers.captures(*drv.steps())
    setup_s = time.perf_counter() - t_process0
    marks = [t_process0] + [m for _, m in phases]
    log(f"set-up {setup_s:.3f} s (" + ", ".join(
        f"{name} {b - a:.3f}" for (name, _), a, b in zip(phases, marks, marks[1:]))
        + f" s); {captured} graphs captured")

    win = drv.window(seconds, trace_on)

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    in_window = drivers.captures(*drv.steps()) - captured
    if in_window:
        log(f"WARNING: {in_window} graph(s) captured inside the window")
    bad = forbidden_loaded()
    if bad:
        raise SystemExit(f"vobench: the run loaded {bad}; nothing it runs may import them")

    fps = win.frames / win.seconds
    metrics = {}
    for m in cell.end_to_end:
        if m["name"] == "frames_per_s":
            metrics["frames_per_s"] = {"value": fps, "unit": m["unit"]}
        elif m["name"] == "frame_latency_p95_ms":
            metrics[m["name"]] = {"value": float(np.percentile(win.latencies_ms, 95)),
                                  "unit": m["unit"]}
        elif m["name"] == "setup_s":
            metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
    log(f"window {win.seconds:.3f} s: {win.frames} frames, {win.passes} whole passes, "
        f"{fps:.4f} frames/s, {len(drv.units)} units kept for the check; passes ended at "
        + " ".join(f"{x:.3f}" for x in win.pass_end_s) + " s")
    if win.latencies_ms:
        lat, cls = np.asarray(win.latencies_ms), np.asarray(win.frame_class, bool).reshape(-1, 2)
        m = min(len(lat), len(cls))
        kf, ba = cls[:m, 0] & ~cls[:m, 1], cls[:m, 1]
        log(f"frames {m}: keyframes {int(kf.sum())} ({100 * kf.mean():.2f}%), BA {int(ba.sum())}"
            f" ({100 * ba.mean():.2f}%); latency p50/p90/p95/p99 ms "
            + "/".join(f"{np.percentile(lat, q):.3f}" for q in (50, 90, 95, 99))
            + (f"; medians track/kf/BA ms " + "/".join(
                f"{np.median(lat[:m][s]):.3f}" if s.any() else "-"
                for s in (~cls[:m, 0], kf, ba))))
        at = np.cumsum(lat) / 1e3  # a frame's end, in seconds of frame time
        log("median frame ms by 2 s of frame time: " + " ".join(
            f"{np.median(lat[(at > s) & (at <= s + 2)]):.2f}"
            for s in range(0, int(at[-1]), 2) if ((at > s) & (at <= s + 2)).any()))
        n = spec.n_frames(cell.config) - 1
        log("median frame ms / process() ms, by pass: " + " ".join(
            f"{np.median(win.latencies_ms[i:i + n]):.3f}/{np.median(win.host_ms[i:i + n]):.3f}"
            for i in range(0, len(win.latencies_ms), n)))
    if win.first_pass_poses is not None:
        gts = [seq.gt if s % 2 == 0 or not t.get("reverse_odd") else seq.gt[::-1]
               for s in range(t["streams"])]
        poses = win.first_pass_poses.reshape((-1,) + win.first_pass_poses.shape[-3:])
        ates = [check.ate_rmse(p, g) for p, g in zip(poses, gts)]
        log("ATE of the first pass, by stream (m): " + " ".join(f"{a:.4f}" for a in ates))

    rec = None
    if trace_on:
        rec = {"cell": cell.name, "kind": t["kind"], "streams": t["streams"],
               "sweep_ms": win.sweep_ms,
               "frames": [[ms, bool(c[0]), bool(c[1]), s, h] for ms, c, s, h in
                          zip(win.latencies_ms, win.frame_class, win.in_slice, win.host_ms)],
               "slice": None, "lk_launches": [],
               "window": {"seconds": win.seconds, "slice_s": win.slice_s}}
        if win.prof is not None:
            acts, spans = trace.collect(win.prof)
            t0, t1 = trace.slice_bounds(acts, [s for s in spans if s[0] == "slice"][0])
            rec["slice"] = {"t0": t0, "t1": t1, "activities": acts, "spans": spans,
                            "steps": win.slice_steps}
            if win.slice_metrics is not None and drv.lk_engine == "fused":
                rec["lk_launches"] = _lk_launches(win.slice_metrics, cfg, t["streams"])

    # the program's state goes before the reference runs: a process's peak
    # never falls, and the reference's own state would set it
    ref_engine = drv.lk_engine
    drv.free()
    del seq
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = _reference(cell.config, t, device, ref_engine)
    t0 = time.perf_counter()
    numbers, numbers_ctl = check.compare(ref, drv, drv.units, log, control)
    log(f"reference {time.perf_counter() - t0:.3f} s over {len(drv.units)} units")
    log("readings: " + ", ".join(f"{k} {v!r}" for k, v in numbers.items()))
    checks = {k: {"value": numbers[k], "limit": lim} for k, lim in cell.limits.items()}
    correct = (win.nonfinite == 0 and not in_window and bool(drv.units) and bool(checks)
               and all(c["limit"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))

    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": win.frames, "failed": win.nonfinite,
              "metrics": {}, "device": dev_info}
    if trace_on:
        result["metrics"] = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(rec)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        if rec["slice"] is not None:
            sl = rec["slice"]
            dev_info["busy_s"] = trace.busy_ns(sl["activities"], sl["t0"], sl["t1"]) / 1e9
            dev_info["window_s"] = (sl["t1"] - sl["t0"]) / 1e9
            result["breakdown"] = trace.breakdown(rec)
    else:
        result["metrics"] = metrics
    result["checks"] = checks
    # for the caller, never printed: the trace's record, every reading, the control's
    result["_record"], result["_readings"], result["_control"] = rec, numbers, numbers_ctl
    return result
