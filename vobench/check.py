"""The output check: each kept unit of the window worked out again by the
reference (vobench/reference), and what the program produced held against
it.

A unit (drivers.py) is the bootstrap and the first frames or chunk of a
stream set, worked out from the frames and seeds alone, or a stretch of
frames or chunks (a refine cell: two chunks and their sweep) from the
program's state before it. A unit of a live stream or of a fleet's chunks
can carry the window BA (Unit.has_ba, from the BA rule). The readings of a
unit (pose_gaps, state_gaps, sweep_gaps), each the worst over its streams
and frames and then over the kept units:

    pose_gap_m, rot_gap_deg  a pose of the unit, program against reference
    step_gap_m     the unit's first frame-to-frame motion: one step from
                   the same state
    rel_gap_med_m  a stream's median frame-to-frame motion gap over the unit
    rel_gap_med_med_m  the median over the kept units of a unit's
                   rel_gap_med_m (the one reading that is not the worst)
    rel_gap_max_m  the widest frame-to-frame motion gap
    ba_pose_gap_m  a unit in which a frame ran the window BA (live or a
                   fleet's chunk): any pose of any stream of the pass up
                   to the unit's end (the keyframes the BA rewrote before
                   the unit included)
    point_gap_m    a map point after the unit's frames
    sweep_gap_m, sweep_point_gap_m  a pose, a map point after the sweep,
                   both sides sweeping from the program's state before it

The numbers a cell compares, and their limits, are limits/<cell>.json;
the others are printed as readings. PERF.md gives the readings of the
program and of the controls (the reference one precision step below
float32 in the program's place) each limit was set from.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

NUMBERS = ("pose_gap_m", "rot_gap_deg", "step_gap_m", "rel_gap_med_m", "rel_gap_max_m",
           "ba_pose_gap_m", "point_gap_m", "sweep_gap_m", "sweep_point_gap_m")
CONTROLS = ("tf32", "bf16")


def _rot_deg(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Angle between rotations from the Frobenius norm of their difference,
    |Ra - Rb|_F = 2 sqrt(2) sin(theta / 2), which keeps its precision near
    zero (an arccos of the trace does not)."""
    d = np.linalg.norm(Ra - Rb, axis=(-2, -1))
    return 2 * np.degrees(np.arcsin(np.clip(d / (2 * math.sqrt(2)), 0, 1)))


def _point_gap(prog, ref) -> float:
    """The worst gap of a map point, over every slot either side has
    allocated; a slot non-finite on one side only reads inf."""
    n = int(max(prog.map.n_points.max(), ref.map.n_points.max()))
    p, r = (s.map.points[..., :n, :].double().cpu().numpy() for s in (prog, ref))
    both = ~np.isfinite(p).all(-1) & ~np.isfinite(r).all(-1)
    d = np.where(both, 0.0, np.linalg.norm(np.nan_to_num(p - r, nan=np.inf), axis=-1))
    return float(d.max(initial=0.0))


def _trans_gap(prog, ref, fids: slice) -> float:
    """The worst translation gap of a pose in frames `fids`."""
    p, r = (s.poses[..., fids, :3, 3].double().cpu().numpy() for s in (prog, ref))
    if not (np.isfinite(p).all() and np.isfinite(r).all()):
        return math.inf
    return float(np.linalg.norm(p - r, axis=-1).max(initial=0.0))


def sweep_gaps(prog, ref, fids: slice) -> dict:
    """The readings of a refine sweep run by both sides from the program's
    state before it: the worst translation gap of a pose of the unit after
    the sweep (the aggressive regime rewrites its span's poses), and of a
    map point (the conservative one polishes points only)."""
    return {"sweep_gap_m": _trans_gap(prog, ref, fids), "sweep_point_gap_m": _point_gap(prog, ref)}


def state_gaps(prog, ref, unit) -> dict:
    """The readings of the state after the unit's frames: ba_pose_gap_m
    over every pose of the pass so far where a frame of the unit ran the
    window BA (0 elsewhere), and point_gap_m."""
    end = unit.frame0 + unit.n_frames
    return {"ba_pose_gap_m": _trans_gap(prog, ref, slice(0, end)) if unit.has_ba else 0.0,
            "point_gap_m": _point_gap(prog, ref)}


def pose_gaps(prog: np.ndarray, ref: np.ndarray) -> dict:
    """The readings of one unit from (..., n + 1, 4, 4) camera-to-world
    poses, the frame before the unit first, in float64:

    pose_gap_m, rot_gap_deg  the worst translation and rotation gap of a
        pose of the unit;
    step_gap_m     the translation gap of the unit's first frame-to-frame
        motion (one step from the same state);
    rel_gap_med_m  the worst stream's median, over the unit's frames, of
        the translation gap of the frame-to-frame motion;
    rel_gap_max_m  the worst such gap.

    A non-finite pose on either side reads inf."""
    prog = prog.astype(np.float64)
    ref = ref.astype(np.float64)
    if not (np.isfinite(prog).all() and np.isfinite(ref).all()):
        return dict.fromkeys(NUMBERS[:5], math.inf)
    p, r = prog[..., 1:, :, :], ref[..., 1:, :, :]
    rel_p = np.linalg.inv(prog[..., :-1, :, :]) @ p
    rel_r = np.linalg.inv(ref[..., :-1, :, :]) @ r
    rel = np.linalg.norm(rel_p[..., :3, 3] - rel_r[..., :3, 3], axis=-1)  # (..., n)
    return {
        "pose_gap_m": float(np.linalg.norm(p[..., :3, 3] - r[..., :3, 3], axis=-1).max()),
        "rot_gap_deg": float(_rot_deg(p[..., :3, :3], r[..., :3, :3]).max()),
        "step_gap_m": float(rel[..., 0].max()),
        "rel_gap_med_m": float(np.median(rel, axis=-1).max()),
        "rel_gap_max_m": float(rel.max()),
    }


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """ATE RMSE (m) of a (N, 4, 4) trajectory after rigid Umeyama alignment
    (svo_tpu_torch/eval/trajectory.py's arithmetic, copied)."""
    n = min(len(est), len(gt))
    e, g = est[:n, :3, 3].astype(np.float64), gt[:n, :3, 3].astype(np.float64)
    mu_e, mu_g = e.mean(0), g.mean(0)
    C = (g - mu_g).T @ (e - mu_e) / n
    U, _, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    aligned = (R @ e.T).T + (mu_g - R @ mu_e)
    return float(np.sqrt(np.mean(np.sum((aligned - g) ** 2, axis=-1))))


def unit_frames(driver, unit) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The frames the unit stepped, as the reference takes them: a fleet's
    chunks (chunk, S, H, W), a live stretch (n, H, W), uint8 on the device."""
    if unit.chunks:
        return [driver.chunk_frames(c) for c in unit.chunks]
    sl = slice(unit.frame0, unit.frame0 + unit.n_frames)
    dev = driver.seq_device
    return [(torch.from_numpy(driver.left[sl]).to(dev), torch.from_numpy(driver.right[sl]).to(dev))]


def first_frames(driver, unit):
    if unit.chunks:
        return driver.l0, driver.r0, driver.seeds(unit.seed)
    dev = driver.seq_device
    return (torch.from_numpy(driver.left[0]).to(dev), torch.from_numpy(driver.right[0]).to(dev),
            unit.seed)


def run_frames(ref, driver, unit):
    """The reference's state after the unit's frames, before any sweep."""
    from vobench.reference.drive import adopt

    if unit.before is None:
        state = ref.bootstrap(*first_frames(driver, unit))
    else:
        state = adopt(unit.before)
    for lefts, rights in unit_frames(driver, unit):
        state = ref.chunk(state, lefts, rights) if unit.chunks else ref.frames(state, lefts, rights)
    return state


def outputs(ref, driver, unit, mode: str = "float32"):
    """The reference's states of the unit computed in `mode`: after its
    frames, and (a refine unit) after its sweep run from the program's
    state before the sweep, else None."""
    from vobench.reference.drive import adopt, precision

    with precision(mode, ref.device):
        frames = run_frames(ref, driver, unit)
        sweep = ref.refine(adopt(unit.mid)) if unit.refine else None
    return frames, sweep


def gaps(frames, sweep, want_frames, want_sweep, unit) -> dict:
    """The readings of `frames` (and `sweep`) against `want_frames` (and
    `want_sweep`) over the unit's poses, the frame before it first."""
    fids = slice(unit.frame0 - 1, unit.frame0 + unit.n_frames)

    def poses(state):
        return state.poses[..., fids, :, :].float().cpu().numpy()

    out = pose_gaps(poses(frames), poses(want_frames))
    out.update(state_gaps(frames, want_frames, unit))
    out.update(sweep_gap_m=0.0, sweep_point_gap_m=0.0)
    if unit.refine:
        out.update(sweep_gaps(sweep, want_sweep, fids))
    return out


def summarize(per_unit: list[dict]) -> dict:
    """Each number's worst over the kept units, and rel_gap_med_med_m."""
    out = {k: max((u[k] for u in per_unit), default=0.0) for k in NUMBERS}
    out["rel_gap_med_med_m"] = (float(np.median([u["rel_gap_med_m"] for u in per_unit]))
                                if per_unit else 0.0)
    return out


def compare(ref, driver, units, log=None, control: bool = False) -> tuple[dict, dict | None]:
    """The readings over `units` (summarize): the program
    against the reference, and with control=True each control (the
    reference computed one precision step below float32, CONTROLS) in the
    program's place against the reference; one line a unit to `log`. A
    unit closed by a sweep is compared in two parts: its frames (the
    program's state before the sweep against the reference's frames), and
    the sweep (the reference's sweep from the program's state before it).
    A control that fails to run reads inf: it has failed."""
    per_unit: list = []
    per_unit_ctl: dict = {m: [] for m in CONTROLS}
    for unit in units:
        t0 = time.perf_counter()
        want = outputs(ref, driver, unit)
        got = gaps(unit.mid if unit.refine else unit.after, unit.after, *want, unit)
        per_unit.append(got)
        line = ", ".join(f"{k} {v:.6g}" for k, v in got.items())
        for mode in CONTROLS if control else ():
            try:
                got = gaps(*outputs(ref, driver, unit, mode), *want, unit)
            except RuntimeError:
                got = dict.fromkeys(NUMBERS, math.inf)
            per_unit_ctl[mode].append(got)
            line += f"; {mode} " + ", ".join(f"{k} {v:.6g}" for k, v in got.items())
        if log is not None:
            log(f"check unit: pass {unit.pass_index} frames {unit.frame0}-"
                f"{unit.frame0 + unit.n_frames - 1}{' +sweep' if unit.refine else ''}"
                f"{' (bootstrap)' if unit.before is None else ''}"
                f"{' (window BA)' if unit.has_ba else ''}: {line}; "
                f"{time.perf_counter() - t0:.1f} s")
    worst = summarize(per_unit)
    worst_ctl = {m: summarize(v) for m, v in per_unit_ctl.items()} if control else None
    return worst, worst_ctl
