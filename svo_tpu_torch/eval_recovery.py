"""The back-end's aggressive regime on live state: drift injected into a
running pipeline, then recovered.

    python3 -m svo_tpu_torch.eval_recovery [--frames 241] [--chunk 12]
        [--cadence 6] [--inject-at 121] [--span 22] [--rot-deg 4]
        [--trans-m 0.8] [--seed 0] [--small] [--device cuda|cpu] [--lk-engine fused|patches] [--out F]

The counterpart of scripts/eval_recovery.py. The Schur-LM block BA's
in-pipeline role is rebuilding BROKEN spans (parallel/global_opt.py's
aggressive regime); this shows it on a live run of the corridor-base
world (eval_worlds' first row, 376x1241):

1. the pipeline runs healthily to the chunk boundary inject_at - 1;
2. accumulating drift is injected over the trailing --span frames: each
   frame's pose is rotated and translated by a growing error, and every map
   point born in that frame moves with it (a map that is consistent per
   frame and inconsistent across frames, what a front-end failure leaves);
3. one refine_global sweep runs on the corrupted state (it must classify
   the span as aggressive and correct it);
4. arm A continues with no back-end, arm B from the swept state with
   refine_global every 2 chunks, both to the last whole chunk;
   the result is the unaligned trajectory error of each arm after the
   injection.

The PnP key is part of the state, as in svo_tpu, so both arms, each
started from a copy of the corrupted (arm A) or swept (arm B) state, draw
the same noise; the result's arm_rng_keys are the keys they start from
(recover_from(..., backend=False) gives arm B no back-end: the arms must
then be equal bit for bit). A point's birth frame is the first frame that
observed it, read off the observation ring, so the run refuses to inject
once the ring has wrapped. --seed is the PnP key's seed; --small renders
184x320 frames with fx 200. It runs on the card unless --device cpu is
given. The result has the keys of svo_tpu's RECOVERY_r05.json (numbers
unrounded), plus the device; --out writes it, and one summary line is
printed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SHAPE, FX = (376, 1241), 718.856
# scripts/eval_recovery.py's world: (name, world kind, trajectory, speed, seed)
WORLD = ("corridor-base", "corridor", "wobble", 0.3, 7)
RECOVER_COST_PER_OBS = 10.0  # refine_global's aggressive-regime threshold
REFINE_EVERY = 2  # arm B's refinement, in chunks
NOT_BORN = 1 << 20


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m svo_tpu_torch.eval_recovery")
    p.add_argument("--frames", type=int, default=241)
    p.add_argument("--chunk", type=int, default=12)
    p.add_argument("--cadence", type=int, default=6)
    p.add_argument("--inject-at", type=int, default=121,
                   help="frame (chunk boundary) of the injection")
    p.add_argument("--span", type=int, default=22,
                   help="trailing frames carrying the injected drift")
    p.add_argument("--rot-deg", type=float, default=4.0,
                   help="total injected rotation at the newest frame")
    p.add_argument("--trans-m", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=0, help="the PnP key's seed")
    p.add_argument("--small", action="store_true", help="184x320 images, fx 200")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--lk-engine", default="fused", choices=("patches", "fused"))
    p.add_argument("--out", default="", help="write the result JSON here")
    return p.parse_args(argv)


def _log(t_start: float, msg: str) -> None:
    print(f"[recovery +{time.perf_counter() - t_start:6.1f}s] {msg}", file=sys.stderr, flush=True)


def point_birth(mp) -> np.ndarray:
    """(M,) int64: the first frame observing each point (NOT_BORN if none),
    the minimum frame id over the observation ring. Raises once the ring has
    wrapped: a point's first observations may have been overwritten."""
    ring = mp.obs_pid.shape[-1]
    if int(mp.obs_cursor) > ring:
        raise ValueError(f"the observation ring has wrapped ({int(mp.obs_cursor)} observations "
                         f"written into {ring} slots): birth frames are lost")
    obs_pid = mp.obs_pid.cpu().numpy()
    obs_fid = mp.obs_fid.cpu().numpy()
    birth = np.full(mp.points.shape[0], NOT_BORN, np.int64)
    ok = obs_pid >= 0
    np.minimum.at(birth, obs_pid[ok], obs_fid[ok])
    return birth


def _err_T(alpha: float, rot_deg: float, trans_m: float) -> np.ndarray:
    a = np.radians(rot_deg) * alpha
    c, s = np.cos(a), np.sin(a)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    T[:3, 3] = np.array([1.0, 0.15, 0.4]) * (trans_m * alpha)
    return T


def inject_drift(state, lo: int, hi: int, rot_deg: float, trans_m: float):
    """The state with accumulating drift over frames lo..hi: frame f's pose
    and the points born in it are moved by the error of alpha = (f-lo+1) /
    (hi-lo+1), rot_deg about y and trans_m along (1, 0.15, 0.4) at alpha 1;
    the current pose becomes frame hi's. In float32 numpy, as
    scripts/eval_recovery.py computes it."""
    import torch

    span = hi - lo + 1
    birth = point_birth(state.map)
    poses = state.poses.cpu().numpy()
    new_poses, new_pts = poses.copy(), state.map.points.cpu().numpy().copy()
    for f in range(lo, hi + 1):
        T = _err_T((f - lo + 1) / float(span), rot_deg, trans_m)
        new_poses[f] = T @ poses[f]
        born = birth == f
        if born.any():
            new_pts[born] = (new_pts[born] @ T[:3, :3].T) + T[:3, 3]
    dev = state.poses.device
    new_poses = torch.from_numpy(new_poses).to(dev)
    return state._replace(
        poses=new_poses, pose=new_poses[hi].clone(),
        map=state.map._replace(points=torch.from_numpy(new_pts).to(dev)),
    )


def _apply(state, res, frame):
    return state._replace(map=state.map._replace(points=res.map.points), poses=res.poses,
                          pose=res.poses[frame])


def _key(state) -> list[int]:
    """The state's PnP key as its two uint32 words."""
    return [int(w) for w in state.rng.cpu().numpy().view(np.uint32)]


def render(args):
    """The corridor-base sequence of args.frames frames as uint8 stacks
    (F, H, W), its ground truth and the sequence."""
    from svo_tpu_torch.io.synthetic import SyntheticSequence

    shape, fx = ((184, 320), 200.0) if args.small else (SHAPE, FX)
    _, world, traj, speed, seed = WORLD
    seq = SyntheticSequence(n_frames=args.frames, shape=shape, fx=fx, speed=speed, world=world,
                            traj=traj, seed=seed)
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:  # numpy frees the GIL
        pairs = list(pool.map(seq.frame, range(args.frames)))
    ls, rs = (np.stack([np.clip(p[k], 0, 255).astype(np.uint8) for p in pairs]) for k in (0, 1))
    return ls, rs, seq.gt_poses, seq


def engine(args, seq):
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.geometry import camera as cam_mod
    from svo_tpu_torch.pipeline.odometry import StereoVO

    H, W = seq.shape
    cfg = Config(use_orb=False, image_height=H, image_width=W)
    camera = cam_mod.from_intrinsics(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2],
                                     seq.baseline)
    return StereoVO(cfg, camera, seed=args.seed, chunk=args.chunk, kf_cadence=args.cadence,
                    device=args.device, lk_engine=args.lk_engine)


def _chunks(vo, state, ls, rs, c_lo, c_hi, refine=None, refine_every=0):
    import torch

    CH = vo.chunk
    for c in range(c_lo, c_hi):
        sl = slice(1 + c * CH, 1 + (c + 1) * CH)
        state = vo._chunk_step(state, torch.from_numpy(ls[sl]).to(vo.device),
                               torch.from_numpy(rs[sl]).to(vo.device))
        if refine_every and (c + 1) % refine_every == 0:
            state = _apply(state, refine(state), state.frame_id.long())
    return state


def healthy_run(vo, ls, rs, inject_at: int):
    """vo started on frame 0 and stepped chunk by chunk to inject_at - 1."""
    if (inject_at - 1) % vo.chunk:
        raise ValueError(f"inject at a chunk boundary: ({inject_at} - 1) % {vo.chunk} != 0")
    vo.start(ls[0].astype(np.float32), rs[0].astype(np.float32))
    vo.state = _chunks(vo, vo.state, ls, rs, 0, (inject_at - 1) // vo.chunk)
    return vo.state


def recover_from(vo, ls, rs, gt, args, log=lambda m: None, backend=True):
    """Steps 2-4 on vo.state, the healthy state at inject_at - 1. Returns
    the result dict (without the device) and the two arms' trajectories
    (n, 4, 4). backend=False runs arm B as arm A (no sweep, no
    refinement): the check that the arms differ by the back-end alone."""
    from svo_tpu_torch.eval.trajectory import ate_rmse
    from svo_tpu_torch.parallel.global_opt import make_refine_global
    from svo_tpu_torch.pipeline.state import clone, host

    hi = args.inject_at - 1
    lo = hi - args.span + 1
    # one refiner for every sweep, with the engine's graph: on the card it
    # replays, and what it returns is its own buffers until its next sweep
    sweep = make_refine_global(vo.camera.K, vo.camera.K[0, 0] * vo.camera.baseline,
                               graph=vo.graph)

    def refine(st):
        return sweep(st.map, st.poses, st.frame_id)

    # the chunk step's and the refiner's own buffers (pipeline/graph.py),
    # which the arms' chunks and sweeps overwrite: both arms start from copies
    healthy = clone(vo.state)
    corrupt = inject_drift(healthy, lo, hi, args.rot_deg, args.trans_m)
    pose_err = float(np.linalg.norm(corrupt.poses[hi, :3, 3].cpu().numpy() - gt[hi][:3, 3]))
    log(f"injected drift: newest-frame pose error {pose_err:.2f} m / {args.rot_deg:.1f} deg "
        f"over frames {lo}-{hi}")

    res = refine(corrupt)
    cost_per_obs = float(res.cost_per_obs)
    accepted = bool(res.accepted)
    swept = _apply(corrupt, res, hi)
    span_gt = gt[lo:hi + 1]
    err_before = ate_rmse(corrupt.poses[lo:hi + 1].cpu().numpy(), span_gt, align=False)
    err_after = ate_rmse(swept.poses[lo:hi + 1].cpu().numpy(), span_gt, align=False)
    log(f"refine sweep: cost/obs {cost_per_obs:.1f} px, accepted={accepted}, span abs err "
        f"{err_before:.3f} -> {err_after:.3f} m")

    CH = vo.chunk
    n = 1 + ((args.frames - 1) // CH) * CH
    arms, keys, kf = {}, [], {}
    for arm, start, every in (("a", corrupt, 0),
                              ("b", swept, REFINE_EVERY) if backend else ("b", corrupt, 0)):
        keys.append(_key(start))
        vo.state = _chunks(vo, clone(start), ls, rs, hi // CH, (n - 1) // CH, refine, every)
        arms[arm] = host(vo.state.poses[:n])
        kf[arm] = int(vo.state.kf_flags[args.inject_at:n].sum())
    ate_a = ate_rmse(arms["a"][args.inject_at:], gt[args.inject_at:n], align=False)
    ate_b = ate_rmse(arms["b"][args.inject_at:], gt[args.inject_at:n], align=False)
    log(f"arm A (no back-end): post-injection abs err {ate_a:.3f} m")
    log(f"arm B (recovered + refine): post-injection abs err {ate_b:.3f} m")

    result = {
        "metric": "aggressive_recovery",
        "world": WORLD[0],
        "frames": args.frames,
        "inject_at": args.inject_at,
        "span": args.span,
        "injected_rot_deg": args.rot_deg,
        "injected_trans_m": args.trans_m,
        "newest_pose_err_m": pose_err,
        "refine_cost_per_obs_px": cost_per_obs,
        "aggressive_fired": cost_per_obs > RECOVER_COST_PER_OBS,
        "accepted": accepted,
        "span_abs_err_before_m": err_before,
        "span_abs_err_after_m": err_after,
        "post_abs_err_no_backend_m": ate_a,
        "post_abs_err_recovered_m": ate_b,
        "recovered": bool(ate_b < 0.5 * ate_a),
        "backend_in_arm_b": backend,
        "seed": vo.seed,
        # the PnP key each arm starts from: equal, or the arms differ by
        # noise as well as by the back-end
        "arm_rng_keys": keys,
        "image": f"{ls.shape[1]}x{ls.shape[2]}",
        "chunk": CH,
        "kf_cadence": args.cadence,
        "lk_engine": vo.lk_engine,
        # frame and keyframe steps (the bootstrap included) of the healthy
        # run and both arms: what the kernels' launches follow
        "steps": {"frames": (args.inject_at - 1) + 2 * (n - args.inject_at),
                  "keyframes": int(healthy.kf_flags[:args.inject_at].sum()) + kf["a"] + kf["b"]},
        "resolved_config": dataclasses.asdict(vo.cfg),
    }
    return result, arms


def recovery(args: argparse.Namespace):
    """The whole run; returns (result dict, the engine after arm B)."""
    from svo_tpu_torch.pipeline.odometry import resolve_device

    resolve_device(args.device)  # before the rendering: no card, no run
    t_start = time.perf_counter()
    ls, rs, gt, seq = render(args)
    vo = engine(args, seq)
    _log(t_start, f"rendered {args.frames} frames {ls.shape[1]}x{ls.shape[2]}; {vo.device}, "
         f"lk_engine={vo.lk_engine}")
    healthy_run(vo, ls, rs, args.inject_at)
    _log(t_start, f"healthy run to frame {args.inject_at - 1}")
    result, _ = recover_from(vo, ls, rs, gt, args, lambda m: _log(t_start, m))
    device = str(vo.device)
    if vo.device.type == "cuda":
        from svo_tpu_torch._measure import smi_line

        device = smi_line()
    result["device"] = device
    result["wall_s"] = time.perf_counter() - t_start
    return result, vo


def main(argv=None) -> int:
    args = parse_args(argv)
    result, _ = recovery(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in (
        "metric", "span_abs_err_before_m", "span_abs_err_after_m", "post_abs_err_no_backend_m",
        "post_abs_err_recovered_m", "recovered")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
