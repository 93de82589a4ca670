"""svo_tpu's aggressive-recovery run and the port's beside it, on the same
frames, state and PnP noise.

    python3 tests/recovery_reference.py [eval_recovery's arguments] [--svo-state] [--out F]
    python3 tests/recovery_reference.py --write-noise out/svo_noise.npy [--frames 241]
    python3 tests/recovery_reference.py --no-svo-tpu --noise out/svo_noise.npy \
        --device cuda --lk-engine fused        # the port alone, e.g. on a card without JAX

A script, not a test (pytest does not collect it; the tests import its
functions). It runs scripts/eval_recovery.py's steps (a healthy run of
corridor-base to inject_at - 1, drift injected over the trailing span, one
refine_global sweep, arm A without a back-end and arm B with refine_global
every 2 chunks) twice:

- svo_tpu on the CPU, unless --no-svo-tpu (its PnP key lives in its state,
  seeded --seed and split once a frame);
- the port (svo_tpu_torch.eval_recovery.recover_from) on --device, with
  svo_tpu's noise handed to every frame step by frame index (replay_noise),
  from its own healthy run, or with --svo-state from svo_tpu's healthy
  state (pipeline/state.from_numpy).

Frames come from the port's io/synthetic.py (svo_tpu's renderer's copy).
It prints each package's result and their differences; --out writes both.
--write-noise writes svo_tpu's noise for --frames frames and stops, so that
a machine without JAX can replay it with --noise. The default size is the
script's, 376x1241 and 241 frames; --small runs 184x320 with fx 200.
"""

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from svo_tpu_torch import eval_recovery  # noqa: E402


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def svo_tpu_noise(n_steps: int, seed: int = 0) -> np.ndarray:
    """svo_tpu's PnP noise of its first n_steps frame steps from PnP seed
    `seed`: (n_steps, hypotheses, max_features); row k serves frame k + 1."""
    jax = _jax()
    from svo_tpu.config import Config as JConfig

    cfg = JConfig(use_orb=False)
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.gumbel(
            sub, (cfg.ransac.num_hypotheses, cfg.capacity.max_features))))
    return np.stack(out)


@contextlib.contextmanager
def replay_noise(noise: np.ndarray):
    """Every frame step of the port takes its PnP noise from `noise` by the
    frame it steps to (row frame_id of the state before the step), as
    svo_tpu's key chain gives it whatever ran before: both recovery arms
    replay the same rows."""
    import torch

    from svo_tpu_torch.pipeline import frontend

    body = frontend.step_body

    def step_body(state, *a, **k):
        k["pnp_noise"] = torch.from_numpy(noise[int(state.frame_id)]).to(state.pose.device)
        return body(state, *a, **k)

    frontend.step_body = step_body
    try:
        yield
    finally:
        frontend.step_body = body


class SvoTpuRecovery:
    """scripts/eval_recovery.py's steps on svo_tpu (CPU) as functions."""

    def __init__(self, args, seq):
        _jax()
        import jax
        import jax.numpy as jnp

        from svo_tpu.config import Config as JConfig
        from svo_tpu.geometry import camera as jcam
        from svo_tpu.parallel.global_opt import refine_global
        from svo_tpu.pipeline.odometry import StereoVO as JStereoVO

        self.args = args
        H, W = seq.shape
        self.camera = jcam.from_intrinsics(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2],
                                           seq.baseline)
        self.cfg = JConfig(use_orb=False, image_height=H, image_width=W)
        self.vo = JStereoVO(self.cfg, self.camera, seed=args.seed, chunk=args.chunk,
                            kf_cadence=args.cadence)
        K_mat = jnp.asarray(self.camera.K)
        bfx = jnp.float32(self.camera.K[0, 0] * self.camera.baseline)
        self.refine = jax.jit(lambda mp, poses, fid: refine_global(mp, poses, fid, K_mat, bfx))

    def chunks(self, state, ls, rs, c_lo, c_hi, refine_every=0):
        """svo_tpu's chunk steps (and refinement) from a copy of state: its
        chunk step donates the state it is given."""
        import jax
        import jax.numpy as jnp

        CH = self.args.chunk
        state = jax.tree.map(jnp.copy, state)
        for c in range(c_lo, c_hi):
            sl = slice(1 + c * CH, 1 + (c + 1) * CH)
            state = self.vo._chunk_step(state, np.ascontiguousarray(ls[sl]),
                                        np.ascontiguousarray(rs[sl]))
            if refine_every and (c + 1) % refine_every == 0:
                r = self.refine(state.map, state.poses, state.frame_id)
                state = state._replace(map=state.map._replace(points=r.map.points),
                                       poses=r.poses, pose=r.poses[state.frame_id])
        return state

    def healthy(self, ls, rs):
        self.vo.start(ls[0].astype(np.float32), rs[0].astype(np.float32))
        return self.chunks(self.vo.state, ls, rs, 0, (self.args.inject_at - 1) // self.args.chunk)

    def corrupt(self, st):
        """The script's injection (scripts/eval_recovery.py:111-150) on
        svo_tpu's arrays; returns the corrupted state and the birth frames."""
        import jax.numpy as jnp

        a = self.args
        hi = a.inject_at - 1
        lo = hi - a.span + 1
        poses = np.asarray(st.poses)
        obs_pid, obs_fid = np.asarray(st.map.obs_pid), np.asarray(st.map.obs_fid)
        birth = np.full(st.map.points.shape[0], 1 << 20, np.int64)
        okobs = obs_pid >= 0
        np.minimum.at(birth, obs_pid[okobs], obs_fid[okobs])
        new_poses, new_pts = poses.copy(), np.asarray(st.map.points).copy()
        for f in range(lo, hi + 1):
            alpha = (f - lo + 1) / float(a.span)
            ang = np.radians(a.rot_deg) * alpha
            c, s = np.cos(ang), np.sin(ang)
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            T[:3, 3] = np.array([1.0, 0.15, 0.4]) * (a.trans_m * alpha)
            new_poses[f] = T @ poses[f]
            born = birth == f
            if born.any():
                new_pts[born] = (new_pts[born] @ T[:3, :3].T) + T[:3, 3]
        return st._replace(poses=jnp.asarray(new_poses), pose=jnp.asarray(new_poses[hi]),
                           map=st.map._replace(points=jnp.asarray(new_pts))), birth

    def recover_from(self, st, gt, ls, rs):
        """Steps 2-4 from svo_tpu's healthy state: (result, arms, sweep)."""
        from svo_tpu.eval.trajectory import ate_rmse

        a = self.args
        hi = a.inject_at - 1
        lo = hi - a.span + 1
        corrupt, _ = self.corrupt(st)
        pose_err = float(np.linalg.norm(np.asarray(corrupt.poses[hi])[:3, 3] - gt[hi][:3, 3]))
        res = self.refine(corrupt.map, corrupt.poses, corrupt.frame_id)
        swept = corrupt._replace(map=corrupt.map._replace(points=res.map.points),
                                 poses=res.poses, pose=res.poses[hi])
        err_before = ate_rmse(np.asarray(corrupt.poses[lo:hi + 1]), gt[lo:hi + 1], align=False)
        err_after = ate_rmse(np.asarray(swept.poses[lo:hi + 1]), gt[lo:hi + 1], align=False)
        n = 1 + ((a.frames - 1) // a.chunk) * a.chunk
        c_lo, c_hi = hi // a.chunk, (n - 1) // a.chunk
        arms = {
            "a": np.asarray(self.chunks(corrupt, ls, rs, c_lo, c_hi).poses[:n]),
            "b": np.asarray(self.chunks(swept, ls, rs, c_lo, c_hi,
                                        eval_recovery.REFINE_EVERY).poses[:n]),
        }
        ate_a = ate_rmse(arms["a"][a.inject_at:], gt[a.inject_at:n], align=False)
        ate_b = ate_rmse(arms["b"][a.inject_at:], gt[a.inject_at:n], align=False)
        cost = float(res.cost_per_obs)
        result = {
            "newest_pose_err_m": pose_err,
            "refine_cost_per_obs_px": cost,
            "aggressive_fired": cost > eval_recovery.RECOVER_COST_PER_OBS,
            "accepted": bool(res.accepted),
            "span_abs_err_before_m": err_before,
            "span_abs_err_after_m": err_after,
            "post_abs_err_no_backend_m": ate_a,
            "post_abs_err_recovered_m": ate_b,
            "recovered": bool(ate_b < 0.5 * ate_a),
        }
        return result, arms, res


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--no-svo-tpu", action="store_true", help="run the port alone")
    p.add_argument("--svo-state", action="store_true",
                   help="the port continues from svo_tpu's healthy state")
    p.add_argument("--noise", default="", help="svo_tpu's noise from --write-noise's file")
    p.add_argument("--write-noise", default="", help="write svo_tpu's noise here and stop")
    own, rest = p.parse_known_args(argv)
    # eval_recovery's arguments; here the CPU and svo_tpu's CPU path's engine by default
    rest = (["--device", "cpu"] if "--device" not in rest else []) + \
        (["--lk-engine", "patches"] if "--lk-engine" not in rest else []) + rest
    args = argparse.Namespace(**vars(eval_recovery.parse_args(rest)), **vars(own))
    if args.write_noise:
        np.save(args.write_noise, svo_tpu_noise(args.frames - 1, args.seed))
        return 0
    import torch

    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    t0 = time.time()
    ls, rs, gt, seq = eval_recovery.render(args)
    print(f"rendered {args.frames} frames {ls.shape[1]}x{ls.shape[2]} ({time.time() - t0:.0f} s)",
          flush=True)
    out = {"args": vars(args)}
    jstate = None
    if not args.no_svo_tpu:
        t0 = time.time()
        ref = SvoTpuRecovery(args, seq)
        jstate = ref.healthy(ls, rs)
        out["svo_tpu"], _, _ = ref.recover_from(jstate, gt, ls, rs)
        out["svo_tpu_s"] = time.time() - t0
        print(f"svo_tpu (CPU): {json.dumps(out['svo_tpu'])} ({out['svo_tpu_s']:.0f} s)", flush=True)
    noise = np.load(args.noise) if args.noise else svo_tpu_noise(args.frames - 1, args.seed)
    t0 = time.time()
    vo = eval_recovery.engine(args, seq)
    with replay_noise(noise):
        if args.svo_state:
            import jax

            from svo_tpu_torch.pipeline.state import from_numpy

            vo.state = from_numpy(jax.tree.map(np.asarray, jstate), vo.device)
        else:
            eval_recovery.healthy_run(vo, ls, rs, args.inject_at)
            if jstate is not None:
                diff = np.abs(vo.state.poses[:args.inject_at].cpu().numpy()
                              - np.asarray(jstate.poses[:args.inject_at])).max()
                print(f"healthy runs to frame {args.inject_at - 1}: max |pose diff| {diff:.3g}",
                      flush=True)
        port, _ = eval_recovery.recover_from(vo, ls, rs, gt, args)
    out["port"] = {k: port[k] for k in port if k != "resolved_config"}
    out["port_s"] = time.time() - t0
    print(f"port ({vo.device}, {vo.lk_engine}, svo_tpu's noise): "
          f"{json.dumps({k: out['port'][k] for k in out.get('svo_tpu', out['port'])})} "
          f"({out['port_s']:.0f} s)", flush=True)
    if "svo_tpu" in out:
        out["diff"] = {k: abs(out["port"][k] - v) for k, v in out["svo_tpu"].items()
                       if not isinstance(v, bool)}
        print(f"|port - svo_tpu|: {json.dumps(out['diff'])}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
