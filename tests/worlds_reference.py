"""svo_tpu's tracking on cut-down worlds of the worlds suite, and the port's
beside it on the same frames.

    python3 tests/worlds_reference.py [--worlds atrium-slalom,box-loop] [--frames 49]
        [--sequence 49,241] [--seeds 0,1,2]     # CPU, 184x320, ~6 min on 8 cores
    python3 tests/worlds_reference.py --write-noise out/svo_noise.npy
    python3 tests/worlds_reference.py --full --device cuda --no-svo-tpu \
        --noise out/svo_noise.npy                # the port alone, 376x1241, on the card

A script, not a test (pytest does not collect it). By default it runs on
the CPU at 184x320 (eval_worlds --small's size and focal length, a field
of view within 4 degrees of the 376x1241 one); --full renders 376x1241.
For each world, each sequence length in --sequence (a sequence of that
many frames; the loop, slalom and turns trajectories are spread over the
whole sequence, so 49 is a sharper world than the first 49 frames of 241)
and each direction, it runs the first --frames frames through one stream,
chunk 12, keyframe cadence 6, refine_global after every 2 chunks
(scripts/eval_worlds.py's run_tpu, eval_worlds's stepping):

- svo_tpu's StereoVO on the CPU (PnP seed 0), unless --no-svo-tpu: its
  CPU path, the patches engine's, or with --svo-tpu-fused its fused
  LK-level kernel in Pallas interpret mode (SVO_TPU_FUSED_INTERPRET, as
  tests/test_lk_fused_pipeline.py runs it; slow);
- for each KLT engine in --lk-engines (svo_tpu's CPU runs the patches
  engine's path; the worlds suite on the card runs fused): the port's
  StereoVO on --device with svo_tpu's PnP noise handed to it step by step
  (the split chain of jax.random from seed 0, as tests/test_torch_cli.py
  does; --noise reads it from the file that --write-noise wrote, so that
  a machine without JAX can run this), then with its own noise, PnP
  seeds --seeds.

Frames come from the port's io/synthetic.py (svo_tpu's renderer's copy,
tests/test_torch_geometry.py). Each line gives the ATE, the tracked
features at the last frame and their minimum over the run, the first
frame with none tracked (if any), and the refine verdicts. These are the
readings behind ROADMAP C's note on cutting the worlds suite by --frames.
"""

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from svo_tpu_torch.eval.trajectory import ate_rmse  # noqa: E402
from svo_tpu_torch.io.synthetic import SyntheticSequence  # noqa: E402

CHUNK, CADENCE, REFINE_EVERY = 12, 6, 2
SHAPE, FX = (184, 320), 200.0  # --full: (376, 1241), 718.856
# scripts/eval_worlds.py's WORLDS rows used here: (world, trajectory, speed)
WORLDS = {
    "atrium-slalom": ("atrium", "slalom", 0.4),
    "box-loop": ("box", "loop", 0.3),
    "corridor-base": ("corridor", "wobble", 0.3),
}


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def frames_of(name, n_seq, n, reverse, shape, fx):
    world, traj, speed = WORLDS[name]
    seq = SyntheticSequence(n_frames=n_seq, shape=shape, fx=fx, speed=speed, world=world,
                            traj=traj, seed=7)
    idx = [n_seq - 1 - t if reverse else t for t in range(n)]
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        pairs = list(pool.map(seq.frame, idx))
    u8 = [tuple(np.clip(p, 0, 255).astype(np.uint8) for p in lr) for lr in pairs]
    return seq, u8, seq.gt_poses[idx]


def summary(poses, tracked, gt, verdicts):
    lost = np.flatnonzero(tracked[1:] == 0)
    return (f"ATE {ate_rmse(poses, gt):.4f} m | tracked last {int(tracked[-1])}, min "
            f"{int(tracked[1:].min())} | first frame with none tracked "
            f"{int(lost[0]) + 1 if lost.size else '-'} | refine accepted "
            f"{''.join(str(int(v)) for v in verdicts)}")


def run_svo_tpu(seq, frames, gt):
    jax = _jax()
    import jax.numpy as jnp

    from svo_tpu.config import Config as JConfig
    from svo_tpu.geometry import camera as jcam
    from svo_tpu.parallel.global_opt import refine_global as jrefine
    from svo_tpu.pipeline.odometry import StereoVO as JStereoVO

    cam = jcam.from_intrinsics(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline)
    H, W = frames[0][0].shape
    vo = JStereoVO(JConfig(use_orb=False, image_height=H, image_width=W), cam, chunk=CHUNK,
                   kf_cadence=CADENCE)
    vo.start(frames[0][0].astype(np.float32), frames[0][1].astype(np.float32))
    K_mat, bfx = jnp.asarray(cam.K), jnp.float32(cam.K[0, 0] * cam.baseline)

    @jax.jit
    def refine(mp, poses, fid):
        res = jrefine(mp, poses, fid, K_mat, bfx)
        return res.map.points, res.poses, res.poses[fid], res.accepted

    verdicts = []
    for c in range((len(frames) - 1) // CHUNK):
        part = frames[1 + c * CHUNK:1 + (c + 1) * CHUNK]
        vo.state = vo._chunk_step(vo.state, np.stack([p[0] for p in part]),
                                  np.stack([p[1] for p in part]))
        if (c + 1) % REFINE_EVERY == 0:
            pts, poses, pose, acc = refine(vo.state.map, vo.state.poses, vo.state.frame_id)
            vo.state = vo.state._replace(map=vo.state.map._replace(points=pts), poses=poses,
                                         pose=pose)
            verdicts.append(bool(acc))
    n = len(frames)
    return summary(np.asarray(vo.state.poses[:n]), np.asarray(vo.state.metrics[:n, 0]), gt,
                   verdicts)


def run_port(seq, frames, gt, device, engine, seed=0, noise=None):
    import torch

    from svo_tpu_torch.config import Config
    from svo_tpu_torch.geometry import camera as tcam
    from svo_tpu_torch.parallel.global_opt import refine_global
    from svo_tpu_torch.pipeline import frontend
    from svo_tpu_torch.pipeline.odometry import StereoVO

    cam = tcam.from_intrinsics(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline)
    H, W = frames[0][0].shape
    vo = StereoVO(Config(use_orb=False, image_height=H, image_width=W), cam, seed=seed,
                  chunk=CHUNK, kf_cadence=CADENCE, device=device, lk_engine=engine)
    draw = frontend.gumbel_noise
    if noise is not None:
        it = (torch.from_numpy(x).to(vo.device) for x in noise)
        frontend.gumbel_noise = lambda *a, **k: next(it)
    try:
        vo.start(frames[0][0].astype(np.float32), frames[0][1].astype(np.float32))
        bfx = vo.camera.K[0, 0] * vo.camera.baseline
        verdicts = []
        for c in range((len(frames) - 1) // CHUNK):
            part = frames[1 + c * CHUNK:1 + (c + 1) * CHUNK]
            ls, rs = (torch.from_numpy(np.stack([p[k] for p in part])).to(vo.device)
                      for k in (0, 1))
            vo.state = vo._chunk_step(vo.state, ls, rs, vo.generator)
            if (c + 1) % REFINE_EVERY == 0:
                st = vo.state
                res = refine_global(st.map, st.poses, st.frame_id, vo.camera.K, bfx)
                vo.state = st._replace(map=st.map._replace(points=res.map.points),
                                       poses=res.poses, pose=res.poses[st.frame_id.long()])
                verdicts.append(bool(res.accepted))
        if noise is not None:
            assert next(it, None) is None, "the noise was not drawn once a frame"
    finally:
        frontend.gumbel_noise = draw
    n = len(frames)
    return summary(vo.state.poses[:n].cpu().numpy(), vo.state.metrics[:n, 0].cpu().numpy(), gt,
                   verdicts)


def svo_tpu_noise(n_steps):
    """svo_tpu's PnP noise of n_steps steps from PnP seed 0, (n_steps, 128, 128)."""
    jax = _jax()
    from svo_tpu.config import Config as JConfig

    cfg = JConfig(use_orb=False)
    key, out = jax.random.PRNGKey(0), []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.gumbel(
            sub, (cfg.ransac.num_hypotheses, cfg.capacity.max_features))))
    return np.stack(out)


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--worlds", default="atrium-slalom,box-loop")
    p.add_argument("--frames", type=int, default=49, help="frames run of each sequence")
    p.add_argument("--sequence", default="49,241", help="sequence lengths rendered")
    p.add_argument("--seeds", default="0,1,2", help="the port's own PnP seeds")
    p.add_argument("--full", action="store_true", help="376x1241 frames")
    p.add_argument("--device", default="cpu", help="the port's device")
    p.add_argument("--lk-engines", default="patches,fused", help="the port's KLT engines")
    p.add_argument("--no-svo-tpu", action="store_true", help="run the port alone")
    p.add_argument("--svo-tpu-fused", action="store_true",
                   help="svo_tpu's fused kernel, interpreted, in place of its CPU path")
    p.add_argument("--noise", default="", help="svo_tpu's noise from --write-noise's file")
    p.add_argument("--write-noise", default="", help="write svo_tpu's noise here and stop")
    args = p.parse_args(argv)
    if args.write_noise:
        np.save(args.write_noise, svo_tpu_noise(args.frames - 1))
        return 0
    torch.set_num_threads(4)
    if args.svo_tpu_fused:  # read when svo_tpu/ops/klt.py is imported
        os.environ["SVO_TPU_FUSED_INTERPRET"] = "1"
    shape, fx = ((376, 1241), 718.856) if args.full else (SHAPE, FX)
    for name in args.worlds.split(","):
        for n_seq in (int(v) for v in args.sequence.split(",")):
            for reverse in (False, True):
                seq, frames, gt = frames_of(name, n_seq, args.frames, reverse, shape, fx)
                tag = (f"{name}, first {args.frames} of {n_seq} frames {shape[0]}x{shape[1]}, "
                       f"{'reversed' if reverse else 'forward'}")
                if not args.no_svo_tpu:
                    t0 = time.time()
                    engine = "fused, interpreted" if args.svo_tpu_fused else "patches"
                    print(f"{tag} | svo_tpu (CPU, {engine}): {run_svo_tpu(seq, frames, gt)} "
                          f"({time.time() - t0:.0f} s)", flush=True)
                noise = np.load(args.noise) if args.noise else svo_tpu_noise(len(frames) - 1)
                noise = noise[:len(frames) - 1]
                for engine in args.lk_engines.split(","):
                    port = f"port ({args.device}, {engine})"
                    print(f"{tag} | {port}, svo_tpu's noise: "
                          f"{run_port(seq, frames, gt, args.device, engine, noise=noise)}",
                          flush=True)
                    for s in (int(v) for v in args.seeds.split(",") if v):
                        print(f"{tag} | {port}, PnP seed {s}: "
                              f"{run_port(seq, frames, gt, args.device, engine, s)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
