"""svo_tpu's own ORB accuracy, which the port's ORB runs on the card are
held to, and the port's on the same inputs on the CPU.

    python3 tests/orb_reference.py          # svo_tpu only, ~4 min
    python3 tests/orb_reference.py --port   # and the port beside it, ~12 min

A script, not a test (pytest does not collect it). On the CPU it prints:

- svo_tpu's ORB ATE on bench.py's 97-frame 376x1241 synthetic sequence,
  chunk 12, keyframe cadence 6, forward and reversed (the frames in
  reverse order, as the odd streams of the batched runs): chip_smoke.py's
  REF_ORB_ATE_M. The forward run is examples/run_synthetic.py --frames 97
  --chunk 12 --cadence 6 --cpu.
- svo_tpu's ORB ATE on tests/fixtures/kitti_mini, frame by frame (as
  examples/run_kitti.py without --chunk), for PnP seeds 0-5:
  chip_smoke.py's REF_ORB_KITTI_MINI_WORST_M is the worst of them.
- With --port: the port's StereoVO on the same 97 frames, forward and
  reversed, with svo_tpu's PnP noise handed to it step by step (the split
  chain of jax.random from seed 0, as tests/test_torch_cli.py does), then
  with its own noise (PnP seeds 0 and 1, the fused engine), and on
  kitti_mini for PnP seeds 0-7 with its own noise.
"""

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from svo_tpu.config import Config as JConfig  # noqa: E402
from svo_tpu.eval.trajectory import ate_rmse  # noqa: E402
from svo_tpu.geometry import camera as jcam  # noqa: E402
from svo_tpu.io import kitti  # noqa: E402
from svo_tpu.io.synthetic import SyntheticSequence  # noqa: E402
from svo_tpu.pipeline.odometry import StereoVO as JStereoVO  # noqa: E402

KITTI = os.path.join(REPO, "tests", "fixtures", "kitti_mini")


def synthetic():
    seq = SyntheticSequence(n_frames=97, shape=(376, 1241), fx=718.856)
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        frames = [(i, *lr) for i, lr in enumerate(pool.map(seq.frame, range(97)))]
    return seq, frames


def svo_tpu_numbers(seq, frames) -> None:
    cam = jcam.from_intrinsics(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline)
    cfg = JConfig(image_height=376, image_width=1241, end_frame=97)
    for name, fr, gt in (("forward", frames, seq.gt_poses),
                         ("reversed", frames[::-1], seq.gt_poses[::-1])):
        t0 = time.time()
        res = JStereoVO(cfg, cam, chunk=12, kf_cadence=6).run_chunked(fr)
        print(f"svo_tpu ORB, 97 frames 376x1241, chunk 12 cadence 6, {name}: ATE "
              f"{ate_rmse(res.poses, gt):.4f} m | mean inlier ratio "
              f"{res.metrics[1:, 1].mean():.4f} | keyframes {int(res.kf_flags.sum())} "
              f"({time.time() - t0:.0f} s)", flush=True)
    frames_k = list(kitti.SequenceReader(KITTI))
    gt_k = kitti.parse_ground_truth(os.path.join(KITTI, "poses.txt"))
    cam_k = jcam.parse_kitti_calib(os.path.join(KITTI, "calib.txt"))
    ates = [ate_rmse(JStereoVO(JConfig(), cam_k, seed=s).run(frames_k).poses, gt_k)
            for s in range(6)]
    print(f"svo_tpu ORB, kitti_mini frame by frame, PnP seeds 0-5: ATE "
          f"{' '.join(f'{a:.4f}' for a in ates)} m", flush=True)


def port_numbers(seq, frames) -> None:
    import torch

    from svo_tpu_torch.config import Config
    from svo_tpu_torch.geometry import camera as tcam
    from svo_tpu_torch.io import kitti as tkitti
    from svo_tpu_torch.pipeline import frontend
    from svo_tpu_torch.pipeline.odometry import StereoVO

    torch.set_num_threads(4)
    cam = tcam.from_intrinsics(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline)
    cfg = Config(image_height=376, image_width=1241)
    draw = frontend.split_gumbel
    for name, fr, gt in (("forward", frames, seq.gt_poses),
                         ("reversed", frames[::-1], seq.gt_poses[::-1])):
        key, noises = jax.random.PRNGKey(0), []
        for _ in fr[1:]:
            key, sub = jax.random.split(key)
            noises.append(torch.from_numpy(np.array(jax.random.gumbel(
                sub, (cfg.ransac.num_hypotheses, cfg.capacity.max_features)))))
        it = iter(noises)
        frontend.split_gumbel = lambda keys, shape: (draw(keys, shape)[0], next(it))
        try:
            res = StereoVO(cfg, cam, chunk=12, kf_cadence=6, device="cpu").run_chunked(fr)
        finally:
            frontend.split_gumbel = draw
        print(f"port ORB on the CPU, svo_tpu's PnP noise, {name}: ATE "
              f"{ate_rmse(res.poses, gt):.4f} m", flush=True)
    for name, fr, gt in (("forward", frames, seq.gt_poses),
                         ("reversed", frames[::-1], seq.gt_poses[::-1])):
        ates = [ate_rmse(StereoVO(cfg, cam, seed=s, chunk=12, kf_cadence=6, device="cpu",
                                  lk_engine="fused").run_chunked(fr).poses, gt)
                for s in (0, 1)]
        print(f"port ORB on the CPU, its own PnP noise, seeds 0 and 1, fused, {name}: ATE "
              f"{' '.join(f'{a:.4f}' for a in ates)} m", flush=True)
    frames_k = list(tkitti.SequenceReader(KITTI))
    gt_k = tkitti.parse_ground_truth(os.path.join(KITTI, "poses.txt"))
    cam_k = tcam.parse_kitti_calib(os.path.join(KITTI, "calib.txt"))
    ates = [ate_rmse(StereoVO(Config(), cam_k, seed=s, device="cpu").run(frames_k).poses, gt_k)
            for s in range(8)]
    print(f"port ORB on the CPU, kitti_mini frame by frame, PnP seeds 0-7: ATE "
          f"{' '.join(f'{a:.4f}' for a in ates)} m", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--port", action="store_true", help="also run the port on the CPU")
    args = p.parse_args(argv)
    seq, frames = synthetic()
    svo_tpu_numbers(seq, frames)
    if args.port:
        port_numbers(seq, frames)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
