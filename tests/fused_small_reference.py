"""svo_tpu's fused LK engine beside the port's on euroc_mini (192x320).

    python3 tests/fused_small_reference.py [--frames 40] [--lk-engine fused|patches]
    # CPU, ~2 min for the 40 frames fused

A script, not a test (pytest does not collect it). At 192x320 only the
pyramid levels 0 and 1 pass the fused engine's per-level rule, and on that
sequence the port's fused engine reads a worse ATE than its patches
engine (0.0701 m against 0.0463 m over all 40 frames, on the card and on
the CPU alike). This asks whether svo_tpu's own fused engine does the
same there, frame for frame:

- svo_tpu's StereoVO over the first --frames frames of
  tests/fixtures/euroc_mini, frame by frame on the CPU, with its fused
  LK-level kernel in Pallas interpret mode (SVO_TPU_FUSED_LK=1,
  SVO_TPU_FUSED_INTERPRET=1, as tests/test_lk_fused_pipeline.py runs it;
  PnP seed 0); with --lk-engine patches, its CPU path instead;
- the port's StereoVO on the same frames on the CPU with the same engine
  and svo_tpu's PnP noise replayed by frame (tests/recovery_reference.py's
  replay_noise).

It prints, per frame, the largest position difference between the two
trajectories and whether the feature tables agree (live slots, positions,
point ids), each side's ATE and keyframes; then, at the frame where the
poses differ most, three readings of that one step against svo_tpu's pose
after it: the port's frame step taken from svo_tpu's own state before it,
with that frame's noise; the port's ransac_pnp alone on svo_tpu's tracked
features, points and noise; and svo_tpu's own step with the left image
raised by 1e-3 and by 1e-2 grey levels, which says how far svo_tpu itself
moves on a perturbation of that size. Poses that agree to 1e-4 m make the
engine's ATE at this size svo_tpu's behaviour, not a fault of the port.
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

EUROC_MINI = os.path.join(REPO, "tests", "fixtures", "euroc_mini")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 tests/fused_small_reference.py")
    p.add_argument("--frames", type=int, default=40, help="first N frames of euroc_mini")
    p.add_argument("--lk-engine", default="fused", choices=("fused", "patches"),
                   help="patches: svo_tpu's CPU path beside the port's patches engine")
    args = p.parse_args(argv)
    if args.lk_engine == "fused":  # read when svo_tpu.ops.klt is imported
        os.environ["SVO_TPU_FUSED_LK"] = "1"
        os.environ["SVO_TPU_FUSED_INTERPRET"] = "1"

    import jax

    jax.config.update("jax_platforms", "cpu")
    _ = jax.devices()  # before cv2 and torch
    import numpy as np
    import torch
    from recovery_reference import replay_noise, svo_tpu_noise

    from svo_tpu.config import Config as JConfig
    from svo_tpu.eval.trajectory import ate_rmse
    from svo_tpu.io.euroc import EurocSequence as JEuroc
    from svo_tpu.pipeline.odometry import StereoVO as JStereoVO
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.io.euroc import EurocSequence
    from svo_tpu_torch.pipeline import frontend
    from svo_tpu_torch.pipeline import state as tstate
    from svo_tpu_torch.pipeline.odometry import StereoVO

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    jseq = JEuroc(EUROC_MINI, 0, args.frames)
    H, W = jseq.rectifier.size
    frames = list(iter(jseq))
    t0 = time.perf_counter()
    jvo = JStereoVO(JConfig(use_orb=False, image_height=H, image_width=W), jseq.camera)
    jvo.start(frames[0][1], frames[0][2])
    jstates = [jax.tree.map(np.asarray, jvo.state)]
    for _, left, right in frames[1:]:
        jvo.process(left, right)
        jstates.append(jax.tree.map(np.asarray, jvo.state))
    t_j = time.perf_counter() - t0

    seq = EurocSequence(EUROC_MINI, 0, args.frames)
    cfg = Config(use_orb=False, image_height=H, image_width=W)
    noise = svo_tpu_noise(len(frames) - 1)
    t0 = time.perf_counter()
    vo = StereoVO(cfg, seq.camera, device="cpu", lk_engine=args.lk_engine)
    with replay_noise(noise):
        vo.start(frames[0][1], frames[0][2])
        states = [tstate.to_numpy(vo.state)]
        for _, left, right in frames[1:]:
            vo.process(left, right)
            states.append(tstate.to_numpy(vo.state))
    t_p = time.perf_counter() - t0

    n = len(frames)
    want, got = jstates[-1].poses[:n], states[-1].poses[:n]
    diff = np.linalg.norm(got[:, :3, 3] - want[:, :3, 3], axis=-1)
    for i, (js, ts) in enumerate(zip(jstates, states)):
        jf, tf = js.features, ts.features
        live = jf.valid & tf.valid
        pos = float(np.abs(jf.pos[live] - tf.pos[live]).max()) if live.any() else 0.0
        print(f"frame {i:3d}: |dt| {diff[i]:.3e} m | live slots equal "
              f"{bool((jf.valid == tf.valid).all())} ({int(tf.valid.sum())}), max |dpos| {pos:.2e} "
              f"px, point ids equal {bool((jf.point_id == tf.point_id).all())}, max |dpoint| "
              f"{float(np.abs(js.map.points - ts.map.points).max()):.2e} m")
    gt = jseq.gt_cam_poses()
    m = min(n, len(gt))
    kf_j, kf_t = jstates[-1].kf_flags[:m], states[-1].kf_flags[:m]
    print(f"euroc_mini, {n} frames {H}x{W}, {args.lk_engine}, svo_tpu's PnP noise: max |dt| "
          f"{diff.max():.3e} m at frame {int(diff.argmax())}, |dt| > 1e-4 m at frames "
          f"{np.nonzero(diff > 1e-4)[0].tolist()} | ATE svo_tpu {ate_rmse(want[:m], gt[:m]):.4f} m, "
          f"port {ate_rmse(got[:m], gt[:m]):.4f} m | keyframes svo_tpu {int(kf_j.sum())}, port "
          f"{int(kf_t.sum())}, equal {bool((kf_j == kf_t).all())} | svo_tpu {t_j:.0f} s, port "
          f"{t_p:.0f} s")
    k = int(diff.argmax())
    if k > 0:
        st = frontend.step_body(
            tstate.from_numpy(jstates[k - 1], "cpu"), torch.from_numpy(frames[k][1]),
            torch.from_numpy(frames[k][2]), vo.camera, cfg,
            pnp_noise=torch.from_numpy(noise[k - 1]), lk_engine=args.lk_engine)
        print(f"frame {k} stepped by the port from svo_tpu's state at frame {k - 1}: |dt| "
              f"{np.linalg.norm(st.pose[:3, 3].numpy() - jstates[k].pose[:3, 3]):.3e} m, max "
              f"|dT| {np.abs(st.pose.numpy() - jstates[k].pose).max():.3e} against svo_tpu's "
              f"pose at frame {k}")
        # the PnP alone on svo_tpu's inputs: its tracked features after the
        # step (no purge at an inlier ratio of 1), its points, its noise
        js, jp = jstates[k], jstates[k - 1]
        if js.metrics[k, 1] == 1.0:
            from svo_tpu_torch.geometry import se3
            from svo_tpu_torch.geometry.pnp import ransac_pnp

            M = jp.map.points.shape[0]
            pres = ransac_pnp(
                vo.camera.K, torch.from_numpy(jp.map.points[np.clip(js.features.point_id, 0, M - 1)]),
                torch.tensor(js.features.pos), torch.tensor(js.features.valid),
                torch.from_numpy(noise[k - 1]), cfg.ransac,
                T_init=se3.inverse(torch.from_numpy(jp.pose)))
            print(f"frame {k}: the port's ransac_pnp on svo_tpu's tracked features, points and "
                  f"noise: |dt| {np.linalg.norm(pres.T_wc[:3, 3].numpy() - js.pose[:3, 3]):.3e} m")
        # svo_tpu against itself: the same step with the left image raised
        # by a fraction of a grey level
        import jax.numpy as jnp

        live = js.features.valid
        for delta in (1e-3, 1e-2):
            st = jvo._step(jax.tree.map(jnp.asarray, jp), jvo._prep(frames[k][1] + np.float32(delta)),
                           jvo._prep(frames[k][2]))
            print(f"frame {k}: svo_tpu's own step with the left image + {delta}: max |dpos| "
                  f"{np.abs(np.asarray(st.features.pos)[live] - js.features.pos[live]).max():.2e} "
                  f"px, |dt| {np.linalg.norm(np.asarray(st.pose)[:3, 3] - js.pose[:3, 3]):.3e} m")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
