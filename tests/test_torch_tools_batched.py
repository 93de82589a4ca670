"""The port's chunk timing tools on the CPU: bench_batched and time_chunk
against a BatchedStereoVO driven directly, and the staging they share.

Two streams of the 25-frame 184x320 synthetic sequence (--small), stream 0
forward and stream 1 reversed, chunk 12 and cadence 6, rendered here with
io/synthetic.py apart from the tools' own staging (_staging.py):

- bench_batched (fused) gives the trajectories of the direct drive with
  the same seed and engine bit for bit, and its ATEs are ate_rmse of those
  trajectories against each stream's ground truth, exactly;
- time_chunk --reps 2 --lk-engine both: the two reps of each engine are
  bit-equal (start() keys the state anew), and each engine's
  trajectories are that engine's direct drive, bit for bit;
- the staging: every chunk holds frame t of stream s (forward for even s,
  reversed for odd) clipped and cast to uint8, frame-major, and the first
  frames as float32;
- without a card and without --device cpu, every tool that drives the
  pipeline refuses before it renders.
"""

import jax  # noqa: F401  (before torch)
import numpy as np
import pytest
import torch

from svo_tpu_torch import (_staging, bench_batched, klt_bench, microbench, profile_chunk,
                           time_chunk)
from svo_tpu_torch.config import Config
from svo_tpu_torch.eval.trajectory import ate_rmse
from svo_tpu_torch.geometry import camera as cam_mod
from svo_tpu_torch.io import synthetic
from svo_tpu_torch.io.synthetic import SyntheticSequence
from svo_tpu_torch.parallel.batched import BatchedStereoVO

torch.set_num_threads(2)

N, S, CH, CAD = 25, 2, 12, 6
SMALL = ["--device", "cpu", "--small", "--streams", str(S), "--frames", str(N)]


def _u8(x):
    return np.clip(x, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def direct():
    """Per engine, the (S, N, 4, 4) trajectories of BatchedStereoVO driven
    on frames rendered here; and the ground truths."""
    seq = SyntheticSequence(n_frames=N, shape=(184, 320), fx=200.0)
    frames = [seq.frame(i) for i in range(N)]
    streams = [frames if s % 2 == 0 else frames[::-1] for s in range(S)]
    cam = cam_mod.from_intrinsics(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2],
                                  seq.baseline)
    cfg = Config(use_orb=False, image_height=184, image_width=320)
    out = {}
    for engine in ("fused", "patches"):
        bvo = BatchedStereoVO(cfg, cam, S, chunk=CH, kf_cadence=CAD, device="cpu",
                              lk_engine=engine)
        bvo.start(np.stack([st[0][0] for st in streams]), np.stack([st[0][1] for st in streams]))
        for c in range((N - 1) // CH):
            ts = range(1 + c * CH, 1 + (c + 1) * CH)
            bvo.process_chunk(*(np.stack([np.stack([_u8(st[t][k]) for st in streams]) for t in ts])
                                for k in (0, 1)))
        out[engine] = bvo.trajectories(N)
    gts = [seq.gt_poses, seq.gt_poses[::-1]]
    return out, gts


def test_bench_batched_equals_direct_drive(direct, capsys):
    trajs, gts = direct
    r, bvo = bench_batched.bench(bench_batched.parse_args(SMALL))
    got = bvo.trajectories(N)
    assert np.array_equal(got, trajs["fused"])
    assert r["ate_fwd_m"] == ate_rmse(got[0], gts[0]) and r["ate_rev_m"] == ate_rmse(got[1], gts[1])
    assert r["ate_per_stream_m"] == [r["ate_fwd_m"], r["ate_rev_m"]]
    assert r["frames"] == N and r["chunks"] == 2 and r["device"] == "cpu"
    assert r["aggregate_fps"] == S * 24 / r["wall_s"] and r["peak_memory_bytes"] is None
    assert "aggregate" in bench_batched.summary_line(r)


def test_time_chunk_reps_and_engines(direct):
    trajs, gts = direct
    r, runs = time_chunk.time_chunks(time_chunk.parse_args(
        SMALL + ["--reps", "2", "--lk-engine", "both"]))
    assert set(r["engines"]) == set(runs) == {"patches", "fused"}
    for engine, reps in runs.items():
        assert len(reps) == 2 and np.array_equal(reps[0], reps[1])
        assert np.array_equal(reps[-1], trajs[engine])
        v = r["engines"][engine]
        assert v["reps_bit_equal"] and len(v["times_s"]) == 2 and v["best_s"] == min(v["times_s"])
        assert v["ate_per_stream_m"] == [ate_rmse(reps[-1][s], gts[s]) for s in range(S)]
    assert not np.array_equal(runs["patches"][0], runs["fused"][0])
    assert len(time_chunk.summary_lines(r)) == 2


def test_staging_layout():
    args = bench_batched.parse_args(["--device", "cpu", "--small", "--streams", "3",
                                     "--frames", "14", "--chunk", "6", "--cadence", "6"])
    st = _staging.stage(args, (184, 320), 200.0)
    seq = SyntheticSequence(n_frames=14, shape=(184, 320), fx=200.0)
    assert st.n_frames == 13 and len(st.chunks) == 2
    for s in range(3):
        first = seq.frame(0 if s % 2 == 0 else 13)
        assert torch.equal(st.l0[s], torch.from_numpy(first[0]))
        assert torch.equal(st.r0[s], torch.from_numpy(first[1]))
        assert np.array_equal(st.gts[s], (seq.gt_poses if s % 2 == 0 else seq.gt_poses[::-1])[:13])
    for c, (ls, rs) in enumerate(st.chunks):
        assert ls.shape == (6, 3, 184, 320) and ls.dtype == torch.uint8
        for i, t in enumerate(range(1 + 6 * c, 7 + 6 * c)):
            for s in range(3):
                left, right = seq.frame(t if s % 2 == 0 else 13 - t)
                assert np.array_equal(ls[i, s].numpy(), _u8(left))
                assert np.array_equal(rs[i, s].numpy(), _u8(right))


@pytest.mark.parametrize("tool", [bench_batched, time_chunk, profile_chunk, klt_bench, microbench])
def test_tool_refuses_without_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(synthetic, "SyntheticSequence",
                        lambda *a, **k: pytest.fail("rendering began without a card"))
    with pytest.raises(RuntimeError, match="is_available"):
        tool.main([])
