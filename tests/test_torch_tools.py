"""The port's developer tools on the CPU: the patch self-test, klt_bench,
microbench and profile_chunk, each against svo_tpu's counterpart where one
computes the same thing.

- Self-test (svo_tpu_torch/ops/klt.py::patch_extraction_selftest, the
  counterpart of svo_tpu/ops/klt.py:434): on tests/test_klt_pallas.py:134's
  image (120x300 from default_rng(6), n=48) it reads exactly 0.0. Its
  geometry equals svo_tpu's exactly (padded image, patch size, corners);
  its slicing reference, given svo_tpu's padded image and gradients,
  equals svo_tpu's dynamic_slice windows bit for bit, and the port's own
  gradients are within the 1e-4 of tests/test_torch_image_ops.py. An image
  too small for one patch raises ValueError in both packages.
- klt_bench: the three parameter sets with the patches engine on the CPU
  against svo_tpu's KltTracker.track on the same 376x1241 pair and 256
  features: status identical, median error against the known shift within
  1e-3 px (the engines' parity bound, tests/test_torch_klt.py).
- microbench: its example state equals __graft_entry__._example_state's
  leaf for leaf (through state.from_numpy), and --small --reps 1 gives
  every stage a finite time.
- profile_chunk: --small --streams 2 (one 6-frame chunk, cadence 6, to keep
  the file short) returns its tables sorted, longest first, each summing to
  the total within 1e-9 relative (float sums in another order), with a
  device busy share and host ops; kind() strips template arguments and
  parameters. records(), which reads the trace's raw records, gives each
  host op's self CPU time as key_averages() does (within 1e-6 ms by name,
  on a seeded CPU workload with nested ops).
"""

import math

import jax  # noqa: F401  (before torch)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_tpu_torch import klt_bench, microbench, profile_chunk
from svo_tpu_torch.ops import klt as tklt

torch.set_num_threads(2)


def _selftest_image():
    rng = np.random.default_rng(6)
    return rng.uniform(0, 255, (120, 300)).astype(np.float32)


def test_patch_extraction_selftest_reads_zero():
    assert tklt.patch_extraction_selftest(_selftest_image(), n=48) == 0.0


def test_selftest_reference_equals_svo_tpus():
    from svo_tpu.ops import klt as jklt
    from svo_tpu.ops.pyramid import scharr_gradients

    img, n, w = _selftest_image(), 48, 21
    # svo_tpu's self-test up to its reference windows (svo_tpu/ops/klt.py:452-486)
    img_j = jnp.pad(jnp.asarray(img), ((jklt._PAD_Y,) * 2, (jklt._PAD_X,) * 2), mode="edge")
    gx_j, gy_j = scharr_gradients(img_j)
    H, W = img_j.shape
    py, px = jklt._level_rows(w, H), jklt._patch_cols(w, 6)
    rng = np.random.default_rng(0)
    pos = np.stack([rng.uniform(0, W - 1, n).astype(np.float32),
                    rng.uniform(0, H - 1, n).astype(np.float32)], axis=-1)
    guess = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    cj = [np.asarray(c) for c in
          jklt._corners(jnp.asarray(pos), jnp.asarray(guess), H, W, py, px, w, 6)]
    tc, cc = jnp.stack([cj[0], cj[1]], -1), jnp.stack([cj[2], cj[3]], -1)
    want = [np.asarray(jklt._extract_patches_xla(a, c, py, px))
            for a, c in ((img_j, tc), (gx_j, tc), (gy_j, tc), (img_j, cc))]

    (img_p, gx, gy), corners, py_t, px_t = tklt.selftest_geometry(torch.from_numpy(img), n, w, 0)
    assert (py_t, px_t) == (py, px)
    np.testing.assert_array_equal(img_p.numpy(), np.asarray(img_j))
    for a, b in zip(corners, cj):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in ((gx, gx_j), (gy, gy_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)
    ty0, tx0, cy0, cx0 = corners
    ref = [torch.from_numpy(np.array(a)) for a in (img_j, gx_j, gy_j)]
    got = [tklt.slice_windows(a, ty0, tx0, py, px) for a in ref]
    got.append(tklt.slice_windows(ref[0], cy0, cx0, py, px))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w_)


@pytest.mark.parametrize("package", ["svo_tpu", "svo_tpu_torch"])
def test_selftest_too_small_image_raises(package):
    if package == "svo_tpu":
        from svo_tpu.ops.klt import patch_extraction_selftest
    else:
        patch_extraction_selftest = tklt.patch_extraction_selftest
    # a 41-px window needs 56 patch rows; 4 rows padded by 2 x 24 hold 48
    with pytest.raises(ValueError, match="too small"):
        patch_extraction_selftest(np.zeros((4, 300), np.float32), window=41)


@pytest.fixture(scope="module")
def klt_runs():
    """klt_bench with the patches engine on the CPU, and svo_tpu's
    KltTracker.track on the same inputs, per parameter set."""
    import jax

    from svo_tpu.config import KltParams as JKltParams
    from svo_tpu.ops.klt import KltTracker as JKlt

    result, outs = klt_bench.bench(klt_bench.parse_args(
        ["--device", "cpu", "--lk-engine", "patches", "--reps", "1"]))
    img0, img1, pos = klt_bench.inputs(376, 1241)
    p0, p1 = JKlt.build_pyramid(jnp.asarray(img0), 3), JKlt.build_pyramid(jnp.asarray(img1), 3)
    want = {}
    for name, prm in klt_bench.param_sets():
        jp = JKltParams(window=prm.window, max_level=prm.max_level, max_iters=prm.max_iters)
        out = jax.jit(lambda a, b, p, v, jp=jp: JKlt.track(a, b, p, v, jp))(
            p0, p1, jnp.asarray(pos), jnp.ones(len(pos), bool))
        want[name] = (np.asarray(out.pos), np.asarray(out.status))
    return result, outs, pos, want


@pytest.mark.parametrize("k", range(3))
def test_klt_bench_matches_svo_tpu(klt_runs, k):
    result, outs, pos, want = klt_runs
    row = result["calls"][k]
    name = row["name"]
    status = outs[name].status.numpy()
    np.testing.assert_array_equal(status, want[name][1])
    survived, med = klt_bench.accuracy(pos, *want[name])
    assert row["survived_pct"] == survived
    assert abs(row["median_err_px"] - med) <= 1e-3, (row, med)
    assert row["ms"] > 0 and result["pyramid_ms"] > 0
    assert result["image"] == "376x1241" and result["features"] == 256


def test_microbench_example_state_equals_graft_entry():
    import __graft_entry__ as ge
    import jax

    from svo_tpu.geometry import camera as jcam
    from svo_tpu_torch.config import BaParams, Capacity, Config, RansacParams
    from svo_tpu_torch.pipeline import state as tstate

    H, W = 96, 128
    jcfg = ge._small_cfg(H, W)
    want = jax.tree.map(np.asarray, ge._example_state(
        jcfg, jcam.from_intrinsics(200.0, 200.0, W / 2, H / 2, 0.54)))
    cfg = Config(use_orb=False, image_height=H, image_width=W,
                 capacity=Capacity(max_features=64, max_points=4096, max_frames=32,
                                   max_detections=64),
                 ransac=RansacParams(num_hypotheses=32, refine_iters=5),
                 ba=BaParams(max_points=256, max_obs=1024))
    got = tstate.leaves(microbench.example_state(cfg, "cpu"))
    ref = tstate.leaves(tstate.from_numpy(want, "cpu"))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_microbench_times_every_stage(capsys):
    assert microbench.main(["--device", "cpu", "--small", "--reps", "1"]) == 0
    out = capsys.readouterr().out
    r = microbench.bench(microbench.parse_args(["--device", "cpu", "--small", "--reps", "1"]))
    names = [x["name"] for x in r["stages"]]
    assert len(names) == 10 and names[-1].startswith("FULL STEP")
    for x in r["stages"]:
        assert math.isfinite(x["ms"]) and x["ms"] > 0, x
        assert x["name"] in out


@pytest.mark.parametrize("name,want", [
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, "
     "std::array<char*, 1ul> >(int, at::native::FillFunctor<float>, std::array<char*, 1ul>)",
     "at::native::vectorized_elementwise_kernel"),
    ("void (anonymous namespace)::lk_level_kernel<3>((anonymous namespace)::TrackArgs)",
     "lk_level_kernel"),
    ("void std::enable_if<!(false), void>::type internal::gemvx::kernel<int, int, float, float, "
     "false, true, true, false, 7, false, cublasGemvParamsEx<int, float const*>>(cublasGemv"
     "ParamsEx<int, float const*>)", "internal::gemvx::kernel"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, unsigned int, 3, 64, "
     "64>(float*, at::native::(anonymous namespace)::CatArrInputTensorMetadata<float>)",
     "at::native::CatArrayBatchedCopy"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize32x32x8_stage3_warpsize1x2x1_ffma_cublas",
     "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize32x32x8_stage3_warpsize1x2x1_ffma_cublas"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
    ("Memset (Device)", "Memset"),
    ("aten::add", "aten::add"),
])
def test_profile_kind(name, want):
    assert profile_chunk.kind(name) == want


def test_profile_chunk_tables():
    r = profile_chunk.profile(profile_chunk.parse_args(
        ["--device", "cpu", "--small", "--streams", "2", "--chunk", "6", "--cadence", "6",
         "--frames", "13", "--lk-engine", "patches"]))
    assert r["device"] == "cpu" and r["streams"] == 2
    for key in ("by_name", "by_kind", "host_ops"):
        rows = r[key]
        assert rows, key
        assert [x["ms"] for x in rows] == sorted((x["ms"] for x in rows), reverse=True)
        assert all(x["count"] > 0 for x in rows)
        assert math.isclose(sum(x["ms"] for x in rows), r["device_ms"], rel_tol=1e-9)
    assert sum(x["count"] for x in r["by_kind"]) == r["device_activities"]
    assert 0 < r["busy_share"] and r["traced_wall_ms"] > 0 and r["warm_wall_ms"] > 0
    assert r["busy_share_untraced"] == r["device_ms"] / r["warm_wall_ms"]
    assert len(profile_chunk.report(r, 5)) == 4 + min(18, len(r["by_kind"])) + 10


def test_profile_records_match_key_averages():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((48, 48)).astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(20):
            x = torch.linalg.solve(x @ x.T + 3 * torch.eye(48), torch.tanh(x)).softmax(-1)
    device, host = profile_chunk.records(prof)
    assert device == []
    got = {r["name"]: r["ms"] for r in profile_chunk.table(host)}
    want = {e.key: e.self_cpu_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CPU}
    assert set(got) == set(want)
    for name, ms in want.items():
        assert abs(got[name] - ms) <= 1e-6, name
