"""The stream axis of the port's two kernel wrappers and of the ops around
them, against svo_tpu's batched Pallas rules and against a loop over streams.

On the CPU the wrappers run their plain versions. svo_tpu's kernels run
their natively batched forms (grid (S, N/8), reached through jax.vmap's
custom_vmap rule) in Pallas interpret mode, as tests/test_klt_pallas.py and
tests/test_lk_fused.py run them.

Tolerances:
- patch extraction is a copy: max |diff| == 0.0, batched against svo_tpu and
  against per-stream calls;
- the fused level against lk_pallas: flags equal on >= 99% of the slots, d
  within 1e-3 px where both track, min_eig within 1e-4 relative (textured
  inputs; sums run in another order);
- batched against a loop over streams of the port's own functions: masks
  and integer outputs identical, floats within 1e-5 (a reduction over the
  last axes of (S, N, w, w) may add in another order than over (N, w, w)).
The CUDA kernels' stream axis is held on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_tpu.ops import klt as jklt
from svo_tpu.ops.klt import KltTracker as JKlt
from svo_tpu.ops.klt_pallas import extract_klt_patches as jax_extract
from svo_tpu.ops.lk_pallas import lk_track_level as j_level
from svo_tpu_torch import _build, probe
from svo_tpu_torch.config import Config
from svo_tpu_torch.geometry.pnp import ransac_pnp
from svo_tpu_torch.ops.random import gumbel, prng_key
from svo_tpu_torch.ops import index
from svo_tpu_torch.ops.detect import detect
from svo_tpu_torch.ops.klt import KltTracker as TKlt
from svo_tpu_torch.ops.klt_patches import extract_klt_patches
from svo_tpu_torch.ops.lk_fused import lk_track_level as t_level

torch.set_num_threads(2)

PY, PX = 40, 40
S = 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# patch extraction
# --------------------------------------------------------------------------

def _patch_inputs(rng, H=96, W_true=500, N=32):
    """S streams of four images (true width, and padded to the 128-lane
    tile with garbage for the TPU kernel), corners in the kernel's contract
    (y a multiple of 8), ~30% dead slots."""
    W_pad = ((W_true + 127) // 128) * 128
    imgs = rng.uniform(0.0, 255.0, (4, S, H, W_true)).astype(np.float32)
    garbage = rng.uniform(-1e4, 1e4, (4, S, H, W_pad - W_true)).astype(np.float32)
    padded = np.concatenate([imgs, garbage], -1)
    ty = (rng.integers(0, (H - PY) // 8 + 1, (S, N)) * 8).astype(np.int32)
    cy = (rng.integers(0, (H - PY) // 8 + 1, (S, N)) * 8).astype(np.int32)
    tx = rng.integers(0, W_true - PX + 1, (S, N)).astype(np.int32)
    cx = rng.integers(0, W_true - PX + 1, (S, N)).astype(np.int32)
    tx[:, 0], ty[:, 0] = 0, 0
    tx[:, 1], ty[:, 1] = W_true - PX, ((H - PY) // 8) * 8
    valid = rng.random((S, N)) >= 0.3
    return imgs, padded, (ty, tx, cy, cx), valid


def test_batched_extraction_matches_pallas_batched_rule():
    rng = np.random.default_rng(4)
    imgs, padded, corners, valid = _patch_inputs(rng)
    fn = jax.vmap(
        lambda p, gx, gy, c, a, b, d, e, v: jax_extract(
            p, gx, gy, c, a, b, d, e, v, py=PY, px=PX, interpret=True
        )
    )
    want = fn(*map(jnp.asarray, padded), *map(jnp.asarray, corners), jnp.asarray(valid))
    before = _build.counters()["klt_patches.launches"]
    got = extract_klt_patches(*map(_t, imgs), *map(_t, corners), _t(valid), py=PY, px=PX)
    assert _build.counters()["klt_patches.launches"] == before  # CPU: plain version, no launch
    for g, w in zip(got, want):
        assert tuple(g.shape) == (S, valid.shape[1], PY, PX)
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) == 0.0
    assert all(not g[~_t(valid)].any() for g in got)  # dead slots zeroed


def test_batched_extraction_equals_loop_over_streams():
    rng = np.random.default_rng(5)
    imgs, _, corners, valid = _patch_inputs(rng, H=64, W_true=200, N=24)
    # corners past the borders too: each stream clamps to its own image
    corners[0][:, 2], corners[1][:, 3], corners[3][:, 4] = 500, 10_000, -7
    got = extract_klt_patches(*map(_t, imgs), *map(_t, corners), _t(valid), py=PY, px=PX)
    for s in range(S):
        one = extract_klt_patches(
            *(_t(im[s]) for im in imgs), *(_t(c[s]) for c in corners), _t(valid[s]),
            py=PY, px=PX,
        )
        for g, o in zip(got, one):
            assert torch.equal(g[s], o)


def test_batched_extraction_checks_the_stream_axis():
    img = torch.zeros((S, 64, 80))
    c = torch.zeros((S, 4), dtype=torch.int32)
    v = torch.ones((S, 4), dtype=torch.bool)
    out = extract_klt_patches(img, img, img, img, c, c, c, c, v, py=40, px=40)
    assert tuple(out[0].shape) == (S, 4, 40, 40)
    with pytest.raises(ValueError, match="valid"):  # (N,) valid with (S, H, W) images
        extract_klt_patches(img, img, img, img, c[0], c[0], c[0], c[0], v[0], py=40, px=40)
    with pytest.raises(ValueError, match="valid"):  # another S
        extract_klt_patches(img, img, img, img, c[:2], c[:2], c[:2], c[:2], v[:2], py=40, px=40)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((S, 64, 160))[:, :, ::2]
        extract_klt_patches(t, t, t, t, c, c, c, c, v, py=40, px=40)
    with pytest.raises(ValueError, match=r"\(H, W\) or \(S, H, W\)"):
        extract_klt_patches(img[None], img[None], img[None], img[None], c, c, c, c, v, py=40, px=40)


# --------------------------------------------------------------------------
# the fused LK level
# --------------------------------------------------------------------------

H, W = 192, 512 - 2 * jklt._PAD_X


def _world(rng):
    img = np.kron(
        rng.uniform(40, 215, (H // 4, W // 4)).astype(np.float32), np.ones((4, 4), np.float32)
    )
    img = img + rng.uniform(-10, 10, img.shape).astype(np.float32)
    for _ in range(2):
        img = 0.25 * (np.roll(img, 1, 0) + np.roll(img, -1, 0)
                      + np.roll(img, 1, 1) + np.roll(img, -1, 1))
    return img.astype(np.float32)


def _shifted(img, shift):
    from scipy.ndimage import map_coordinates

    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    return map_coordinates(
        img, [gy - shift[1], gx - shift[0]], order=1, mode="nearest"
    ).astype(np.float32)


@pytest.fixture(scope="module")
def level_inputs():
    """S streams of padded level-0 images (prev, gx, gy, curr) built by
    svo_tpu, positions, a guess, ~20% dead slots."""
    rng = np.random.default_rng(42)
    N = 32
    stacks = [[], [], [], []]
    for s in range(S):
        img = _world(np.random.default_rng(100 + s))
        curr = _shifted(img, np.array([0.9 + 0.3 * s, -0.5], np.float32))
        pp = JKlt.build_pyramid(jnp.asarray(img), 0)
        cp = JKlt.build_pyramid(jnp.asarray(curr), 0)
        for k, a in enumerate((pp[0][0], pp[1][0][0], pp[1][0][1], cp[0][0])):
            stacks[k].append(np.array(a))
    imgs = [np.stack(x) for x in stacks]
    pos = np.stack(
        [rng.uniform(30, W - 30, (S, N)), rng.uniform(30, H - 30, (S, N))], -1
    ).astype(np.float32)
    p_pad = pos + np.array([jklt._PAD_X, jklt._PAD_Y], np.float32)
    guess = rng.uniform(-0.3, 0.3, (S, N, 2)).astype(np.float32)
    valid = rng.random((S, N)) >= 0.2
    kw = dict(window=21, py=jklt._level_rows(21, imgs[0].shape[-2]), max_iters=8,
              eps=1e-3, min_eig_threshold=1e-4)
    return imgs, p_pad, guess, valid, kw


def test_batched_level_matches_lk_pallas_batched_rule(level_inputs):
    imgs, p_pad, guess, valid, kw = level_inputs
    one = lambda pr, gx, gy, cu, pp, g, v: j_level(  # noqa: E731
        pr, gx, gy, cu, pp, g, v, interpret=True, **kw
    )
    dj, ej, sj, ij = (np.asarray(a) for a in jax.vmap(one)(
        *map(jnp.asarray, imgs), jnp.asarray(p_pad), jnp.asarray(guess), jnp.asarray(valid)
    ))
    before = _build.counters()["lk_level.launches"]
    dt, et, st, it = (a.numpy() for a in t_level(
        *map(_t, imgs), _t(p_pad), _t(guess), _t(valid), **kw
    ))
    assert _build.counters()["lk_level.launches"] == before  # CPU: plain version, no launch
    assert dt.shape == guess.shape and st.shape == valid.shape
    assert (sj == st).mean() >= 0.99 and (ij == it).mean() >= 0.99
    ok = sj & ij & st & it
    assert ok.sum() >= 0.9 * valid.sum(), ok.sum()
    np.testing.assert_allclose(dt[ok], dj[ok], rtol=0, atol=1e-3)
    np.testing.assert_allclose(et[valid], ej[valid], rtol=1e-4, atol=0)
    dead = ~valid
    np.testing.assert_array_equal(dt[dead], guess[dead])
    assert not st[dead].any() and not (et[dead] != 0).any()


def test_batched_level_equals_loop_over_streams(level_inputs):
    imgs, p_pad, guess, valid, kw = level_inputs
    got = t_level(*map(_t, imgs), _t(p_pad), _t(guess), _t(valid), **kw)
    # a strided view of a larger stack is made contiguous, not misread
    wide = torch.stack([_t(imgs[0]), _t(imgs[0]).flip(0)], dim=1)[:, 0]
    assert not wide.is_contiguous()
    again = t_level(wide, *map(_t, imgs[1:]), _t(p_pad), _t(guess), _t(valid), **kw)
    for s in range(S):
        one = t_level(*(_t(im[s]) for im in imgs), _t(p_pad[s]), _t(guess[s]), _t(valid[s]), **kw)
        for g, a, o in zip(got, again, one):
            assert torch.equal(g[s], a[s])
            if o.dtype == torch.bool:
                assert torch.equal(g[s], o)
            else:
                torch.testing.assert_close(g[s], o, rtol=0, atol=1e-5)


def test_batched_level_checks_the_stream_axis(level_inputs):
    imgs, p_pad, guess, valid, kw = level_inputs
    args = [*map(_t, imgs), _t(p_pad), _t(guess), _t(valid)]
    with pytest.raises(ValueError, match="valid"):
        t_level(*args[:6], _t(valid[0]), **kw)
    with pytest.raises(ValueError, match="pos"):
        t_level(*args[:4], _t(p_pad[0]), args[5], args[6], **kw)
    with pytest.raises(ValueError, match="one shape"):
        t_level(args[0], args[1][:2], *args[2:], **kw)


# --------------------------------------------------------------------------
# the ops around the kernels: batched == loop over streams
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frames():
    """S stereo pairs and their successors, 96x256, from the renderer."""
    from svo_tpu_torch.io.synthetic import SyntheticSequence

    seqs = [SyntheticSequence(n_frames=2, shape=(96, 256), fx=120.0, speed=0.12, seed=3 + s)
            for s in range(S)]
    f0 = [q.frame(0) for q in seqs]
    f1 = [q.frame(1) for q in seqs]
    return (_t(np.stack([f[0] for f in f0])), _t(np.stack([f[1] for f in f0])),
            _t(np.stack([f[0] for f in f1])))


def _close(batched, single, s):
    for b, o in zip(batched, single):
        if o.dtype.is_floating_point:
            torch.testing.assert_close(b[s], o, rtol=0, atol=1e-5)
        else:
            assert torch.equal(b[s], o)


def test_detect_batched_equals_loop(frames):
    left0, _, _ = frames
    cfg = Config(use_orb=False, image_height=96, image_width=256)
    rng = np.random.default_rng(0)
    prev = _t(rng.uniform(0, [256, 96], (S, 40, 2)).astype(np.float32))
    prev_valid = _t(rng.random((S, 40)) > 0.3)
    got = detect(left0, prev, prev_valid, cfg)
    assert tuple(got[0].shape) == (S, cfg.capacity.max_detections, 2)
    for s in range(S):
        one = detect(left0[s], prev[s], prev_valid[s], cfg)
        _close(got, one, s)
        assert int(one[2].sum()) > 20
    assert not torch.equal(got[0][0], got[0][1])  # the streams do differ


@pytest.mark.parametrize("engine", ["patches", "fused"])
@pytest.mark.parametrize("call", ["temporal", "stereo"])
def test_klt_track_batched_equals_loop(frames, engine, call):
    left0, right0, left1 = frames
    cfg = Config(use_orb=False, image_height=96, image_width=256)
    params = cfg.temporal_klt if call == "temporal" else cfg.stereo_klt
    curr = left1 if call == "temporal" else right0
    pos, _, valid = detect(left0, torch.zeros((S, 1, 2)), torch.zeros((S, 1), dtype=torch.bool), cfg)
    pyr_p = TKlt.build_pyramid(left0, params.max_level)
    pyr_c = TKlt.build_pyramid(curr, params.max_level)
    got = TKlt.track(pyr_p, pyr_c, pos, valid, params, engine=engine)
    assert int(got.status.sum()) > 0.5 * int(valid.sum())
    for s in range(S):
        one = TKlt.track(
            TKlt.build_pyramid(left0[s], params.max_level),
            TKlt.build_pyramid(curr[s], params.max_level),
            pos[s], valid[s], params, engine=engine,
        )
        assert torch.equal(got.status[s], one.status)
        ok = one.status
        torch.testing.assert_close(got.pos[s][ok], one.pos[ok], rtol=0, atol=1e-5)
        torch.testing.assert_close(got.err[s][ok], one.err[ok], rtol=1e-4, atol=1e-5)


def test_ransac_pnp_batched_equals_loop():
    rng = np.random.default_rng(7)
    cfg = Config()
    N, hyp = 64, cfg.ransac.num_hypotheses
    K = torch.tensor([[120.0, 0, 128.0], [0, 120.0, 48.0], [0, 0, 1.0]])
    Xw = rng.uniform([-4, -2, 4], [4, 2, 20], (S, N, 3)).astype(np.float32)
    uv, T_prior = [], []
    for s in range(S):
        t = np.array([0.05 * s, 0.0, 0.2 + 0.1 * s], np.float32)
        Xc = Xw[s] - t
        p = np.stack([120 * Xc[:, 0] / Xc[:, 2] + 128, 120 * Xc[:, 1] / Xc[:, 2] + 48], -1)
        p += rng.normal(0, 0.2, p.shape)
        p[:: 5 + s] += rng.uniform(20, 60, p[:: 5 + s].shape)  # outliers
        uv.append(p.astype(np.float32))
        T_prior.append(np.eye(4, dtype=np.float32))
    uv, T_prior = _t(np.stack(uv)), _t(np.stack(T_prior))
    Xw = _t(Xw)
    valid = _t(rng.random((S, N)) > 0.1)
    noise = gumbel(prng_key(np.arange(S) + 10), (hyp, N))
    assert tuple(noise.shape) == (S, hyp, N)
    assert not torch.equal(noise[0], noise[1])  # each stream its own row

    got = ransac_pnp(K, Xw, uv, valid, noise, cfg.ransac, T_init=T_prior)
    assert tuple(got.T_wc.shape) == (S, 4, 4) and tuple(got.ok.shape) == (S,)
    assert bool(got.ok.all())
    for s in range(S):
        one = ransac_pnp(K, Xw[s], uv[s], valid[s], noise[s], cfg.ransac, T_init=T_prior[s])
        assert torch.equal(got.inliers[s], one.inliers)
        assert bool(got.ok[s]) == bool(one.ok)
        torch.testing.assert_close(got.T_wc[s], one.T_wc, rtol=0, atol=1e-5)
        torch.testing.assert_close(got.inlier_ratio[s], one.inlier_ratio, rtol=0, atol=1e-6)
        # the pose is the stream's own: t_z follows 0.2 + 0.1 s
        assert abs(float(one.T_wc[2, 3]) - (0.2 + 0.1 * s)) < 0.05
    with pytest.raises(ValueError, match="noise"):
        ransac_pnp(K, Xw, uv, valid, noise[0], cfg.ransac)


def test_index_helpers_follow_jax_semantics():
    """take_rows / gather_hw are x[idx] per stream; scatter_drop is
    .at[idx].set(src, mode="drop") per stream."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(S, 10, 3)).astype(np.float32)
    idx = rng.integers(0, 10, (S, 4, 6))
    got = index.take_rows(_t(x), _t(idx), k=2).numpy()
    np.testing.assert_array_equal(got, np.stack([x[s][idx[s]] for s in range(S)]))
    img = rng.normal(size=(S, 7, 9)).astype(np.float32)
    r, c = rng.integers(0, 7, (S, 5, 1)), rng.integers(0, 9, (S, 1, 4))
    got = index.gather_hw(_t(img), _t(r), _t(c)).numpy()
    np.testing.assert_array_equal(got, np.stack([img[s][r[s], c[s]] for s in range(S)]))

    dst = rng.normal(size=(S, 8, 3)).astype(np.float32)
    src = rng.normal(size=(S, 5, 3)).astype(np.float32)
    where = np.array([[0, 7, 8, -1, 3], [9, 9, 9, 9, 9], [4, 2, 0, 1, 100]])
    # svo_tpu sends a negative index to n before the scatter (jax would
    # count it from the end); the port drops it like any out-of-range row
    want = jax.vmap(lambda d, i, v: d.at[i].set(v, mode="drop"))(
        jnp.asarray(dst), jnp.asarray(np.where(where < 0, 8, where)), jnp.asarray(src)
    )
    got = index.scatter_drop(_t(dst), _t(where), _t(src))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        index.scatter_drop(_t(dst[0]), _t(where[0]), _t(src[0])).numpy(), np.asarray(want[0])
    )


# --------------------------------------------------------------------------
# the probes' plain versions (the kernels run on the card only)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("p", probe.PROBES, ids=lambda p: p.name)
def test_probe_plain_versions(p):
    x, o = probe.make_inputs(0)
    assert x.shape == (32, 48, 64) and o.shape == (32, 8)
    before = _build.counters()["probe.launches"]
    got = probe.run_probe(p, x, o)
    assert _build.counters()["probe.launches"] == before  # CPU: plain version, no launch
    assert tuple(got.shape) == (32, 1) and bool(torch.isfinite(got).all())
    if p.name == "float2int-clamp":
        # NaN, +inf, -inf land on the clamp's ends; finite values inside
        assert got[:3, 0].tolist() == [0.0, float(probe.CORNER_HI), 0.0]
        assert float(got.min()) >= 0 and float(got.max()) <= probe.CORNER_HI
        assert 0 < float(got[3:].median()) < probe.CORNER_HI
    if p.name == "3d-window-unaligned":
        np.testing.assert_allclose(
            got[:, 0].numpy(), x.numpy()[:, 0:34, 3:24].sum((1, 2)), rtol=1e-5
        )


def test_probe_rejects_wrong_inputs_and_reports_no_card():
    x, o = probe.make_inputs(0)
    with pytest.raises(ValueError, match="expected"):
        probe.run_probe(probe.PROBES[0], x[:, :10], o)
    with pytest.raises(ValueError, match="float32"):
        probe.run_probe(probe.PROBES[0], x.double(), o)
    if not torch.cuda.is_available():
        assert probe.main() == 1
