"""The port's fused LK level against svo_tpu's lk_pallas kernel.

svo_tpu's lk_track_level runs in Pallas interpret mode on the CPU, the
port's on a CPU tensor (so its plain PyTorch version), on the inputs of
tests/test_lk_fused.py made from a numpy seed.

Tolerances: flags (solvable, in_patch) equal on >= 99% of the slots (a
convergence or box test within rounding of its threshold may flip); d
within 1e-3 px where both sides say solvable and in_patch (the bound of
tests/test_lk_fused.py; both are f32, only the order of the window sums
differs); dead slots frozen at the guess in both; min_eig within 1e-4
relative where the slot is live.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_tpu.ops import klt as jklt
from svo_tpu.ops.klt import KltTracker as JKlt
from svo_tpu.ops.lk_pallas import lk_track_level as j_level
from svo_tpu_torch.ops import klt as tklt
from svo_tpu_torch.ops.klt import KltTracker as TKlt
from svo_tpu_torch.ops.lk_fused import lk_track_level as t_level

torch.set_num_threads(2)

H, W = 192, 512 - 2 * jklt._PAD_X


def _world(rng, smooth=2):
    img = np.kron(
        rng.uniform(40, 215, (H // 4, W // 4)).astype(np.float32),
        np.ones((4, 4), np.float32),
    )
    img = img + rng.uniform(-10, 10, img.shape).astype(np.float32)
    for _ in range(smooth):
        img = 0.25 * (
            np.roll(img, 1, 0) + np.roll(img, -1, 0)
            + np.roll(img, 1, 1) + np.roll(img, -1, 1)
        )
    return img.astype(np.float32)


def _shifted(img, shift):
    from scipy.ndimage import map_coordinates

    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    return map_coordinates(
        img, [gy - shift[1], gx - shift[0]], order=1, mode="nearest"
    ).astype(np.float32)


def _levels(img, curr):
    """Padded level-0 images (prev, gx, gy, curr), numpy, via svo_tpu."""
    pp = JKlt.build_pyramid(jnp.asarray(img), 0)
    cp = JKlt.build_pyramid(jnp.asarray(curr), 0)
    return [np.array(a) for a in (pp[0][0], pp[1][0][0], pp[1][0][1], cp[0][0])]


def _both(imgs, pos, valid, guess, *, window, max_iters=12, margin_x=6, margin_y=6):
    """The level through both packages; numpy (d, min_eig, solvable, in_patch)."""
    py = jklt._level_rows(window, imgs[0].shape[0])
    p_pad = (pos + np.array([jklt._PAD_X, jklt._PAD_Y], np.float32)).astype(np.float32)
    kw = dict(window=window, py=py, max_iters=max_iters, eps=1e-3,
              min_eig_threshold=1e-4, margin_x=margin_x, margin_y=margin_y)
    j = j_level(*map(jnp.asarray, imgs), jnp.asarray(p_pad), jnp.asarray(guess),
                jnp.asarray(valid), interpret=True, **kw)
    t = t_level(*map(torch.from_numpy, imgs), torch.from_numpy(p_pad),
                torch.from_numpy(guess), torch.from_numpy(valid), **kw)
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


def _compare(j, t, valid, guess, min_ok):
    (dj, ej, sj, ij), (dt, et, st, it) = j, t
    assert (sj == st).mean() >= 0.99 and (ij == it).mean() >= 0.99
    ok = sj & ij & st & it
    assert ok.sum() >= min_ok, ok.sum()
    np.testing.assert_allclose(dt[ok], dj[ok], rtol=0, atol=1e-3)
    dead = ~valid
    np.testing.assert_array_equal(dt[dead], guess[dead])
    np.testing.assert_array_equal(dj[dead], guess[dead])
    assert not st[dead].any() and not sj[dead].any()
    np.testing.assert_array_equal(et[dead], 0.0)
    np.testing.assert_allclose(et[valid], ej[valid], rtol=1e-4, atol=0)
    return ok


def _interior(rng, n, margin):
    return np.stack(
        [rng.uniform(margin, W - margin, n), rng.uniform(margin, H - margin, n)], -1
    ).astype(np.float32)


@pytest.mark.parametrize("window", [21, 11])
def test_level_matches_lk_pallas_interior(rng, window):
    img = _world(rng)
    shift = np.array([1.3, -0.8], np.float32)
    imgs = _levels(img, _shifted(img, shift))
    pos = _interior(rng, 64, 30)
    valid = np.ones(64, bool)
    guess = np.zeros((64, 2), np.float32)
    j, t = _both(imgs, pos, valid, guess, window=window)
    ok = _compare(j, t, valid, guess, min_ok=64 * 0.9)
    assert np.abs(t[0][ok] - shift).max() < 0.1


def test_level_matches_lk_pallas_guess_and_dead_slots(rng):
    img = _world(rng)
    shift = np.array([4.6, 3.2], np.float32)
    imgs = _levels(img, _shifted(img, shift))
    pos = _interior(rng, 64, 40)
    valid = np.ones(64, bool)
    valid[::5] = False
    guess = np.tile(shift * 0.8, (64, 1)).astype(np.float32)
    j, t = _both(imgs, pos, valid, guess, window=21)
    ok = _compare(j, t, valid, guess, min_ok=valid.sum() * 0.9)
    assert np.abs(t[0][ok] - shift).max() < 0.1


def test_level_matches_lk_pallas_border_features(rng):
    img = _world(rng)
    imgs = _levels(img, _shifted(img, np.array([0.7, 0.4], np.float32)))
    edge = np.array(
        [[1.0, 1.0], [W - 2.0, 1.0], [1.0, H - 2.0], [W - 2.0, H - 2.0],
         [W - 2.0, H / 2], [1.0, H / 2], [W / 2, H - 2.0], [W / 2, 1.0],
         # past the padded level: the corners clamp, the template test fails
         [-40.0, -30.0], [W + 40.0, H + 30.0]],
        np.float32,
    )
    pos = np.concatenate([edge, _interior(rng, 32 - len(edge), 40)])
    valid = np.ones(32, bool)
    guess = np.zeros((32, 2), np.float32)
    j, t = _both(imgs, pos, valid, guess, window=21)
    _compare(j, t, valid, guess, min_ok=(32 - len(edge)) * 0.9)
    out = slice(len(edge) - 2, len(edge))
    assert not t[2][out].any() and not j[2][out].any()


def test_level_matches_lk_pallas_stereo_margins(rng):
    img = _world(rng, smooth=6)
    shift = np.array([-7.5, 0.4], np.float32)
    imgs = _levels(img, _shifted(img, shift))
    pos = _interior(rng, 64, 40)
    valid = np.ones(64, bool)
    guess = np.zeros((64, 2), np.float32)
    j, t = _both(imgs, pos, valid, guess, window=11, max_iters=24, margin_x=16)
    ok = _compare(j, t, valid, guess, min_ok=64 * 0.35)
    # the 16 px x margin lets tracks travel the 7.5 px disparity
    assert (np.abs(t[0][ok] - shift).max(-1) < 0.25).sum() >= 64 * 0.35


# (H, W, py, window, margin_x) -> fused? Padded level sizes of the tracker
# at 376x1241 (all fused), 128x384 (L3 is 112 wide) and 96x256 (L2 is 128
# wide), and each term of svo_tpu/ops/klt.py:262-267 failing alone.
ENGINE_RULE = [
    ((424, 1305, 40, 21, 6), True),
    ((95, 220, 40, 21, 6), True),
    ((95, 220, 32, 11, 16), True),
    ((112, 256, 40, 21, 6), True),
    ((64, 112, 40, 21, 6), False),    # W <= 128
    ((72, 128, 40, 21, 6), False),    # W == 128
    ((39, 320, 40, 21, 6), False),    # H < py
    ((144, 320, 32, 21, 6), False),   # py < w + 2 * _MY
    ((144, 320, 40, 21, 22), False),  # 64 < w + 2 * margin_x + 1
    ((144, 320, 32, 11, 26), True),   # 64 == w + 2 * margin_x + 1
    ((144, 320, 48, 31, 16), True),   # 64 == w + 2 * margin_x + 1, py 48 >= 43
]


@pytest.mark.parametrize("args,fused", ENGINE_RULE)
def test_engine_rule_matches_svo_tpu(args, fused):
    H_, W_, py, w, mx = args
    assert tklt._fused_level_ok(H_, W_, py, w, mx) is fused
    # svo_tpu's own rule with the interpret switch on
    j = W_ > 128 and H_ >= py and py >= w + 2 * jklt._MY and 64 >= w + 2 * mx + 1
    assert j is fused


@pytest.mark.parametrize("bad", [
    dict(W=128), dict(py=36), dict(py=32), dict(margin_x=22),
])
def test_level_preconditions_raise_in_both(bad):
    """svo_tpu asserts (lk_pallas.py:534-539) where the port raises."""
    kw = dict(W=320, py=40, window=21, margin_x=6)
    kw.update(bad)
    Wd, py = kw.pop("W"), kw.pop("py")
    img = np.zeros((64, Wd), np.float32)
    pos = np.full((4, 2), 30.0, np.float32)
    args = dict(py=py, max_iters=2, eps=1e-3, min_eig_threshold=1e-4, **kw)
    with pytest.raises(AssertionError):
        j_level(*[jnp.asarray(img)] * 4, jnp.asarray(pos), jnp.asarray(pos),
                jnp.ones(4, bool), interpret=True, **args)
    with pytest.raises(ValueError):
        t_level(*[torch.from_numpy(img)] * 4, torch.from_numpy(pos),
                torch.from_numpy(pos), torch.ones(4, dtype=torch.bool), **args)


def test_level_non_finite_positions_stay_in_range():
    """NaN and inf positions and guesses index in range and come back not
    solvable; the plain version shares the kernel's clamp-after-cast."""
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.uniform(0, 255, (120, 300)).astype(np.float32))
    pos = torch.tensor([[np.nan, 50.0], [np.inf, -np.inf], [60.0, 60.0], [60.0, 60.0]])
    guess = torch.tensor([[0.0, 0.0], [0.0, 0.0], [np.nan, 0.0], [-np.inf, 1e30]])
    d, me, solv, inp = t_level(
        img, img, img, img, pos, guess, torch.ones(4, dtype=torch.bool),
        window=21, py=40, max_iters=4, eps=1e-3, min_eig_threshold=1e-4,
    )
    assert d.shape == (4, 2) and not solv[:2].any() and not inp[:3].any()


def test_tracker_levels_take_the_fused_engine(monkeypatch):
    """At 128x384 the temporal call runs L0-L2 fused, as ONE whole-call
    launch with no per-level call in that run, and L3 through the patches;
    at 96x544 all four levels are the run; the level-0 forward-backward
    call is a run of one; the patches engine calls neither entry."""
    import dataclasses

    from svo_tpu_torch.config import Config

    levels, runs = [], []
    real_level = tklt.lk_fused.lk_track_level
    real_run = tklt.lk_fused.lk_track_pyramid
    monkeypatch.setattr(tklt.lk_fused, "lk_track_level",
                        lambda *a, **k: levels.append(a[0].shape) or real_level(*a, **k))
    monkeypatch.setattr(
        tklt.lk_fused, "lk_track_pyramid",
        lambda *a, **k: runs.append([lv.shape[1] for lv in a[0]]) or real_run(*a, **k))
    patches = []
    real_patches = tklt.extract_klt_patches
    monkeypatch.setattr(tklt, "extract_klt_patches",
                        lambda *a, **k: patches.append(a[0].shape[1]) or real_patches(*a, **k))
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 255, (128, 384)).astype(np.float32))
    pyr = TKlt.build_pyramid(img, 3)
    pos = torch.from_numpy(rng.uniform(20, 100, (16, 2)).astype(np.float32))
    valid = torch.ones(16, dtype=torch.bool)
    params = Config().temporal_klt
    TKlt.track(pyr, pyr, pos, valid, params)
    assert levels == [] and runs == [] and patches == [112, 160, 256, 448]
    del patches[:]
    TKlt.track(pyr, pyr, pos, valid, params, engine="fused")
    assert runs == [[448, 256, 160]] and levels == [] and patches == [112]
    del runs[:], patches[:]
    fb = dataclasses.replace(params, max_level=0, max_iters=8)
    TKlt.track(pyr, pyr, pos, valid, fb, engine="fused")
    assert runs == [[448]] and levels == [] and patches == []
    del runs[:]
    wide = torch.from_numpy(rng.uniform(0, 255, (96, 544)).astype(np.float32))
    pyr = TKlt.build_pyramid(wide, 3)
    TKlt.track(pyr, pyr, pos, valid, params, engine="fused")
    assert runs == [[608, 336, 200, 132]] and levels == [] and patches == []
    with pytest.raises(ValueError, match="engine"):
        TKlt.track(pyr, pyr, pos, valid, params, engine="xla")
