"""The port's window extraction and write-back (svo_tpu_torch/ba/window.py)
against svo_tpu's on the same maps: the hand-made rings of
tests/test_ba_window.py and seeded random rings that have wrapped around
(rows in no frame order, repeated (frame, point) pairs, more distinct
points and more rows than the window has slots). Every integer and bool
leaf must be identical, floats within 1e-6. Leading axes: a stack of maps
extracts to the stack of the single extractions, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_tpu.ba import window as jwindow
from svo_tpu.config import BaParams, Config
from svo_tpu_torch.ba import window as twindow
from svo_tpu_torch.pipeline.state import MapState as TMapState
from svo_tpu_torch.pipeline.state import tensor
from test_ba_window import _mk_map

torch.set_num_threads(2)

CFG = Config(ba=BaParams(max_points=8, max_obs=16, ring_obs=64))
F = 16


def _tmap(mp) -> TMapState:
    return TMapState(*(tensor(np.asarray(getattr(mp, f))) for f in TMapState._fields))


def _same(got, want, what=""):
    """Leaves of two tuples: ints and bools identical, floats within 1e-6."""
    for name, g, w in zip(type(got)._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (what, name, g.dtype, w.dtype)
        if g.dtype == np.float32:
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=f"{what} {name}")
        else:
            assert np.array_equal(g, w), (what, name)


def _poses(rng=None):
    P = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    P[:, 0, 3] = np.arange(F)
    if rng is not None:
        P[:, :3, 3] += rng.normal(0, 0.3, (F, 3)).astype(np.float32)
        a = rng.normal(0, 0.05, F)
        P[:, 0, 0], P[:, 0, 2], P[:, 2, 0], P[:, 2, 2] = np.cos(a), np.sin(a), -np.sin(a), np.cos(a)
    return P


def _random_ring(seed):
    """A full ring, wrapped: every row written, in no order; ~10% dead."""
    rng = np.random.default_rng(seed)
    O = CFG.ba.ring_obs
    obs = [
        (int(rng.integers(0, 12)), int(rng.integers(0, 14)) if rng.random() > 0.1 else -1,
         float(rng.uniform(0, 300)), float(rng.uniform(0, 200)),
         float(rng.uniform(0, 300)) if rng.random() < 0.4 else -1.0)
        for _ in range(O)
    ]
    mp = _mk_map(CFG, n_pts=14, obs=obs)
    return mp._replace(obs_cursor=jnp.int32(O + 23)), _poses(rng)


HAND_MADE = {
    "selects_and_remaps": [(0, 5, 1, 1, -1), (3, 5, 2, 2, -1), (4, 7, 3, 3, 30.5),
                           (5, 5, 4, 4, -1), (5, 2, 5, 5, -1)],
    "single_mono_gated": [(3, 5, 2, 2, -1), (4, 7, 3, 3, 1.5), (3, 2, 1, 1, -1), (4, 2, 1, 1, -1)],
    "write_back": [(3, 5, 2, 2, -1), (4, 5, 2, 2, -1), (4, 7, 3, 3, 1.0)],
}


def _fixture(name):
    if name in HAND_MADE:
        return _mk_map(CFG, n_pts=10, obs=HAND_MADE[name]), _poses()
    return _random_ring(int(name.split("_")[1]))


ALL = list(HAND_MADE) + ["wrapped_0", "wrapped_1", "wrapped_2"]


@pytest.mark.parametrize("name", ALL)
@pytest.mark.parametrize("n_cams,hi", [(3, 5), (5, 11), (4, 2)])
def test_extract_window_and_write_back(name, n_cams, hi):
    mp, poses = _fixture(name)
    pj, mj = jwindow.extract_window(mp, jnp.asarray(poses), jnp.int32(hi), n_cams=n_cams, n_points=8, n_obs=16)
    tm, tp = _tmap(mp), torch.tensor(poses)
    pt, mt = twindow.extract_window(tm, tp, torch.tensor(hi, dtype=torch.int32), n_cams=n_cams, n_points=8, n_obs=16)
    _same(pt, pj, "problem")
    _same(mt, mj, "mapping")

    rng = np.random.default_rng(hi)
    new_pts = rng.normal(size=(8, 3)).astype(np.float32)
    T_new = np.asarray(pj.T_cw).copy()
    T_new[:, :3, 3] += rng.normal(size=(n_cams, 3)).astype(np.float32)
    mp2, poses2 = jwindow.write_back(
        mp, jnp.asarray(poses), mj, jnp.asarray(T_new), jnp.asarray(new_pts), pj.pnt_valid, pj.cam_valid)
    tm2, tp2 = twindow.write_back(
        tm, tp, mt, torch.tensor(T_new), torch.tensor(new_pts), pt.pnt_valid, pt.cam_valid)
    _same(tm2, mp2, "map after write_back")
    np.testing.assert_allclose(tp2.numpy(), np.asarray(poses2), atol=1e-6, rtol=0)
    assert (tp2 != tp).any() and (tm2.points != tm.points).any() == bool(pt.pnt_valid.any())


KF_CASES = {
    "two_of_three": dict(kfs=[0, 2, 4], n_cams=2, hi=5),
    "padded": dict(kfs=[2], n_cams=4, hi=5),
    "full": dict(kfs=[0, 3, 5, 6, 9, 11], n_cams=4, hi=11),
    "future_keyframes_ignored": dict(kfs=[1, 4, 7, 10], n_cams=3, hi=8),
}


@pytest.mark.parametrize("name", ["selects_and_remaps", "wrapped_0", "wrapped_1", "wrapped_2"])
@pytest.mark.parametrize("case", KF_CASES)
def test_extract_kf_window_and_write_back(name, case):
    c = KF_CASES[case]
    mp, poses = _fixture(name)
    flags = np.zeros(F, bool)
    flags[c["kfs"]] = True
    kw = dict(n_cams=c["n_cams"], n_points=8, n_obs=16)
    pj, mj = jwindow.extract_kf_window(mp, jnp.asarray(poses), jnp.asarray(flags), jnp.int32(c["hi"]), **kw)
    tm, tp = _tmap(mp), torch.tensor(poses)
    hi_t = torch.tensor(c["hi"], dtype=torch.int32)
    pt, mt = twindow.extract_kf_window(tm, tp, torch.tensor(flags), hi_t, **kw)
    _same(pt, pj, "problem")
    _same(mt, mj, "mapping")
    if case == "padded":
        assert mt.cam_fids.tolist() == [-1, -1, -1, 2]

    rng = np.random.default_rng(c["hi"])
    T_wc_new = np.linalg.inv(np.asarray(pj.T_cw))
    T_wc_new[:, :3, 3] += rng.normal(0, 2.0, (c["n_cams"], 3))
    T_cw_new = np.linalg.inv(T_wc_new).astype(np.float32)
    new_pts = rng.normal(size=(8, 3)).astype(np.float32)
    mp2, poses2 = jwindow.write_back_kf(
        mp, jnp.asarray(poses), mj, jnp.int32(c["hi"]), jnp.asarray(T_cw_new), jnp.asarray(new_pts),
        pj.pnt_valid, pj.cam_valid)
    tm2, tp2 = twindow.write_back_kf(
        tm, tp, mt, hi_t, torch.tensor(T_cw_new), torch.tensor(new_pts), pt.pnt_valid, pt.cam_valid)
    _same(tm2, mp2, "map after write_back_kf")
    np.testing.assert_allclose(tp2.numpy(), np.asarray(poses2), atol=1e-5, rtol=0)
    # frames outside [first window keyframe, hi] are bit-equal to the input
    first = min(f for f in c["kfs"] if f <= c["hi"])
    lo = sorted(f for f in c["kfs"] if f <= c["hi"])[-c["n_cams"]:][0]
    assert first <= lo and torch.equal(tp2[:lo], tp[:lo]) and torch.equal(tp2[c["hi"] + 1:], tp[c["hi"] + 1:])
    assert not torch.equal(tp2[lo:c["hi"] + 1], tp[lo:c["hi"] + 1])


def test_stacked_maps_extract_like_single_ones():
    """Leading axes (2, 2): four wrapped rings with their own frame_hi."""
    fixtures = [_random_ring(10 + i) for i in range(4)]
    his = [5, 11, 2, 8]
    kfs = [[0, 2, 4], [1, 4, 7, 10], [2], [0, 3, 5, 6]]

    def stack(xs):
        return torch.stack(xs).reshape((2, 2) + xs[0].shape)

    maps = [_tmap(mp) for mp, _ in fixtures]
    tm = TMapState(*(stack(list(xs)) for xs in zip(*maps)))
    tp = stack([torch.tensor(p) for _, p in fixtures])
    hi = torch.tensor(his, dtype=torch.int32).reshape(2, 2)
    flags = torch.zeros(4, F, dtype=torch.bool)
    for i, k in enumerate(kfs):
        flags[i, k] = True
    whole = twindow.extract_window(tm, tp, hi, n_cams=4, n_points=8, n_obs=16)
    whole_kf = twindow.extract_kf_window(tm, tp, flags.reshape(2, 2, F), hi, n_cams=3, n_points=8, n_obs=16)
    back = twindow.write_back_kf(
        tm, tp, whole_kf[1], hi, whole_kf[0].T_cw.flip(-3), whole_kf[0].points + 1.0,
        whole_kf[0].pnt_valid, whole_kf[0].cam_valid)
    for i in range(4):
        at = (i // 2, i % 2)
        hi_i = torch.tensor(his[i], dtype=torch.int32)
        one = twindow.extract_window(maps[i], tp[at], hi_i, n_cams=4, n_points=8, n_obs=16)
        one_kf = twindow.extract_kf_window(maps[i], tp[at], flags[i], hi_i, n_cams=3, n_points=8, n_obs=16)
        for got, want in zip(whole + whole_kf, one + one_kf):
            for g, w in zip(got, want):
                assert torch.equal(g[at], w)
        m1, p1 = twindow.write_back_kf(
            maps[i], tp[at], one_kf[1], hi_i, one_kf[0].T_cw.flip(-3), one_kf[0].points + 1.0,
            one_kf[0].pnt_valid, one_kf[0].cam_valid)
        assert torch.equal(back[1][at], p1) and torch.equal(back[0].points[at], m1.points)
