"""The port's ORB detector against svo_tpu's on the same numpy inputs.

Tolerances. sobel_gradients and global_topk_signed do exact arithmetic
(products by small integers, sums of three terms in one order, a stable
sort): identical. resize_linear (a matrix product), box_filter (prefix
sums) and harris_response (both) add in another order than XLA does:
max |diff| / max |svo_tpu| <= 1e-4 (read: ~4e-7 for Harris at 160x224,
~2e-6 on the 96x320 fixture frame). detect_orb is compared as sets of
valid positions (ops/detect.compare_orb): at most 2% of the valid slots
may flip, each flipped candidate's score within 1e-4 of max |Harris| of a
cut-off score. On these images the sets are equal, each position's score
within 1e-4 of max |Harris|; the order may not be (two Harris values
2e-7 apart swap places on the fixture frame with suppression). An (S, H, W) stack detects exactly as a loop over
streams, and a suppressed square holds no detection.

svo_tpu's functions are jitted once per shape: run eagerly, XLA compiles
every op of the 8-level detector anew (~60 s at 96x320).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_tpu.config import Config as JConfig
from svo_tpu.io.kitti import load_gray
from svo_tpu.ops import detect as jdet
from svo_tpu.ops import harris as jharris
from svo_tpu.ops import pyramid as jpyr
from svo_tpu.ops import select as jsel
from svo_tpu_torch.config import Config as TConfig
from svo_tpu_torch.ops import detect as tdet
from svo_tpu_torch.ops import harris as tharris
from svo_tpu_torch.ops import pyramid as tpyr
from svo_tpu_torch.ops import select as tsel

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "kitti_mini", "image_2", "000003.png")
REL = 1e-4


def _checker(h=160, w=224, seed=0):
    """tests/test_detect.py's textured image: random blobs on noise."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 60, (h, w)).astype(np.float32)
    for _ in range(12):
        y, x = rng.integers(10, h - 20), rng.integers(10, w - 20)
        img[y : y + 9, x : x + 9] += rng.uniform(100, 180)
    return np.clip(img, 0, 255)


IMAGES = {"checker_160x224": _checker, "kitti_mini_96x320": lambda: load_gray(FIXTURE)}


def _cfgs(img, **kw):
    H, W = img.shape
    return (JConfig(use_orb=True, image_height=H, image_width=W, **kw),
            TConfig(use_orb=True, image_height=H, image_width=W, **kw))


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", params=sorted(IMAGES))
def img(request):
    return IMAGES[request.param]()


def test_sobel_and_box_filter(img):
    jx, jy = jax.jit(jpyr.sobel_gradients)(jnp.asarray(img))
    tx, ty = tpyr.sobel_gradients(torch.from_numpy(img))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    prod = np.asarray(jx) * np.asarray(jy)
    for size in (3, 7, 21):
        want = jax.jit(jpyr.box_filter, static_argnums=1)(jnp.asarray(prod), size)
        got = tpyr.box_filter(torch.from_numpy(prod), size)
        assert _rel(got.numpy(), want) <= REL, size


def test_resize_and_scale_pyramid(img):
    H, W = img.shape
    for nh, nw in ((H // 2 + 3, W // 3), (H + 7, W + 5), (16, 16)):
        want = jax.jit(jpyr.resize_linear, static_argnums=(1, 2))(jnp.asarray(img), nh, nw)
        got = tpyr.resize_linear(torch.from_numpy(img), nh, nw)
        assert got.shape == want.shape
        assert _rel(got.numpy(), want) <= REL
    want = jax.jit(lambda x: jpyr.scale_pyramid(x, 8, 1.2))(jnp.asarray(img))
    got = tpyr.scale_pyramid(torch.from_numpy(img), 8, 1.2)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= REL
    # (S, H, W) equals a loop over streams
    stack = np.stack([img, img[::-1].copy(), np.roll(img, 17, axis=1)])
    batched = tpyr.scale_pyramid(torch.from_numpy(stack), 8, 1.2)
    for s in range(3):
        for b, one in zip(batched, tpyr.scale_pyramid(torch.from_numpy(stack[s]), 8, 1.2)):
            assert torch.equal(b[s], one)


def test_harris_response(img):
    want = jax.jit(jharris.harris_response)(jnp.asarray(img))
    got = tharris.harris_response(torch.from_numpy(img))
    assert _rel(got.numpy(), want) <= REL
    stack = torch.from_numpy(np.stack([img, img[::-1].copy()]))
    batched = tharris.harris_response(stack)
    for s in range(2):
        assert torch.equal(batched[s], tharris.harris_response(stack[s]))


def test_global_topk_signed_ties():
    """Mostly -inf keys, repeated finite keys: the lower flat index first,
    per stream, as lax.top_k."""
    rng = np.random.default_rng(5)
    score = np.full((3, 20, 30), -np.inf, np.float32)
    live = rng.random(score.shape) < 0.05
    score[live] = rng.choice([-3.0, 0.5, 2.0], live.sum()).astype(np.float32)
    for k in (5, 40, 200):
        got = tsel.global_topk_signed(torch.from_numpy(score), k)
        for s in range(3):
            want = jax.jit(jsel.global_topk_signed, static_argnums=1)(jnp.asarray(score[s]), k)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a[s].numpy(), np.asarray(b))


def _cutoffs(img_t, cfg, out):
    """Each level's quota cut-off and the merge's (the lowest valid score
    of a full output)."""
    cuts = [float(s[..., -1]) for _, s in tdet.orb_candidates(img_t, cfg)]
    _, score, valid = out
    if bool(valid.all()):
        cuts.append(float(score[-1]))
    return cuts


def _same_detections(got, want, hmax):
    """The same set of valid positions, each with its score (a Harris
    value) within 1e-4 of max |Harris|."""
    got, want = [g.numpy() for g in got], [np.asarray(w) for w in want]
    res = tdet.compare_orb(want, got, [], REL * hmax)
    assert res["flipped"] == 0 and res["n_ref"] > 10, res
    def by_pos(pos, score, valid):  # a position may come from two levels
        out = {}
        for p, s, v in zip(pos, score, valid):
            if v:
                out.setdefault(tuple(p), []).append(s)
        return {k: np.sort(v) for k, v in out.items()}

    ours = by_pos(*got)
    for p, s in by_pos(*want).items():
        assert np.abs(ours[p] - s).max() <= REL * hmax


def test_detect_orb(img):
    cj, ct = _cfgs(img)
    want = [np.asarray(x) for x in jax.jit(lambda x: jdet.detect_orb(x, None, cj))(jnp.asarray(img))]
    img_t = torch.from_numpy(img)
    got = tdet.detect_orb(img_t, None, ct)
    hmax = float(tharris.harris_response(img_t).abs().max())
    res = tdet.compare_orb(want, [g.numpy() for g in got], _cutoffs(img_t, ct, got), REL * hmax)
    assert res["n_ref"] > 20 and res["ok"], res
    _same_detections(got, want, hmax)  # on these images: no flip at all
    # an (S, H, W) stack detects per stream, exactly as one stream at a time
    stack = torch.from_numpy(np.stack([img, img[::-1].copy(), np.roll(img, 17, axis=1)]))
    batched = tdet.detect_orb(stack, None, ct)
    for s in range(3):
        one = tdet.detect_orb(stack[s], None, ct)
        for b, o in zip(batched, one):
            assert torch.equal(b[s], o)


def test_detect_orb_suppression(img):
    """detect() with Config()'s ORB and previous features: svo_tpu's
    detections, none inside a suppressed square."""
    cj, ct = _cfgs(img)
    H, W = img.shape
    rng = np.random.default_rng(2)
    prev = np.stack([rng.uniform(0, W, 40), rng.uniform(0, H, 40)], -1).astype(np.float32)
    pv = rng.random(40) > 0.3
    want = jax.jit(lambda i, p, v: jdet.detect(i, p, v, cj))(
        jnp.asarray(img), jnp.asarray(prev), jnp.asarray(pv))
    img_t = torch.from_numpy(img)
    got = tdet.detect(img_t, torch.from_numpy(prev), torch.from_numpy(pv), ct)
    _same_detections(got, want, float(tharris.harris_response(img_t).abs().max()))
    pos, valid = got[0].numpy(), got[2].numpy()
    assert valid.sum() > 10
    cells = np.floor(prev[pv]).astype(int)
    det = np.floor(pos[valid]).astype(int)
    cheb = np.abs(det[:, None, :] - cells[None, :, :]).max(-1)
    assert cheb.min() > ct.mask_halfwidth
