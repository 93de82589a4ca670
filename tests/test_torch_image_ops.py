"""Parity of the port's image ops with svo_tpu on the same numpy inputs.

- pyramid and Scharr gradients: to 1e-4 (absolute and relative, on images
  in [0, 255]). svo_tpu decimates with a banded matrix product and the
  port with shifted adds: the same five products per output, summed in
  another order, a few ulp at 255.
- FAST, NMS, suppression, selection and detect_fast: IDENTICAL positions,
  order and validity. Their arithmetic is exact (differences, min/max,
  integer keys); the order among tied keys must follow lax.top_k's rule
  (lower index first), which the tied-key cases pin.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_tpu.config import Config as JConfig
from svo_tpu.io.kitti import load_gray
from svo_tpu.io.synthetic import SyntheticSequence
from svo_tpu.ops import detect as jdet
from svo_tpu.ops import fast as jfast
from svo_tpu.ops import nms as jnms
from svo_tpu.ops import pyramid as jpyr
from svo_tpu.ops import select as jsel
from svo_tpu_torch.config import Config as TConfig
from svo_tpu_torch.ops import detect as tdet
from svo_tpu_torch.ops import fast as tfast
from svo_tpu_torch.ops import nms as tnms
from svo_tpu_torch.ops import pyramid as tpyr
from svo_tpu_torch.ops import select as tsel

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI = os.path.join(REPO, "tests", "fixtures", "kitti_mini", "image_2")


def _kitti(i=0):
    return load_gray(os.path.join(KITTI, f"{i:06d}.png"))


def _synthetic(shape=(96, 256), i=0):
    seq = SyntheticSequence(n_frames=i + 1, shape=shape, fx=120.0, speed=0.12, seed=3)
    return seq.frame(i)[0]


def _random(shape=(77, 131), seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


IMAGES = {
    "kitti": _kitti,
    "synthetic": _synthetic,
    "random_odd": _random,  # odd sizes: ceil in pyrDown, ragged buckets
}


def _j(x):
    return np.asarray(x)


def _t(x):
    return x.numpy()


@pytest.mark.parametrize("name", list(IMAGES))
def test_pyramid_and_scharr(name):
    img = IMAGES[name]()
    lj = jpyr.klt_pyramid(jnp.asarray(img), 3)
    lt = tpyr.klt_pyramid(torch.from_numpy(img), 3)
    for a, b in zip(lj, lt):
        assert a.shape == tuple(b.shape)
        np.testing.assert_allclose(_t(b), _j(a), rtol=1e-4, atol=1e-4)
        for ga, gb in zip(jpyr.scharr_gradients(a), tpyr.scharr_gradients(torch.tensor(_j(a)))):
            np.testing.assert_allclose(_t(gb), _j(ga), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", list(IMAGES))
def test_fast_and_nms_identical(name):
    img = IMAGES[name]()
    for thr in (5.0, 20.0):
        sj = jfast.fast_score(jnp.asarray(img), thr)
        st = tfast.fast_score(torch.from_numpy(img), thr)
        np.testing.assert_array_equal(_t(st), _j(sj))
        np.testing.assert_array_equal(_t(tnms.nms3x3(st)), _j(jnms.nms3x3(sj)))


def test_suppression_mask_identical():
    rng = np.random.default_rng(1)
    pos = rng.uniform(-5, 140, (40, 2)).astype(np.float32)  # some off-image
    valid = rng.random(40) > 0.3
    pos[1] = pos[0]  # duplicate hits accumulate
    mj = jnms.suppression_mask((77, 131), jnp.asarray(pos), jnp.asarray(valid), 10)
    mt = tnms.suppression_mask((77, 131), torch.from_numpy(pos), torch.from_numpy(valid), 10)
    np.testing.assert_array_equal(_t(mt), _j(mj))


def test_topk_rounds_ties_and_exhausted_rows():
    rng = np.random.default_rng(2)
    cells = rng.integers(0, 4, (12, 64)).astype(np.float32)  # heavy ties
    cells[3] = -np.inf                 # fully exhausted row
    cells[4, :] = -np.inf
    cells[4, [5, 9]] = [2.0, 2.0]      # two live entries, then exhausted
    cells[5] = 7.0                     # one tied value everywhere
    vj, ij = jsel._topk_rounds(jnp.asarray(cells), 8)
    vt, it = tsel._topk_rounds(torch.from_numpy(cells), 8)
    np.testing.assert_array_equal(_t(vt), _j(vj))
    np.testing.assert_array_equal(_t(it), _j(ij))


def _score_map(kind, shape=(150, 270)):
    rng = np.random.default_rng(3)
    s = np.zeros(shape, np.float32)
    if kind == "tied":
        # every candidate has the same score: order comes from keys alone
        s[rng.random(shape) < 0.05] = 12.0
    elif kind == "two_tier":
        m = rng.random(shape) < 0.03
        s[m] = rng.choice([3.0, 9.0, 15.0, 40.0], m.sum())
    else:  # sparse: fewer candidates than output slots
        s[rng.integers(0, shape[0], 20), rng.integers(0, shape[1], 20)] = 30.0
    return s


@pytest.mark.parametrize("kind", ["tied", "two_tier", "sparse"])
def test_bucketed_topk_identical(kind):
    s = _score_map(kind)
    for gap in (0.0, 15.0):
        outj = jsel.bucketed_topk(jnp.asarray(s), 64, 8, 192, strong_gap=gap)
        outt = tsel.bucketed_topk(torch.from_numpy(s), 64, 8, 192, strong_gap=gap)
        for a, b in zip(outj, outt):
            np.testing.assert_array_equal(_t(b), _j(a))


@pytest.mark.parametrize("kind", ["tied", "sparse"])
def test_global_topk_identical(kind):
    s = _score_map(kind)
    for a, b in zip(jsel.global_topk(jnp.asarray(s), 192), tsel.global_topk(torch.from_numpy(s), 192)):
        np.testing.assert_array_equal(_t(b), _j(a))


@pytest.mark.parametrize("name", ["kitti", "synthetic"])
@pytest.mark.parametrize("bucket", [True, False])
def test_detect_identical(name, bucket):
    """detect_fast and detect (with suppression around live features) give
    the same positions, order, scores and validity."""
    img = IMAGES[name]()
    H, W = img.shape
    kw = dict(use_orb=False, image_height=H, image_width=W)
    cj, ct = JConfig(**kw), TConfig(**kw)
    if not bucket:
        import dataclasses

        cj = dataclasses.replace(cj, bucket=dataclasses.replace(cj.bucket, enabled=False))
        ct = dataclasses.replace(ct, bucket=dataclasses.replace(ct.bucket, enabled=False))
    outj = jdet.detect_fast(jnp.asarray(img), 20.0, None, cj)
    outt = tdet.detect_fast(torch.from_numpy(img), 20.0, None, ct)
    assert int(_j(outj[2]).sum()) > 10
    for a, b in zip(outj, outt):
        np.testing.assert_array_equal(_t(b), _j(a))

    rng = np.random.default_rng(4)
    prev = np.stack([rng.uniform(0, W, 60), rng.uniform(0, H, 60)], -1).astype(np.float32)
    pv = rng.random(60) > 0.3
    outj = jdet.detect(jnp.asarray(img), jnp.asarray(prev), jnp.asarray(pv), cj)
    outt = tdet.detect(torch.from_numpy(img), torch.from_numpy(prev), torch.from_numpy(pv), ct)
    for a, b in zip(outj, outt):
        np.testing.assert_array_equal(_t(b), _j(a))


def test_detect_orb_ported():
    """detect() with Config() (the shipping ORB detector) on a fixture frame
    returns svo_tpu's detections: the same valid positions, scores within
    1e-4 of max |Harris| (tests/test_torch_orb.py holds the parts)."""
    import jax

    img = _kitti(5)
    rng = np.random.default_rng(7)
    prev = np.stack([rng.uniform(0, 320, 30), rng.uniform(0, 96, 30)], -1).astype(np.float32)
    pv = rng.random(30) > 0.5
    cj, ct = JConfig(), TConfig()
    assert cj.use_orb and ct.use_orb
    want = jax.jit(lambda i, p, v: jdet.detect(i, p, v, cj))(
        jnp.asarray(img), jnp.asarray(prev), jnp.asarray(pv))
    want = [np.asarray(w) for w in want]
    got = [g.numpy() for g in tdet.detect(torch.from_numpy(img), torch.from_numpy(prev),
                                           torch.from_numpy(pv), ct)]
    assert got[0].shape == want[0].shape == (ct.capacity.max_detections, 2)
    hmax = float(np.abs(want[1][want[2]]).max())
    res = tdet.compare_orb(want, got, [], 1e-4 * hmax)
    assert res["n_ref"] > 20 and res["flipped"] == 0, res
    np.testing.assert_array_equal(got[2], want[2])
