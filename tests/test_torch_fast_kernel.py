"""The FAST + NMS kernel (csrc/fast_nms.cu, ops/fast.py::fast_nms) against
its plain version, fast_nms_ref = nms3x3(fast_score(...)) masked.

On the CPU: a CPU tensor takes the plain path and launches nothing; what
the kernel does not take raises ValueError before anything is built or
launched; the kernel's counters are among the frame step's; and the
compass test the kernel zeroes most pixels by, without their windows,
zeroes only pixels that fast_score scores 0.
On the card (marker `chip`; skips without one): the kernel bit for bit
against the plain composition on the same card at the main path's shapes
(376x1241 for 1, 8 and 64 streams, every level of an 8-level 1.2 scale
pyramid of it for 8 streams) and at small and odd shapes, thresholds 5 and
20, with and without a suppression mask, on uint8-valued frames, the
pyramid's non-integer levels, a plateau image and a flat one; a captured
and replayed call against an eager one; the counters; detect() for FAST and
ORB through the kernel against detect() through the plain path. This file
imports no jax, so it runs on the card:

    python3 -m pytest tests/test_torch_fast_kernel.py --noconftest -q
"""

import functools

import numpy as np
import pytest
import torch

from svo_tpu_torch import _build
from svo_tpu_torch.ops import fast

torch.set_num_threads(2)

KITTI = (376, 1241)


@functools.lru_cache(maxsize=8)
def _rendered(n: int, shape, seed: int) -> np.ndarray:
    from svo_tpu_torch.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(n_frames=n, shape=shape, seed=seed)
    return np.stack([seq.frame(i)[0] for i in range(n)])


def frame_stack(S: int, shape=KITTI, seed: int = 0, integer: bool = True) -> np.ndarray:
    """(S, H, W) float32 frames of the synthetic corridor (as the benchmark
    renders them), rounded to uint8 values when `integer`, else as
    rendered. At most 8 are rendered (a 376x1241 frame takes ~1 s); stream
    s past them is frame s % 8 mirrored and shifted by s pixels."""
    base = _rendered(min(S, 8), tuple(shape), seed)
    out = np.stack([base[s] if s < 8 else np.roll(base[s % 8][:, ::-1], s, axis=1)
                    for s in range(S)])
    if integer:
        out = np.clip(np.round(out), 0, 255)
    return np.ascontiguousarray(out, np.float32)


def random_stack(S: int, shape, seed: int = 0) -> np.ndarray:
    """(S, H, W) uint8-valued noise: corners everywhere, many ties."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (S,) + tuple(shape)).astype(np.float32)


def plateau(shape=(64, 96)) -> np.ndarray:
    """Flat 100 with bright 2x2 and 3x3 squares and a bright bar: corners
    whose 3x3 neighbourhoods hold equal scores (NMS ties)."""
    img = np.full(shape, 100.0, np.float32)
    for y in range(8, shape[0] - 8, 12):
        for x in range(8, shape[1] - 8, 12):
            k = 2 + (x // 12) % 2
            img[y:y + k, x:x + k] = 200.0
    img[shape[0] // 2, 10:shape[1] - 10] = 180.0
    return img[None]


def _counts() -> tuple:
    """The kernel's (launches, pixels) counters."""
    c = _build.counters()
    return c["fast_nms.launches"], c["fast_nms.pixels"]


def suppress_mask(shape, seed: int = 1) -> np.ndarray:
    """A bool mask the image's shape: 21x21 squares around random points,
    as nms.suppression_mask makes them."""
    rng = np.random.default_rng(seed)
    m = np.zeros(shape, bool)
    H, W = shape[-2:]
    for idx in np.ndindex(*shape[:-2]):
        for y, x in zip(rng.integers(0, H, 30), rng.integers(0, W, 30)):
            m[idx + (slice(max(y - 10, 0), y + 11), slice(max(x - 10, 0), x + 11))] = True
    return m


# ---- on the CPU -------------------------------------------------------------


def test_cpu_takes_the_plain_path_and_launches_nothing(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path built or loaded the kernel library")

    monkeypatch.setattr(_build, "load", no_build)
    _build.set_counters({"fast_nms.launches": 0, "fast_nms.pixels": 0})
    img = torch.from_numpy(random_stack(2, (40, 70)))
    mask = torch.from_numpy(suppress_mask((2, 40, 70)))
    for m in (None, mask):
        want = fast.nms.nms3x3(fast.fast_score(img, 20.0))
        if m is not None:
            want = torch.where(m, 0.0, want)
        got = fast.fast_nms(img, 20.0, m)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(got, fast.fast_nms_ref(img, 20.0, m))
    assert _counts() == (0, 0)


@pytest.mark.parametrize("case", ["dtype", "strided", "rank", "empty", "mask_dtype",
                                  "mask_shape", "mask_strided", "device"])
def test_unsupported_input_raises_before_any_launch(monkeypatch, case):
    def no_build():
        raise AssertionError("the kernel library was loaded before the input was checked")

    monkeypatch.setattr(_build, "load", no_build)
    _build.set_counters({"fast_nms.launches": 0})
    img = torch.from_numpy(random_stack(2, (40, 70)))
    mask = torch.from_numpy(suppress_mask((2, 40, 70)))
    want = {"dtype": "float32", "strided": "contiguous", "rank": "float32",
            "empty": "streams", "mask_dtype": "bool", "mask_shape": "bool",
            "mask_strided": "bool", "device": "CUDA device"}[case]
    if case == "dtype":
        img = img.double()
    elif case == "strided":
        img = img.transpose(1, 2)
    elif case == "rank":
        img = img.reshape(-1)
    elif case == "empty":
        img = img[:0]
    elif case == "mask_dtype":
        mask = mask.to(torch.uint8)
    elif case == "mask_shape":
        mask = mask[:1]
    elif case == "mask_strided":
        mask = mask.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match=want):
        fast.fast_nms_kernel(img, 20.0, mask)
    assert _counts()[0] == 0


def test_counters_are_the_frame_steps():
    """The kernel's launches and pixels are counters of _build, the ones a
    replay adds to (pipeline/graph.py), and the tracer's drain() names
    them."""
    from svo_tpu_torch.utils import tracing

    assert {"fast_nms.launches", "fast_nms.pixels"} <= set(_build.counters())
    tracing.enable()
    try:
        _build.count("fast_nms.launches")
        _build.count("fast_nms.pixels", 2 * 40 * 70)
        assert tracing.drain()["counters"] == {"fast_nms.launches": 1,
                                               "fast_nms.pixels": 2 * 40 * 70}
    finally:
        tracing.disable()


@pytest.mark.parametrize("kind", ["uint8_noise", "corridor", "corridor_levels", "plateau"])
def test_compass_rejected_pixels_score_zero(kind):
    """The kernel's early zero: a pixel with fewer than 2 of the compass
    points (ring points 0, 4, 8, 12) above +thr and fewer than 2 below -thr
    has fast_score 0, since any 9 contiguous ring points hold 2 of them.
    The kernel's bits are the card tests' to hold."""
    from svo_tpu_torch.ops.pyramid import scale_pyramid

    if kind == "uint8_noise":
        imgs = list(random_stack(2, (37, 61), seed=3))
    elif kind == "corridor":
        imgs = list(frame_stack(1, (96, 256)))
    elif kind == "corridor_levels":
        lv = scale_pyramid(torch.from_numpy(frame_stack(1, (96, 256), integer=False)[0]), 4, 1.2)
        imgs = [x.numpy() for x in lv]
    else:
        imgs = list(plateau())
    assert [fast.RING[i] for i in (0, 4, 8, 12)] == [(0, -3), (3, 0), (0, 3), (-3, 0)]
    n_rejected = n_pos = 0
    for img in imgs:
        for thr in (5.0, 20.0):
            score = fast.fast_score(torch.from_numpy(np.ascontiguousarray(img)), thr).numpy()
            compass = np.stack([np.roll(img, (-dy, -dx), axis=(0, 1)) - img
                                for dx, dy in (fast.RING[i] for i in (0, 4, 8, 12))])
            rejected = (((compass > np.float32(thr)).sum(0) < 2)
                        & ((compass < np.float32(-thr)).sum(0) < 2))
            assert not (score[rejected] != 0).any()
            n_rejected += int(rejected.sum())
            n_pos += int((score > 0).sum())
    assert n_rejected > 0 and n_pos > 0


# ---- on the card --------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: "
                    "python3 -m pytest tests/test_torch_fast_kernel.py --noconftest -q)")
    return torch.device("cuda")


def _bits_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    return got.shape == want.shape and torch.equal(got.view(torch.int32), want.view(torch.int32))


def _check(img: torch.Tensor, thr: float, mask: torch.Tensor | None):
    """The kernel against the plain composition on the same card, bit for
    bit; returns the kernel's map."""
    want = fast.nms.nms3x3(fast.fast_score(img, thr))
    if mask is not None:
        want = torch.where(mask, 0.0, want)
    got = fast.fast_nms(img, thr, mask)
    torch.cuda.synchronize()
    if not _bits_equal(got, want):
        diff = (got.view(torch.int32) != want.view(torch.int32)).nonzero()
        raise AssertionError(f"{int(diff.shape[0])} of {got.numel()} pixels differ from the "
                             f"plain path, first at {diff[:5].tolist()}")
    return got


# (S, H, W): the main path's frames, then small and odd shapes (below one
# 64x16 tile, W odd, H = 7, the 3-pixel border alone, tiles' edges)
SHAPES = [(1,) + KITTI, (8,) + KITTI, (64,) + KITTI,
          (2, 7, 9), (3, 10, 33), (1, 7, 1241), (2, 15, 63), (2, 17, 65), (1, 5, 5),
          (1, 6, 100), (2, 100, 7), (1, 33, 129), (4, 61, 201)]


@pytest.mark.chip
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("thr", [5.0, 20.0])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_bit_equal_to_plain(shape, thr, masked):
    dev = _card()
    S, H, W = shape
    if H * W >= 10_000:
        img = frame_stack(S, (H, W), seed=S)
    else:
        img = random_stack(S, (H, W), seed=H * W)
    img = torch.from_numpy(img).to(dev)
    mask = torch.from_numpy(suppress_mask(shape)).to(dev) if masked else None
    got = _check(img, thr, mask)
    if H * W >= 10_000:  # a real frame has corners left after the mask
        assert int((got > 0).sum()) > 10 * S


@pytest.mark.chip
@pytest.mark.parametrize("thr", [5.0, 20.0])
@pytest.mark.parametrize("integer", [True, False])
def test_kernel_bit_equal_on_every_scale_pyramid_level(integer, thr):
    """ORB's detector input: the 8 levels at 1.2 of 8 streams of 376x1241,
    level 0 uint8-valued or as rendered, levels 1-7 the resize's
    non-integer values."""
    from svo_tpu_torch.ops.pyramid import scale_pyramid

    dev = _card()
    img = torch.from_numpy(frame_stack(8, seed=11, integer=integer)).to(dev)
    levels = scale_pyramid(img, 8, 1.2)
    assert len({tuple(lv.shape) for lv in levels}) == 8
    for lv in levels:
        _check(lv, thr, None)
        _check(lv, thr, torch.from_numpy(suppress_mask(tuple(lv.shape))).to(dev))


@pytest.mark.chip
@pytest.mark.parametrize("kind", ["plateau", "flat", "uint8_noise"])
def test_kernel_bit_equal_on_ties_and_flat_images(kind):
    dev = _card()
    if kind == "plateau":
        img = plateau()
    elif kind == "flat":
        img = np.full((2, 50, 90), 77.0, np.float32)
    else:
        img = random_stack(3, (120, 333), seed=5)
    img = torch.from_numpy(img).to(dev)
    for thr in (5.0, 20.0):
        got = _check(img, thr, None)
        if kind == "flat":
            assert not bool((got != 0).any())
        elif kind == "plateau":  # ties kept: equal neighbours both survive
            g = got[0]
            assert bool(((g > 0) & (g == torch.roll(g, 1, dims=-1))).any())


@pytest.mark.chip
def test_captured_replay_equals_eager_and_counts():
    """fast_nms on the card launches the kernel once a call and counts S x H
    x W pixels, also inside a CUDA graph; a replay with new inputs copied in
    equals an eager call."""
    dev = _card()
    S = 8
    img = torch.from_numpy(frame_stack(S, seed=2)).to(dev)
    mask = torch.from_numpy(suppress_mask((S,) + KITTI)).to(dev)
    _build.set_counters({"fast_nms.launches": 0, "fast_nms.pixels": 0})
    fast.fast_nms(img, 20.0, mask)  # warm-up, builds the library
    assert _counts() == (1, S * KITTI[0] * KITTI[1])
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.cuda.graph(graph):
        out = fast.fast_nms(img, 20.0, mask)
    torch.cuda.current_stream().wait_stream(side)
    assert _counts() == (2, 2 * S * KITTI[0] * KITTI[1])
    for seed in (3, 4):
        img.copy_(torch.from_numpy(frame_stack(S, seed=seed)))
        mask.copy_(torch.from_numpy(suppress_mask((S,) + KITTI, seed=seed)))
        graph.replay()
        want = fast.fast_nms(img, 20.0, mask)
        torch.cuda.synchronize()
        assert _bits_equal(out, want)


@pytest.mark.chip
@pytest.mark.parametrize("use_orb", [False, True])
def test_detect_through_the_kernel_equals_the_plain_path(monkeypatch, use_orb):
    """detect() on the card, with suppression around live features: (pos,
    score, valid) through the kernel bit-equal to detect() with fast_nms
    replaced by the plain composition; one launch a call for FAST, one a
    pyramid level for ORB."""
    from svo_tpu_torch.config import Config
    from svo_tpu_torch.ops import detect

    dev = _card()
    S = 8
    cfg = Config(use_orb=use_orb)
    img = torch.from_numpy(frame_stack(S, seed=6)).to(dev)
    rng = np.random.default_rng(7)
    N = cfg.capacity.max_features
    prev = np.stack([rng.uniform(0, KITTI[1], (S, N)), rng.uniform(0, KITTI[0], (S, N))], -1)
    prev = torch.from_numpy(prev.astype(np.float32)).to(dev)
    pv = torch.from_numpy(rng.random((S, N)) > 0.5).to(dev)
    _build.set_counters({"fast_nms.launches": 0})
    got = detect.detect(img, prev, pv, cfg)
    torch.cuda.synchronize()
    assert _counts()[0] == (cfg.orb_params.pyr_levels if use_orb else 1)
    monkeypatch.setattr(detect.fast, "fast_nms", fast.fast_nms_ref)
    want = detect.detect(img, prev, pv, cfg)
    torch.cuda.synchronize()
    assert int(want[2].sum()) > 10 * S
    for name, g, w in zip(("pos", "score", "valid"), got, want):
        assert torch.equal(g, w) and (g.dtype == torch.bool or _bits_equal(g, w)), name
