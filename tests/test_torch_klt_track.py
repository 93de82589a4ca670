"""The patches engine's tracker call in one launch (csrc/klt_track.cu,
ops/klt_track.py) against its plain version, the chain of ops/klt.py's
_patch_level calls with the glue between levels.

On the CPU: the wrapper's plain path is the per-level _patch_level loop
(written out here as the tracker ran it before the kernel) bit for bit at
the temporal, forward-backward and stereo parameters, for one stream and
three, and the whole tracker call equals vobench/reference's frozen copy;
a CPU call builds and launches nothing; what the kernel does not take
raises ValueError before anything is built; the counters are declared;
sum_plan reads PyTorch's reduction split; the fused engine's level above
its run at 128x384 takes the one-level case.
On the card (marker `chip`; skips without one): PyTorch's row sums in the
order the kernel repeats; the kernel bit for bit (int32 views) against the
plain composition on the same card and against vobench/reference's tracker
at 376x1241, for the temporal 4-level call, the level-0 forward-backward
call and the stereo call (window 11, margin 16), at 1 and 8 streams with
128 and 192 slots, with dead slots, features leaving the image, a NaN
position and an infinite seed; the one-level case against _patch_level;
fewer rows than 16 (PyTorch's wider sum split); a captured replay against
an eager call, and the counters. This file imports no jax, so it runs on
the card:

    python3 -m pytest tests/test_torch_klt_track.py --noconftest -q
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from svo_tpu_torch import _build
from svo_tpu_torch.config import Config
from svo_tpu_torch.ops import klt, klt_track
from svo_tpu_torch.ops.klt import KltTracker

torch.set_num_threads(2)

KITTI = (376, 1241)
SMALL = (96, 320)


def _params(kind: str):
    cfg = Config()
    if kind == "stereo":
        return cfg.stereo_klt
    if kind == "fb":
        return dataclasses.replace(cfg.temporal_klt, max_level=0, max_iters=8)
    return cfg.temporal_klt


@functools.lru_cache(maxsize=4)
def _rendered(shape, seed: int) -> np.ndarray:
    """(4, H, W) float32: left 0, left 1, right 0 and left 2 of the
    synthetic corridor."""
    from svo_tpu_torch.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(n_frames=3, shape=shape, seed=seed)
    f0, f1, f2 = seq.frame(0), seq.frame(1), seq.frame(2)
    return np.stack([f0[0], f1[0], f0[1], f2[0]]).astype(np.float32)


def _case(kind: str, S: int, N: int, shape, device, seed: int = 0):
    """A tracker call's inputs: the previous and current pyramids of S
    streams (temporal and fb: consecutive left frames, stream s shifted by
    s pixels; stereo: left and right), N positions per stream over the
    image and a little past it, a quarter of the slots dead, seeds of a few
    px and some of 40-80 px (which leave the image), slot 0 of stream 0 at
    NaN, slot 1 with an infinite seed, slot 2 on the corner (0, 0)."""
    params = _params(kind)
    base = _rendered(tuple(shape), seed)
    a, b = (base[0], base[2]) if kind == "stereo" else (base[0], base[1])
    prev = np.stack([np.roll(a, s, axis=1) for s in range(S)])
    curr = np.stack([np.roll(b, s, axis=1) for s in range(S)])
    rng = np.random.default_rng(seed + 31 * S + N)
    H, W = shape
    pos = np.stack([rng.uniform(-4, W + 4, (S, N)), rng.uniform(-4, H + 4, (S, N))], -1)
    valid = rng.uniform(size=(S, N)) < 0.75
    init = rng.normal(0.0, 2.0, (S, N, 2))
    far = rng.uniform(size=(S, N)) < 0.1
    init[far] = rng.uniform(40, 80, (int(far.sum()), 2)) * rng.choice([-1, 1], (int(far.sum()), 2))
    pos[0, 0] = np.nan
    init[0, 1] = np.inf
    pos[0, 2] = 0.0
    valid[0, :3] = True
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    prev_t, curr_t = t(prev.astype(np.float32)), t(curr.astype(np.float32))
    if S == 1:
        prev_t, curr_t = prev_t[0], curr_t[0]
        pos, valid, init = pos[0], valid[0], init[0]
    prev_pyr = KltTracker.build_pyramid(prev_t, params.max_level)
    curr_pyr = KltTracker.build_pyramid(curr_t, params.max_level)
    pos_t = t(pos.astype(np.float32))
    init_t = None if kind == "stereo" else t(init.astype(np.float32))
    return params, prev_pyr, curr_pyr, pos_t, t(valid), init_t


def _call_args(params, prev_pyr, curr_pyr, pos, init):
    """klt_track's arguments for a tracker call, as ops/klt.py::_track_impl
    makes them for the patches engine."""
    L = params.max_level + 1
    w = params.window
    px = klt._patch_cols(w, params.margin_x)
    pys = [0 if lv.shape[-1] < px + 1 else klt._level_rows(w, lv.shape[-2])
           for lv in prev_pyr[0][:L]]
    guess = torch.zeros_like(pos) if init is None else init / (2.0 ** L)
    kw = dict(window=w, pys=pys, px=px, iters=[params.max_iters] * L, eps=params.eps,
              min_eig_threshold=params.min_eig_threshold, margin_x=params.margin_x,
              pad_x=klt._PAD_X, pad_y=klt._PAD_Y)
    return (prev_pyr[0][:L], prev_pyr[1][:L], curr_pyr[0][:L]), guess, kw


def _level_loop(levels, grads, currs, pos, guess, status, *, window, pys, px, iters, eps,
                min_eig_threshold, margin_x, pad_x, pad_y):
    """The tracker's per-level loop over _patch_level as ops/klt.py ran it
    before the kernel: the plain composition the kernel replaces."""
    min_eig_out = None
    for level in range(len(levels) - 1, -1, -1):
        p_lvl = pos / (2.0 ** level)
        guess = guess * 2.0
        if pys[level] == 0:
            continue
        p_pad = torch.stack([p_lvl[..., 0] + pad_x, p_lvl[..., 1] + pad_y], dim=-1)
        d, status, min_eig = klt._patch_level(
            levels[level], *grads[level], currs[level], p_lvl, p_pad, guess, status,
            w=window, py=pys[level], px=px, margin_x=margin_x, iters=iters[level],
            eps2=eps * eps, min_eig_threshold=min_eig_threshold,
        )
        if level == 0:
            min_eig_out = min_eig
        guess = d
    return guess, status, min_eig_out


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def _same(got, want) -> bool:
    return all(g.shape == w.shape and torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))


def _first_diff(got, want) -> str:
    for name, g, w in zip(("d", "status", "min_eig"), got, want):
        bad = _bits(g) != _bits(w)
        if name == "d":
            bad = bad.any(-1)
        if bool(bad.any()):
            return f"{name}: {int(bad.sum())} slots differ, first {bad.nonzero()[:4].tolist()}"
    return "none"


def _reference_track(prev_pyr, curr_pyr, pos, valid, params, init):
    """vobench/reference's frozen tracker (the benchmark's yardstick) on the
    same pyramids."""
    from vobench.reference.ops import klt as ref

    return ref.KltTracker.track(prev_pyr, curr_pyr, pos, valid, params, init_flow=init)


# ---- on the CPU -------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("kind", ["temporal", "fb", "stereo"])
def test_plain_path_is_the_patch_level_loop(kind, S, monkeypatch):
    def no_build():
        raise AssertionError("the CPU path built or loaded the kernel library")

    monkeypatch.setattr(_build, "load", no_build)
    before = _build.counters()
    params, prev_pyr, curr_pyr, pos, valid, init = _case(kind, S, 24, SMALL, "cpu", seed=S)
    levels, guess, kw = _call_args(params, prev_pyr, curr_pyr, pos, init)
    got = klt_track.klt_track(*levels, pos, guess, valid, **kw)
    want = _level_loop(*levels, pos, guess, valid, **kw)
    assert _same(got, want), _first_diff(got, want)
    assert int(got[1].sum()) > 0  # some features survive
    res = KltTracker.track(prev_pyr, curr_pyr, pos, valid, params, init_flow=init)
    ref = _reference_track(prev_pyr, curr_pyr, pos, valid, params, init)
    assert _same(res, ref)
    assert _build.counters() == before


@pytest.mark.parametrize("case", ["levels", "dtype", "shape", "streams", "valid_dtype",
                                  "pos_shape", "patch", "device"])
def test_unsupported_input_raises_before_any_launch(monkeypatch, case):
    def no_build():
        raise AssertionError("the kernel library was loaded before the input was checked")

    monkeypatch.setattr(_build, "load", no_build)
    params, prev_pyr, curr_pyr, pos, valid, init = _case("temporal", 2, 8, SMALL, "cpu")
    (levels, grads, currs), guess, kw = _call_args(params, prev_pyr, curr_pyr, pos, init)
    levels, grads, currs = list(levels), list(grads), list(currs)
    want = {"levels": "levels", "dtype": "float32", "shape": "float32", "streams": "streams",
            "valid_dtype": "bool", "pos_shape": "pos", "patch": "fit", "device": "device"}[case]
    if case == "levels":
        levels = levels[:3]
    elif case == "dtype":
        currs[1] = currs[1].double()
    elif case == "shape":
        grads[0] = (grads[0][0][:, 1:], grads[0][1])
    elif case == "streams":
        levels[2], grads[2], currs[2] = (levels[2][:1], (grads[2][0][:1], grads[2][1][:1]),
                                         currs[2][:1])
    elif case == "valid_dtype":
        valid = valid.to(torch.uint8)
    elif case == "pos_shape":
        pos = pos[:, :5]
    elif case == "patch":
        kw["pys"] = [kw["pys"][0] + 400] + kw["pys"][1:]
    elif case == "device":
        pos, guess, valid = pos.to("meta"), guess.to("meta"), valid.to("meta")
        levels = [lv.to("meta") for lv in levels]
        grads = [(gx.to("meta"), gy.to("meta")) for gx, gy in grads]
        currs = [c.to("meta") for c in currs]
    with pytest.raises(ValueError, match=want):
        klt_track.klt_track(levels, grads, currs, pos, guess, valid, **kw)


def test_counters_are_declared_and_the_frame_steps():
    """klt_track.launches and klt_track.slots are counters of _build from
    the import on, at 0 on the CPU, and the tracer's drain() names them."""
    from svo_tpu_torch.utils import tracing

    c = _build.counters()
    assert c["klt_track.launches"] == 0 and c["klt_track.slots"] == 0
    assert _build.launches()["klt_track"] == 0
    tracing.enable()
    try:
        _build.count("klt_track.launches")
        _build.count("klt_track.slots", 8 * 128)
        assert tracing.drain()["counters"] == {"klt_track.launches": 1,
                                               "klt_track.slots": 8 * 128}
    finally:
        tracing.disable()
        _build.set_counters({"klt_track.launches": 0, "klt_track.slots": 0})


def test_sum_plan_reads_the_reduction_split():
    """PyTorch's split of a (rows, w, w) sum over (-2, -1): 32 threads a
    row from 16 rows up, wider below; 4-vectors from 128 floats a row."""
    assert klt_track.sum_plan(21, 1024) == (32, True, 4)
    assert klt_track.sum_plan(21, 128) == (32, True, 4)
    assert klt_track.sum_plan(21, 16) == (32, True, 4)
    assert klt_track.sum_plan(21, 8) == (64, True, 2)
    assert klt_track.sum_plan(21, 1) == (64, True, 2)
    assert klt_track.sum_plan(11, 1536) == (32, False, 1)
    assert klt_track.sum_plan(11, 4) == (64, False, 1)
    assert klt_track.sum_plan(31, 2) == (128, True, 2)
    with pytest.raises(ValueError, match="threads a row"):
        klt_track.sum_plan(5, 128)


def test_fused_engine_top_level_takes_the_one_level_case(monkeypatch):
    """At 128x384 the fused engine's L3 fails svo_tpu's rule: it runs as
    klt_track_level, the kernel's one-level case, with L0-L2 one fused
    run; the patches engine makes one klt_track call of all four levels
    and no one-level call."""
    one, whole = [], []
    real_one, real_whole = klt_track.klt_track_level, klt_track.klt_track
    monkeypatch.setattr(klt_track, "klt_track_level",
                        lambda *a, **k: one.append(tuple(a[0].shape)) or real_one(*a, **k))
    monkeypatch.setattr(klt_track, "klt_track",
                        lambda *a, **k: whole.append(len(a[0])) or real_whole(*a, **k))
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 255, (128, 384)).astype(np.float32))
    pyr = KltTracker.build_pyramid(img, 3)
    pos = torch.from_numpy(rng.uniform(20, 100, (16, 2)).astype(np.float32))
    valid = torch.ones(16, dtype=torch.bool)
    params = Config().temporal_klt
    fused = KltTracker.track(pyr, pyr, pos, valid, params, engine="fused")
    assert one == [tuple(pyr[0][3].shape)] and whole == []
    patches = KltTracker.track(pyr, pyr, pos, valid, params)
    assert whole == [4] and len(one) == 1
    assert bool(fused.status.any()) and bool(patches.status.any())


# ---- on the card --------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: "
                    "python3 -m pytest tests/test_torch_klt_track.py --noconftest -q)")
    return torch.device("cuda")


def _emulated_row_sums(x: np.ndarray, window: int) -> np.ndarray:
    """torch.sum(x, dim=(-2, -1)) of a contiguous float32 (rows, w, w) in
    the order the kernel repeats (sum_plan; csrc/klt_track.cu's notes),
    computed in float32 with numpy, a row per lane of the arrays."""
    rows = x.shape[0]
    ww = window * window
    flat = x.reshape(rows, ww)
    bw, vec, _ = klt_track.sum_plan(window, rows)
    out = np.empty(rows, np.float32)
    zero = np.float32(0.0)
    for s in range(4) if vec else (0,):
        sel = np.nonzero(((np.arange(rows) * ww) % 4 == s) if vec else np.ones(rows, bool))[0]
        if not len(sel):
            continue
        r = flat[sel]
        threads = []
        for t in range(bw):
            acc = [np.full(len(sel), zero) for _ in range(4)]
            if vec:
                lead, end = (4 - s, ww + s - 4) if s else (0, ww)
                if s and s <= t < 4:
                    acc[0] = acc[0] + r[:, t - s]
                idx = t
                while 4 * idx + 3 < end:
                    for i in range(4):
                        acc[i] = acc[i] + r[:, lead + 4 * idx + i]
                    idx += bw
                tail = end - end % 4
                if tail + t < end:
                    acc[0] = acc[0] + r[:, lead + tail + t]
            else:
                for i in range(4):
                    e = t + i * bw
                    while e < ww:
                        acc[i] = acc[i] + r[:, e]
                        e += 4 * bw
            threads.append(((acc[0] + acc[1]) + acc[2]) + acc[3])
        while len(threads) > 32:
            half = len(threads) // 2
            threads = [threads[i] + threads[i + half] for i in range(half)]
        for o in (16, 8, 4, 2, 1):
            threads = [threads[i] + threads[i + o] for i in range(o)]
        out[sel] = threads[0]
    return out


@pytest.mark.chip
@pytest.mark.parametrize("rows", [1, 5, 8, 16, 128, 1024, 1536])
@pytest.mark.parametrize("window", [11, 21])
def test_plain_sums_follow_the_reduce_order(window, rows):
    """The plain path's torch.sum over (rows, w, w) products on this card's
    PyTorch equals the order the kernel repeats, bit for bit; a different
    PyTorch that changes the order fails here first."""
    dev = _card()
    rng = np.random.default_rng(window * rows)
    a = torch.from_numpy(rng.normal(0, 30, (rows, window, window)).astype(np.float32)).to(dev)
    prod = a * a.roll(1, -1)
    got = torch.sum(prod, dim=(-2, -1)).cpu().numpy()
    want = _emulated_row_sums(prod.cpu().numpy(), window)
    assert np.array_equal(got.view(np.int32), want.view(np.int32)), (
        f"{int((got != want).sum())} of {rows} row sums differ")


@pytest.mark.chip
def test_scalar_division_is_a_product_by_the_reciprocal():
    """PyTorch divides a CUDA tensor by a Python number as a product by the
    number's float32 reciprocal (the kernel's min_eig), and 1.0 / t is
    reciprocal(t) * 1.0 (the kernel's inv_det)."""
    dev = _card()
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1e4, 4096).astype(np.float32)).to(dev)
    inv = torch.tensor(np.float32(1.0) / np.float32(441.0), device=dev)
    assert torch.equal((x / float(441)).view(torch.int32), (x * inv).view(torch.int32))
    assert torch.equal((1.0 / x).view(torch.int32), torch.reciprocal(x).view(torch.int32))


@pytest.mark.chip
@pytest.mark.parametrize("S,N", [(1, 128), (8, 128), (1, 192), (8, 192)])
@pytest.mark.parametrize("kind", ["temporal", "fb", "stereo"])
def test_kernel_bit_equal_to_plain(kind, S, N):
    """One launch against the plain chain on the same card, and the whole
    tracker call against vobench/reference's, bit for bit."""
    dev = _card()
    params, prev_pyr, curr_pyr, pos, valid, init = _case(kind, S, N, KITTI, dev, seed=S + N)
    levels, guess, kw = _call_args(params, prev_pyr, curr_pyr, pos, init)
    before = _build.counters()
    got = klt_track.klt_track(*levels, pos, guess, valid, **kw)
    after = _build.counters()
    assert after["klt_track.launches"] == before["klt_track.launches"] + 1
    assert after["klt_track.slots"] == before["klt_track.slots"] + S * N
    want = klt_track.klt_track_ref(*levels, pos, guess, valid, **kw)
    torch.cuda.synchronize()
    assert _same(got, want), _first_diff(got, want)
    assert int(got[1].sum()) > S * N // 4  # live features are tracked
    assert not bool(got[1].flatten()[0])  # the NaN position is lost
    res = KltTracker.track(prev_pyr, curr_pyr, pos, valid, params, init_flow=init)
    ref = _reference_track(prev_pyr, curr_pyr, pos, valid, params, init)
    torch.cuda.synchronize()
    assert _same(res, ref)


@pytest.mark.chip
@pytest.mark.parametrize("kind", ["temporal", "stereo"])
@pytest.mark.parametrize("S,N", [(1, 3), (1, 8), (2, 5), (8, 128)])
def test_one_level_case_bit_equal_to_patch_level(kind, S, N):
    """klt_track_level against _patch_level on the card at every level of
    the call, from the same inputs; below 16 rows PyTorch's row sums take
    64 threads, which the kernel repeats too."""
    dev = _card()
    params, prev_pyr, curr_pyr, pos, valid, init = _case(kind, S, N, KITTI, dev, seed=7)
    (levels, grads, currs), guess, kw = _call_args(params, prev_pyr, curr_pyr, pos, init)
    for level, py in enumerate(kw["pys"]):
        p_lvl = pos / (2.0 ** level)
        p_pad = torch.stack([p_lvl[..., 0] + klt._PAD_X, p_lvl[..., 1] + klt._PAD_Y], dim=-1)
        args = (levels[level], *grads[level], currs[level], p_lvl, p_pad, guess * 2.0, valid)
        lkw = dict(w=kw["window"], py=py, px=kw["px"], margin_x=kw["margin_x"],
                   iters=kw["iters"][level], eps2=kw["eps"] ** 2,
                   min_eig_threshold=kw["min_eig_threshold"])
        got = klt_track.klt_track_level(*args, **lkw)
        want = klt._patch_level(*args, **lkw)
        torch.cuda.synchronize()
        assert _same(got, want), f"level {level}: {_first_diff(got, want)}"


@pytest.mark.chip
@pytest.mark.parametrize("S,N", [(1, 6), (1, 12), (3, 4)])
def test_whole_call_with_few_rows_bit_equal(S, N):
    """Fewer than 16 rows: the wider split of PyTorch's row sums in the
    whole call too."""
    dev = _card()
    params, prev_pyr, curr_pyr, pos, valid, init = _case("temporal", S, N, KITTI, dev, seed=3)
    levels, guess, kw = _call_args(params, prev_pyr, curr_pyr, pos, init)
    got = klt_track.klt_track(*levels, pos, guess, valid, **kw)
    want = klt_track.klt_track_ref(*levels, pos, guess, valid, **kw)
    torch.cuda.synchronize()
    assert _same(got, want), _first_diff(got, want)


@pytest.mark.chip
def test_captured_replay_equals_eager_and_counts():
    """The tracker's patches call on the card is one klt_track launch and no
    klt_patches launch, also inside a CUDA graph; a replay with new inputs
    copied in equals an eager call."""
    dev = _card()
    params, prev_pyr, curr_pyr, pos, valid, init = _case("temporal", 8, 128, KITTI, dev, seed=5)
    track = lambda: KltTracker.track(prev_pyr, curr_pyr, pos, valid, params,  # noqa: E731
                                     init_flow=init)
    track()  # warm-up, builds the library
    before = _build.launches()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.cuda.graph(graph):
        out = track()
    torch.cuda.current_stream().wait_stream(side)
    after = _build.launches()
    assert after["klt_track"] == before["klt_track"] + 1
    assert after["klt_patches"] == before["klt_patches"]
    for seed in (6, 7):
        _, p2, c2, pos2, valid2, init2 = _case("temporal", 8, 128, KITTI, dev, seed=seed)
        for dst, src in zip((*prev_pyr[0][:4], *curr_pyr[0][:4], pos, valid, init),
                            (*p2[0][:4], *c2[0][:4], pos2, valid2, init2)):
            dst.copy_(src)
        for (gx, gy), (gx2, gy2) in zip(prev_pyr[1][:4], p2[1][:4]):
            gx.copy_(gx2)
            gy.copy_(gy2)
        graph.replay()
        want = track()
        torch.cuda.synchronize()
        assert _same(out, want)
