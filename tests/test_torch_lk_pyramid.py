"""The whole-call fused LK engine of the port on the CPU.

lk_fused.lk_track_pyramid runs a run of pyramid levels in one call (one
kernel launch on the card; on a CPU tensor its plain version, the chain of
lk_track_level_ref calls with the tracker's glue). Held here, on inputs
made from a numpy seed:

- against the per-level loop the tracker ran before the whole-call entry
  existed, written out below (_per_level_track: lk_track_level per fused
  level, the glue in tensor ops, the patch path for a level that fails
  svo_tpu's rule): KltTracker.track(engine="fused") equals it BIT FOR BIT
  (torch.equal on positions, status and err), at 96x544 where all four
  levels are one run and at 128x384 where L3 takes the patch path, with
  temporal and stereo parameters, an init_flow, dead slots, a level_iters
  tuple and non-finite positions;
- (S, H, W) levels against the loop over streams: flags equal, floats
  within 1e-5 (torch sums a stacked tensor in another order);
- the tracker's calls: one lk_track_pyramid call per run, no
  lk_track_level call inside a run;
- the wrapper's errors, and that a CPU call counts no launch.

svo_tpu's side of the comparison (lk_pallas in interpret mode) is in
test_torch_lk_fused.py and test_torch_klt_fused.py, which run through this
path with their tolerances unchanged.
"""

import dataclasses

import jax  # noqa: F401  (jax before torch, see tests/conftest.py)
import numpy as np
import pytest
import torch

from svo_tpu_torch import _build
from svo_tpu_torch.config import Config
from svo_tpu_torch.io.synthetic import SyntheticSequence
from svo_tpu_torch.ops import klt as tklt
from svo_tpu_torch.ops import lk_fused
from svo_tpu_torch.ops.detect import detect_fast
from svo_tpu_torch.ops.klt import KltTracker

torch.set_num_threads(2)

ALL_FUSED = (96, 544)   # L3 is 132 wide: every level passes the rule
TOP_PATCHES = (128, 384)  # L3 is 112 wide: it takes the patch path


def _frames(shape):
    seq = SyntheticSequence(n_frames=2, shape=shape, fx=160.0, speed=0.25, seed=11)
    (l0, r0), (l1, _) = seq.frame(0), seq.frame(1)
    return tuple(torch.from_numpy(a) for a in (l0, r0, l1))


def _features(shape, seed=0, dead=0.25, left=None):
    """Detected corners of the left frame (trackable texture), with the
    first four pinned at the borders and some slots dead."""
    H, W = shape
    left = _frames(shape)[0] if left is None else left
    cfg = Config(use_orb=False, image_height=H, image_width=W)
    pos, _, det = detect_fast(left, 20.0, None, cfg)
    pos = pos[:64].clone()
    valid = det[:64].clone()
    rng = np.random.default_rng(seed)
    valid &= torch.from_numpy(rng.random(len(valid)) >= dead)
    pos[:4] = torch.tensor([[1.0, 1.0], [W - 2.0, H - 2.0], [0.5, H / 2], [W / 2, 0.5]])
    valid[:4] = True
    return pos, valid


def _per_level_track(prev_pyr, curr_pyr, pos, valid, params, init=None):
    """The tracker's fused engine with one lk_track_level call per level
    and the glue between levels in tensor ops."""
    (prev_levels, grads), (curr_levels, _) = prev_pyr, curr_pyr
    w, mx = params.window, params.margin_x
    px = tklt._patch_cols(w, mx)
    init = torch.zeros_like(pos) if init is None else init
    guess = init / (2.0 ** (params.max_level + 1))
    status = valid
    min_eig_out = torch.zeros(pos.shape[:-1])
    fused_levels = []
    for level in range(params.max_level, -1, -1):
        iters = params.max_iters
        if params.level_iters is not None:
            li = params.level_iters
            iters = min(iters, li[min(level, len(li) - 1)])
        H, W = prev_levels[level].shape[-2:]
        p_lvl = pos / (2.0 ** level)
        guess = guess * 2.0
        py = tklt._level_rows(w, H)
        if py == 0 or W < px + 1:
            continue
        p_pad = torch.stack([p_lvl[..., 0] + tklt._PAD_X, p_lvl[..., 1] + tklt._PAD_Y], -1)
        if tklt._fused_level_ok(H, W, py, w, mx):
            fused_levels.append(level)
            d, min_eig, solvable, in_fin = lk_fused.lk_track_level(
                prev_levels[level], *grads[level], curr_levels[level], p_pad, guess, status,
                window=w, py=py, max_iters=iters, eps=params.eps,
                min_eig_threshold=params.min_eig_threshold, margin_x=mx, margin_y=tklt._MY,
            )
            status = status & solvable
            status = status & tklt._inside(
                p_lvl + d, W - 2 * tklt._PAD_X, H - 2 * tklt._PAD_Y) & in_fin
        else:
            d, status, min_eig = tklt._patch_level(
                prev_levels[level], *grads[level], curr_levels[level], p_lvl, p_pad, guess,
                status, w=w, py=py, px=px, margin_x=mx, iters=iters,
                eps2=params.eps * params.eps, min_eig_threshold=params.min_eig_threshold,
            )
        if level == 0:
            min_eig_out = min_eig
        guess = d
    new_pos = pos + guess
    H0 = prev_levels[0].shape[-2] - 2 * tklt._PAD_Y
    W0 = prev_levels[0].shape[-1] - 2 * tklt._PAD_X
    inside0 = ((new_pos[..., 0] >= 0) & (new_pos[..., 0] <= W0 - 1)
               & (new_pos[..., 1] >= 0) & (new_pos[..., 1] <= H0 - 1))
    return new_pos, status & inside0, min_eig_out, fused_levels


def _assert_bit_equal(res, want):
    pos, status, err, _ = want
    assert torch.equal(res.status, status)
    assert torch.equal(res.err, err)
    # NaN positions (non-finite inputs) compare by bits too
    assert torch.equal(res.pos.view(torch.int32), pos.view(torch.int32))


CASES = {
    "temporal": dict(),
    "stereo": dict(stereo=True),
    "init_flow": dict(init=True),
    "all_live": dict(dead=0.0),
    "level_iters": dict(level_iters=(8, 5, 3)),
    "non_finite": dict(non_finite=True),
}


@pytest.mark.parametrize("shape", [ALL_FUSED, TOP_PATCHES], ids=["96x544", "128x384"])
@pytest.mark.parametrize("case", list(CASES))
def test_track_fused_equals_per_level_loop(shape, case):
    opt = CASES[case]
    cfg = Config()
    l0, r0, l1 = _frames(shape)
    params = cfg.stereo_klt if opt.get("stereo") else cfg.temporal_klt
    if "level_iters" in opt:
        params = dataclasses.replace(params, level_iters=opt["level_iters"])
    curr = r0 if opt.get("stereo") else l1
    pos, valid = _features(shape, dead=opt.get("dead", 0.25))
    init = None
    if opt.get("init"):
        init = torch.from_numpy(
            np.random.default_rng(5).uniform(-3, 3, pos.shape).astype(np.float32))
    if opt.get("non_finite"):
        pos[5] = torch.tensor([float("nan"), 40.0])
        pos[6] = torch.tensor([float("inf"), -float("inf")])
        pos[7] = torch.tensor([1e30, 20.0])
        valid[5:8] = True
    prev_pyr = KltTracker.build_pyramid(l0, params.max_level)
    curr_pyr = KltTracker.build_pyramid(curr, params.max_level)
    want = _per_level_track(prev_pyr, curr_pyr, pos, valid, params, init)
    assert want[3] == ([3, 2, 1, 0] if shape == ALL_FUSED else [2, 1, 0])
    res = KltTracker.track(prev_pyr, curr_pyr, pos, valid, params, init_flow=init,
                           engine="fused")
    _assert_bit_equal(res, want)
    assert not res.status[~valid].any()
    if opt.get("non_finite"):
        assert not res.status[5:8].any()
    else:
        # (the fused top level at 96x544 is 60 rows high and loses many)
        assert int(res.status.sum()) >= 0.25 * int(valid.sum())


def _run_args(shape, params, curr_is_right=False):
    """The arguments of one lk_track_pyramid call over all levels."""
    l0, r0, l1 = _frames(shape)
    prev_levels, grads = KltTracker.build_pyramid(l0, params.max_level)
    curr_levels, _ = KltTracker.build_pyramid(r0 if curr_is_right else l1, params.max_level)
    pys = [tklt._level_rows(params.window, lv.shape[-2]) for lv in prev_levels]
    kw = dict(window=params.window, pys=pys, iters=[params.max_iters] * len(pys),
              eps=params.eps, min_eig_threshold=params.min_eig_threshold,
              margin_x=params.margin_x, margin_y=tklt._MY,
              pad_x=tklt._PAD_X, pad_y=tklt._PAD_Y)
    return prev_levels, grads, curr_levels, kw


@pytest.mark.parametrize("stereo", [False, True], ids=["temporal", "stereo"])
def test_pyramid_ref_is_the_chain_of_level_refs(stereo):
    """lk_track_pyramid on a CPU tensor is its plain version, and that is
    the chain over lk_track_level_ref, bit for bit; no launch is counted."""
    cfg = Config()
    params = cfg.stereo_klt if stereo else cfg.temporal_klt
    prev_levels, grads, curr_levels, kw = _run_args(ALL_FUSED, params, stereo)
    pos, valid = _features(ALL_FUSED)
    guess0 = torch.full_like(pos, 0.01)
    before = _build.counters()["lk_level.launches"]
    got = lk_fused.lk_track_pyramid(prev_levels, grads, curr_levels, pos, guess0, valid, **kw)
    assert _build.counters()["lk_level.launches"] == before
    ref = lk_fused.lk_track_pyramid_ref(prev_levels, grads, curr_levels, pos, guess0, valid, **kw)
    chain = lk_fused.lk_track_pyramid_chain(
        lk_fused.lk_track_level_ref, prev_levels, grads, curr_levels, pos, guess0, valid, **kw)
    for g, r, c in zip(got, ref, chain):
        assert torch.equal(g, r) and torch.equal(g, c)
    d, min_eig, status = got
    assert d.shape == pos.shape and min_eig.shape == status.shape == valid.shape
    assert status.dtype == torch.bool and not status[~valid].any()
    assert int(status.sum()) >= 0.25 * int(valid.sum())


def test_pyramid_one_level_is_the_level():
    """A run of one level (the fb re-track) is lk_track_level plus glue."""
    cfg = Config()
    params = dataclasses.replace(cfg.temporal_klt, max_level=0, max_iters=8)
    prev_levels, grads, curr_levels, kw = _run_args(ALL_FUSED, params)
    pos, valid = _features(ALL_FUSED)
    guess0 = torch.from_numpy(
        np.random.default_rng(1).uniform(-0.5, 0.5, pos.shape).astype(np.float32))
    d, min_eig, status = lk_fused.lk_track_pyramid(
        prev_levels, grads, curr_levels, pos, guess0, valid, **kw)
    p_pad = pos + torch.tensor([tklt._PAD_X, tklt._PAD_Y], dtype=torch.float32)
    d1, me1, solv, in_fin = lk_fused.lk_track_level(
        prev_levels[0], *grads[0], curr_levels[0], p_pad, guess0 * 2.0, valid,
        window=params.window, py=kw["pys"][0], max_iters=8, eps=params.eps,
        min_eig_threshold=params.min_eig_threshold, margin_x=params.margin_x,
        margin_y=tklt._MY)
    assert torch.equal(d, d1) and torch.equal(min_eig, me1)
    inside = tklt._inside(pos + d1, ALL_FUSED[1], ALL_FUSED[0])
    assert torch.equal(status, valid & solv & in_fin & inside)


@pytest.mark.parametrize("stereo", [False, True], ids=["temporal", "stereo"])
def test_pyramid_batched_equals_loop_over_streams(stereo):
    S = 3
    cfg = Config()
    params = cfg.stereo_klt if stereo else cfg.temporal_klt
    seqs = [SyntheticSequence(n_frames=2, shape=ALL_FUSED, fx=160.0, speed=0.2, seed=20 + s)
            for s in range(S)]
    prev = torch.from_numpy(np.stack([q.frame(0)[0] for q in seqs]))
    curr = torch.from_numpy(np.stack(
        [q.frame(0)[1] if stereo else q.frame(1)[0] for q in seqs]))
    prev_levels, grads = KltTracker.build_pyramid(prev, params.max_level)
    curr_levels, _ = KltTracker.build_pyramid(curr, params.max_level)
    feats = [_features(ALL_FUSED, seed=s, left=prev[s]) for s in range(S)]
    pos = torch.stack([f[0] for f in feats])
    valid = torch.stack([f[1] for f in feats])
    guess0 = torch.zeros_like(pos)
    pys = [tklt._level_rows(params.window, lv.shape[-2]) for lv in prev_levels]
    kw = dict(window=params.window, pys=pys, iters=[params.max_iters] * len(pys),
              eps=params.eps, min_eig_threshold=params.min_eig_threshold,
              margin_x=params.margin_x, margin_y=tklt._MY,
              pad_x=tklt._PAD_X, pad_y=tklt._PAD_Y)
    got = lk_fused.lk_track_pyramid(prev_levels, grads, curr_levels, pos, guess0, valid, **kw)
    assert got[0].shape == (S, pos.shape[1], 2) and got[2].shape == valid.shape
    # a strided stack of levels gives the same result as a contiguous one
    wide = tuple(torch.stack([lv, lv.flip(0)], dim=1)[:, 0] for lv in prev_levels)
    assert not wide[0].is_contiguous()
    again = lk_fused.lk_track_pyramid(wide, grads, curr_levels, pos, guess0, valid, **kw)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    for s in range(S):
        one = lk_fused.lk_track_pyramid(
            [lv[s] for lv in prev_levels], [(gx[s], gy[s]) for gx, gy in grads],
            [lv[s] for lv in curr_levels], pos[s], guess0[s], valid[s], **kw)
        assert torch.equal(got[2][s], one[2])
        ok = one[2]
        assert int(ok.sum()) >= 0.2 * int(valid[s].sum())
        torch.testing.assert_close(got[0][s][ok], one[0][ok], rtol=0, atol=1e-5)
        torch.testing.assert_close(got[1][s][ok], one[1][ok], rtol=1e-4, atol=1e-5)


def test_pyramid_wrapper_checks_inputs():
    cfg = Config()
    params = cfg.temporal_klt
    prev_levels, grads, curr_levels, kw = _run_args(ALL_FUSED, params)
    pos, valid = _features(ALL_FUSED)
    g0 = torch.zeros_like(pos)
    with pytest.raises(ValueError, match="levels"):  # a level without its py
        lk_fused.lk_track_pyramid(prev_levels, grads, curr_levels, pos, g0, valid,
                                  **{**kw, "pys": kw["pys"][:3]})
    with pytest.raises(ValueError, match="levels"):  # more than the kernel's table
        n = lk_fused.MAX_LEVELS + 1
        lk_fused.lk_track_pyramid(
            prev_levels[:1] * n, grads[:1] * n, curr_levels[:1] * n, pos, g0, valid,
            **{**kw, "pys": kw["pys"][:1] * n, "iters": [8] * n})
    with pytest.raises(ValueError, match="levels"):
        lk_fused.lk_track_pyramid((), (), (), pos, g0, valid, **{**kw, "pys": (), "iters": ()})
    with pytest.raises(ValueError, match="one shape"):  # a level's images differ
        lk_fused.lk_track_pyramid(prev_levels, grads, curr_levels[::-1], pos, g0, valid, **kw)
    with pytest.raises(ValueError, match="valid"):
        lk_fused.lk_track_pyramid(prev_levels, grads, curr_levels, pos, g0, valid[None], **kw)
    with pytest.raises(ValueError, match="py"):  # a level lower than its row budget
        lk_fused.lk_track_pyramid(prev_levels, grads, curr_levels, pos, g0, valid,
                                  **{**kw, "pys": [200] * 4})
