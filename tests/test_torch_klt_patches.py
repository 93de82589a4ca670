"""The port's KLT patch extraction against svo_tpu's Pallas kernel.

On the CPU the port's wrapper runs its plain version
(extract_klt_patches_ref); svo_tpu's kernel runs in Pallas interpret mode
on images padded to the 128-lane tile with garbage, as
tests/test_klt_pallas.py runs it. The contract is a copy, so the
tolerance is exact: max |diff| == 0.0, dead slots (zeroed) included. The
CUDA kernel is held to its plain version on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_tpu.ops.klt import _extract_patches_xla
from svo_tpu.ops.klt_pallas import extract_klt_patches as jax_extract
from svo_tpu_torch import _build
from svo_tpu_torch.ops.klt_patches import extract_klt_patches, extract_klt_patches_ref

torch.set_num_threads(2)

PY, PX = 40, 40  # the temporal-KLT (window 21) patch geometry


def _images(rng, H, W_true):
    imgs = [rng.uniform(0.0, 255.0, (H, W_true)).astype(np.float32) for _ in range(4)]
    W_pad = ((W_true + 127) // 128) * 128
    padded = [
        np.concatenate([im, rng.uniform(-1e4, 1e4, (H, W_pad - W_true)).astype(np.float32)], 1)
        for im in imgs
    ]
    return imgs, padded


def _corners(rng, n, H, W_true):
    """Corners in the kernel's contract (y a multiple of 8), with the
    borders and lane-aligned / unaligned x pinned on the first rows."""
    ty = (rng.integers(0, (H - PY) // 8 + 1, n) * 8).astype(np.int32)
    tx = rng.integers(0, W_true - PX + 1, n).astype(np.int32)
    cy = (rng.integers(0, (H - PY) // 8 + 1, n) * 8).astype(np.int32)
    cx = rng.integers(0, W_true - PX + 1, n).astype(np.int32)
    tx[0], ty[0] = 0, 0
    tx[1], ty[1] = W_true - PX, ((H - PY) // 8) * 8
    tx[2], tx[3], cx[4], cy[5] = 128, 127, 255, 0
    return ty, tx, cy, cx


def _port(imgs, corners, valid):
    return extract_klt_patches(
        *map(torch.from_numpy, imgs), *map(torch.from_numpy, corners),
        torch.from_numpy(valid), py=PY, px=PX,
    )


@pytest.mark.parametrize("W_true", [500, 512])
@pytest.mark.parametrize("dead", ["some", "all"])
def test_matches_pallas_kernel_interpret(W_true, dead):
    rng = np.random.default_rng(3)
    H, N = 128, 40
    imgs, padded = _images(rng, H, W_true)
    corners = _corners(rng, N, H, W_true)
    valid = rng.random(N) >= 0.4 if dead == "some" else np.zeros(N, bool)
    want = jax_extract(
        *map(jnp.asarray, padded), *map(jnp.asarray, corners), jnp.asarray(valid),
        py=PY, px=PX, interpret=True,
    )
    before = _build.counters()["klt_patches.launches"]
    got = _port(imgs, corners, valid)
    assert _build.counters()["klt_patches.launches"] == before  # CPU: plain version, no launch
    for g, w in zip(got, want):
        assert tuple(g.shape) == (N, PY, PX)
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) == 0.0


def test_out_of_range_corners_clamp():
    """Corners past H-py / W-px clamp as jax.lax.dynamic_slice clamps its
    start (svo_tpu's CPU path). Negative corners, which the tracker never
    produces (klt._corners clamps at 0 first), clamp to 0 here, where
    dynamic_slice would count them from the end."""
    rng = np.random.default_rng(4)
    H, W = 96, 200
    imgs, _ = _images(rng, H, W)
    ty = np.array([0, 50, 96, 200, 8, 56, 57, 0], np.int32)
    tx = np.array([161, 160, 161, 1000, 0, 100, 7, 0], np.int32)
    cy, cx = tx[::-1].copy(), ty[::-1].copy()
    valid = np.ones(len(ty), bool)
    got = _port(imgs, (ty, tx, cy, cx), valid)
    tc = jnp.stack([jnp.asarray(ty), jnp.asarray(tx)], -1)
    cc = jnp.stack([jnp.asarray(cy), jnp.asarray(cx)], -1)
    want = [_extract_patches_xla(jnp.asarray(imgs[k]), tc, PY, PX) for k in range(3)]
    want.append(_extract_patches_xla(jnp.asarray(imgs[3]), cc, PY, PX))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    neg = np.array([-9, -1], np.int32)
    got = _port(imgs, (neg, neg, neg, neg), np.ones(2, bool))
    np.testing.assert_array_equal(got[0].numpy(), np.broadcast_to(imgs[0][:PY, :PX], (2, PY, PX)))


@pytest.mark.parametrize("corners_as", ["int32", "int64", "strided", "stacked_rows"])
def test_corner_and_mask_layouts_equal_plain_version(corners_as):
    """The input contract: corner tensors as they come (int32 as the
    tracker makes them, int64, strided views) and a bool valid, with the
    (N,) and the (S, N) layout alike, give four (.., N, py, px) results
    equal to the plain version's on int32 corners, dead slots zeroed. On
    CPU tensors the wrapper checks and then runs the plain version, so
    this holds the contract and the checks; the conversions the wrapper
    makes before a launch run only on the card, where chip_smoke.py gives
    it int64 and strided corners and a strided valid."""
    rng = np.random.default_rng(6)
    S, H, W, N = 2, 96, 200, 24
    imgs = [torch.from_numpy(rng.uniform(0, 255, (S, H, W)).astype(np.float32)) for _ in range(4)]
    raw = [torch.from_numpy(rng.integers(-10, 220, (S, N)).astype(np.int32)) for _ in range(4)]
    valid = torch.from_numpy(rng.random((S, N)) >= 0.3)
    if corners_as == "int64":
        corners = [c.long() for c in raw]
    elif corners_as == "strided":
        corners = [torch.stack([c, c + 1], dim=-1)[..., 0] for c in raw]
        assert not corners[0].is_contiguous()
    elif corners_as == "stacked_rows":  # rows of one (4, S, N) tensor
        corners = list(torch.stack(raw).unbind(0))
    else:
        corners = raw
    got = extract_klt_patches(*imgs, *corners, valid, py=PY, px=PX)
    want = extract_klt_patches_ref(*imgs, *raw, valid, py=PY, px=PX)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert tuple(g.shape) == (S, N, PY, PX) and g.dtype == torch.float32
        assert torch.equal(g, w)
        assert not g[~valid].any()
    one = extract_klt_patches(*(im[1] for im in imgs), *(c[1] for c in corners), valid[1],
                              py=PY, px=PX)
    for g, o in zip(got, one):
        assert torch.equal(g[1], o)


def test_wrapper_checks_inputs():
    img = torch.zeros((64, 80))
    c = torch.zeros(4, dtype=torch.int32)
    v = torch.ones(4, dtype=torch.bool)
    extract_klt_patches(img, img, img, img, c, c, c, c, v, py=40, px=40)
    with pytest.raises(ValueError, match="float32"):
        extract_klt_patches(img.double(), img, img, img, c, c, c, c, v, py=40, px=40)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((80, 64)).T
        extract_klt_patches(t, t, t, t, c, c, c, c, v, py=40, px=40)
    with pytest.raises(ValueError, match="does not fit"):
        extract_klt_patches(img, img, img, img, c, c, c, c, v, py=72, px=40)
    with pytest.raises(ValueError, match="corners"):
        extract_klt_patches(img, img, img, img, c, c, c, c, v[:3], py=40, px=40)
    ref = extract_klt_patches_ref(img, img, img, img, c, c, c, c, ~v, py=40, px=40)
    assert all(not r.any() for r in ref)
