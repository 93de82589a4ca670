"""The port's RANSAC-PnP against svo_tpu's, fed the same Gumbel noise.

svo_tpu draws its hypothesis noise inside ransac_pnp as
jax.random.gumbel(key, (H, N)) (geometry/pnp.py:168); the test draws the
same array from the same key and hands it to the port. With identical
hypotheses both sides must agree on the inlier set and `ok` exactly, and
on T_wc to 1e-4 (f32 inverse iteration, polar and Gauss-Newton steps in
another summation order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_tpu.config import RansacParams as JRansac
from svo_tpu.geometry import pnp as jpnp
from svo_tpu.geometry import se3 as jse3
from svo_tpu_torch.config import RansacParams as TRansac
from svo_tpu_torch.geometry import pnp as tpnp
from svo_tpu_torch.ops import random as trandom

torch.set_num_threads(2)

N = 128
K = np.array([[718.856, 0, 620.5], [0, 718.856, 188.0], [0, 0, 1]], np.float32)


@functools.lru_cache(maxsize=None)
def _jax_pnp(with_init: bool):
    if with_init:
        return jax.jit(lambda *a: jpnp.ransac_pnp(*a[:5], JRansac(), T_init=a[5]))
    return jax.jit(lambda *a: jpnp.ransac_pnp(*a, JRansac()))


def _problem(seed, n_valid, outlier_frac, noise_px=0.5):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.05, 3)
    T_cw = np.asarray(jse3.exp(jnp.asarray(np.r_[rng.normal(0, 0.3, 3), w], jnp.float32)))
    Xc = np.stack([rng.uniform(-15, 15, N), rng.uniform(-2, 2, N), rng.uniform(4, 60, N)], -1)
    Xw = (np.linalg.inv(T_cw) @ np.c_[Xc, np.ones(N)].T).T[:, :3]
    uv = (K @ Xc.T).T
    uv = uv[:, :2] / uv[:, 2:] + rng.normal(0, noise_px, (N, 2))
    out = rng.random(N) < outlier_frac
    uv[out] += rng.uniform(-80, 80, (out.sum(), 2))
    valid = np.zeros(N, bool)
    valid[rng.choice(N, n_valid, replace=False)] = True
    T_init = np.asarray(jse3.exp(jnp.asarray(rng.normal(0, 0.02, 6), jnp.float32))) @ T_cw
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(Xw), f32(uv), valid, f32(T_init)


CASES = {
    "clean": (0, 100, 0.0, True),
    "outliers": (1, 110, 0.3, True),
    "no_prior": (2, 90, 0.0, False),
    "few_valid": (3, 5, 0.0, True),  # < 6 valid: -inf ties in the top-6
    "heavy_outliers": (4, 60, 0.6, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ransac_pnp_matches_with_jax_noise(case):
    seed, n_valid, out_frac, with_init = CASES[case]
    Xw, uv, valid, T_init = _problem(seed, n_valid, out_frac)
    key = jax.random.PRNGKey(seed)
    noise = np.array(jax.random.gumbel(key, (JRansac().num_hypotheses, N)))

    args = [jnp.asarray(K), jnp.asarray(Xw), jnp.asarray(uv), jnp.asarray(valid), key]
    if with_init:
        args.append(jnp.asarray(T_init))
    rj = jax.tree.map(np.asarray, _jax_pnp(with_init)(*args))
    rt = tpnp.ransac_pnp(
        torch.from_numpy(K), torch.from_numpy(Xw), torch.from_numpy(uv),
        torch.from_numpy(valid), torch.from_numpy(noise), TRansac(),
        T_init=torch.from_numpy(T_init) if with_init else None,
    )
    np.testing.assert_array_equal(rt.inliers.numpy(), rj.inliers)
    assert bool(rt.ok) == bool(rj.ok)
    np.testing.assert_allclose(float(rt.inlier_ratio), float(rj.inlier_ratio), rtol=1e-6)
    if n_valid >= 6:
        assert bool(rj.ok)
        np.testing.assert_allclose(rt.T_wc.numpy(), rj.T_wc, rtol=1e-4, atol=1e-4)


def test_ransac_pnp_rejects_bad_noise_shape():
    Xw, uv, valid, _ = _problem(0, 20, 0.0)
    with pytest.raises(ValueError, match="noise"):
        tpnp.ransac_pnp(
            torch.from_numpy(K), torch.from_numpy(Xw), torch.from_numpy(uv),
            torch.from_numpy(valid), torch.zeros(3, N), TRansac(),
        )


def test_gumbel_noise_distribution():
    """The frame step's draw (ops/random.gumbel, jax.random.gumbel's bits;
    tests/test_torch_rng.py holds it to jax's) is standard Gumbel: mean =
    Euler's gamma, var = pi^2/6."""
    g = trandom.gumbel(trandom.prng_key(0), (400, 500)).double()
    assert abs(float(g.mean()) - 0.5772) < 0.01
    assert abs(float(g.var()) - np.pi**2 / 6) < 0.02
