"""Parity of the port's geometry, small linear algebra and copied numpy
modules with svo_tpu, on the same numpy inputs made from a seed.

Tolerance: 1e-5 relative (atol 1e-5 for values near zero). Both sides
compute in float32 with the same formulas; what differs is the order of a
few additions and the contraction of multiply-adds, a few ulp per
operation.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_tpu import config as jcfg
from svo_tpu.eval import trajectory as jtraj
from svo_tpu.geometry import camera as jcam
from svo_tpu.geometry import se3 as jse3
from svo_tpu.geometry import triangulate as jtri
from svo_tpu.io import synthetic as jsyn
from svo_tpu.ops import linalg as jlin
from svo_tpu_torch import config as tcfg
from svo_tpu_torch.eval import trajectory as ttraj
from svo_tpu_torch.geometry import camera as tcam
from svo_tpu_torch.geometry import se3 as tse3
from svo_tpu_torch.geometry import triangulate as ttri
from svo_tpu_torch.io import synthetic as tsyn
from svo_tpu_torch.ops import linalg as tlin

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-5


def both(fn_j, fn_t, *arrays):
    """Run a svo_tpu function and its port on the same float32 inputs."""
    a = [np.asarray(x, np.float32) for x in arrays]
    got_j = jax.tree.map(np.asarray, fn_j(*map(jnp.asarray, a)))
    got_t = fn_t(*map(torch.tensor, a))
    if isinstance(got_t, tuple):
        return got_j, tuple(t.numpy() for t in got_t)
    return got_j, got_t.numpy()


def close(a, b, rtol=RTOL, atol=ATOL):
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        np.testing.assert_allclose(y, x, rtol=rtol, atol=atol)


def _rot(rng, n, scale=0.5):
    return np.asarray(jse3.so3_exp(jnp.asarray(rng.normal(0, scale, (n, 3)), jnp.float32)))


def _pose(rng, n):
    R = _rot(rng, n)
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.normal(0, 2, (n, 3))
    return T


# --- copied numpy-only modules -------------------------------------------

def test_config_copy_matches():
    assert dataclasses.asdict(tcfg.Config()) == dataclasses.asdict(jcfg.Config())
    path = os.path.join(REPO, "configs", "kitti00.yaml")
    assert dataclasses.asdict(tcfg.load_config(path)) == dataclasses.asdict(
        jcfg.load_config(path)
    )


def test_synthetic_and_trajectory_copies_match():
    kw = dict(n_frames=6, shape=(48, 96), fx=60.0, speed=0.2, seed=5, traj="turns")
    sj, st = jsyn.SyntheticSequence(**kw), tsyn.SyntheticSequence(**kw)
    np.testing.assert_array_equal(st.gt_poses, sj.gt_poses)
    for (_, lj, rj), (_, lt, rt) in zip(sj, st):
        np.testing.assert_array_equal(lt, lj)
        np.testing.assert_array_equal(rt, rj)
    rng = np.random.default_rng(0)
    est = sj.gt_poses.copy()
    est[:, :3, 3] += rng.normal(0, 0.05, (6, 3))
    assert ttraj.ate_rmse(est, sj.gt_poses) == jtraj.ate_rmse(est, sj.gt_poses)
    assert ttraj.rpe(est, sj.gt_poses, 2) == jtraj.rpe(est, sj.gt_poses, 2)


# --- se3 -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["so3_exp", "exp"])
def test_se3_exp_maps(name):
    rng = np.random.default_rng(1)
    dim = 3 if name == "so3_exp" else 6
    x = rng.normal(0, 0.4, (16, dim))
    x[0] = 0.0            # exact zero: Taylor branch
    x[1] = 1e-5           # tiny: Taylor branch
    close(*both(getattr(jse3, name), getattr(tse3, name), x))


@pytest.mark.parametrize("name", ["so3_log", "log"])
def test_se3_log_maps(name):
    rng = np.random.default_rng(2)
    T = _pose(rng, 16)
    T[0, :3, :3] = np.eye(3)  # identity rotation: small-angle branch
    arg = T[:, :3, :3] if name == "so3_log" else T
    close(*both(getattr(jse3, name), getattr(tse3, name), arg))


def test_se3_compose_inverse_transform():
    rng = np.random.default_rng(3)
    A, B = _pose(rng, 8), _pose(rng, 8)
    X = rng.normal(0, 5, (8, 20, 3))
    close(*both(jse3.compose, tse3.compose, A, B))
    close(*both(jse3.inverse, tse3.inverse, A))
    close(*both(jse3.transform, tse3.transform, A, X))
    close(*both(jse3.transform, tse3.transform, A[0], X[0, 0]))
    close(*both(jse3.from_rt, tse3.from_rt, A[:, :3, :3], A[:, :3, 3]))
    close(*both(jse3.hat, tse3.hat, X[0]))


def test_se3_orthogonalize():
    rng = np.random.default_rng(4)
    R = _rot(rng, 8) + rng.normal(0, 0.05, (8, 3, 3)).astype(np.float32)
    close(*both(jse3.orthogonalize, tse3.orthogonalize, R))


# --- camera and triangulation ---------------------------------------------

def test_camera_from_intrinsics_and_project():
    cj = jcam.from_intrinsics(718.856, 718.856, 620.5, 188.0, 0.5372)
    ct = tcam.from_intrinsics(718.856, 718.856, 620.5, 188.0, 0.5372)
    for a, b in zip(cj, ct):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert float(ct.baseline) == float(cj.baseline)
    rng = np.random.default_rng(5)
    X = rng.normal(0, 3, (64, 3))
    X[:, 2] = np.abs(X[:, 2]) + 0.5
    X[0, 2] = 0.0  # the |z| < 1e-9 guard
    close(*both(lambda x: jcam.project(cj.K, x), lambda x: tcam.project(ct.K, x), X))


@pytest.mark.parametrize("method", ["rectified", "dlt"])
def test_triangulation(method):
    rng = np.random.default_rng(6)
    cj = jcam.from_intrinsics(718.856, 718.856, 620.5, 188.0, 0.5372)
    ct = tcam.from_intrinsics(718.856, 718.856, 620.5, 188.0, 0.5372)
    X = np.stack([rng.uniform(-10, 10, 50), rng.uniform(-2, 2, 50), rng.uniform(3, 60, 50)], -1)
    uvl = np.asarray(jcam.project(cj.K, jnp.asarray(X, jnp.float32)))
    uvr = uvl.copy()
    uvr[:, 0] -= 718.856 * 0.5372 / X[:, 2]
    uvr += rng.normal(0, 0.2, uvr.shape)
    if method == "rectified":
        fj = lambda l, r: jtri.triangulate_rectified(cj.fx, cj.baseline, l, r, cj.K)  # noqa: E731
        ft = lambda l, r: ttri.triangulate_rectified(ct.fx, ct.baseline, l, r, ct.K)  # noqa: E731
        close(*both(fj, ft, uvl, uvr))
    else:
        fj = lambda l, r: jtri.triangulate_dlt(cj.P_left, cj.P_right, l, r)  # noqa: E731
        ft = lambda l, r: ttri.triangulate_dlt(ct.P_left, ct.P_right, l, r)  # noqa: E731
        # the DLT's 4x4 symmetric eigensolve is XLA's own on one side and
        # LAPACK's on the other; the null vector's f32 rounding, divided by
        # its small 4th component, reaches ~1e-4 relative in the points
        close(*both(fj, ft, uvl, uvr), rtol=1e-4)


# --- small linear algebra ---------------------------------------------------

def _spd(rng, n, batch):
    A = rng.normal(0, 1, (batch, n, n))
    return (A @ A.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


def test_linalg_3x3():
    rng = np.random.default_rng(7)
    A = rng.normal(0, 1, (32, 3, 3)) + 2 * np.eye(3)
    close(*both(jlin.inv3x3, tlin.inv3x3, A))
    close(*both(jlin.det3x3, tlin.det3x3, A))


def test_polar3x3():
    rng = np.random.default_rng(8)
    M = 1.7 * _rot(rng, 32) + rng.normal(0, 0.1, (32, 3, 3)).astype(np.float32)
    M[0] *= -1.0  # det < 0: reflected branch
    close(*both(jlin.polar3x3, tlin.polar3x3, M))


@pytest.mark.parametrize("n", [6, 12])
def test_cholesky_and_solve(n):
    rng = np.random.default_rng(9 + n)
    B = _spd(rng, n, 16)
    b = rng.normal(0, 1, (16, n))
    close(*both(jlin.cholesky_unrolled, tlin.cholesky_unrolled, B))
    L = np.asarray(jlin.cholesky_unrolled(jnp.asarray(B)))
    close(*both(jlin.cho_solve_unrolled, tlin.cho_solve_unrolled, L, b))


def test_smallest_eigvec_psd():
    rng = np.random.default_rng(11)
    Q = np.linalg.qr(rng.normal(0, 1, (16, 12, 12)))[0]
    ev = np.linspace(1e-3, 10.0, 12)
    A = (Q * ev[None, None, :]) @ Q.transpose(0, 2, 1)
    close(*both(jlin.smallest_eigvec_psd, tlin.smallest_eigvec_psd, A))
