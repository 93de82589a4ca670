"""The RANSAC-PnP kernel (csrc/ransac_pnp.cu, geometry/pnp.py) against its
plain version, ransac_pnp_ref.

On the CPU: a CPU tensor takes the plain path and launches nothing; a
shape the kernel does not take raises ValueError before anything is built
or launched; RansacParams reach the kernel as the plain path reads them.
On the card (marker `chip`; skips without one): the kernel against the
plain path on the same card, stage by stage (index sets, DLT poses, MSAC
scores, winner, each LO chain's pose and mask, the result), at S = 1, 8,
16 streams with and without a prior, at 100/70/30% inliers and on the
edge cases (fewer than 6 valid slots, none, a non-finite prior,
near-planar points); S = 1 with a stream axis; at 96 and 64 slots, each
stage within the gap measured there; stream s of an S = 8 call against
its single-stream call; a captured and replayed call against an eager
one. This file imports no jax, so it runs on the card:

    python3 -m pytest tests/test_torch_pnp_kernel.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from svo_tpu_torch import _build
from svo_tpu_torch.config import RansacParams
from svo_tpu_torch.geometry import pnp, se3
from svo_tpu_torch.ops.index import take_rows

torch.set_num_threads(2)

N = 128
K_NP = np.array([[718.856, 0, 607.1928], [0, 718.856, 185.2157], [0, 0, 1]], np.float32)


def _rot(w):
    """Rodrigues in float64: (3,) axis-angle -> (3, 3)."""
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + W
    return np.eye(3) + np.sin(th) / th * W + (1 - np.cos(th)) / th**2 * W @ W


def problem(seed, inlier_share=1.0, n_valid=None, planar=False, prior_noise=0.02, N=N, H=None):
    """One stream's correspondences in float32: a KITTI-like camera pose,
    N world points at 4-60 m depth (on one plane if planar), pixels with
    0.5 px noise, a share of them moved 20-80 px off, n_valid live slots
    (110 of 128 by default), a prior pose near the truth, and Gumbel noise
    for H hypotheses (RansacParams' by default)."""
    n_valid = 110 * N // 128 if n_valid is None else n_valid
    H = RansacParams().num_hypotheses if H is None else H
    rng = np.random.default_rng(seed)
    T_cw = np.eye(4)
    T_cw[:3, :3] = _rot(rng.normal(0, 0.05, 3))
    T_cw[:3, 3] = rng.normal(0, 0.3, 3)
    depth = rng.uniform(4, 60, N)
    Xc = np.stack([rng.uniform(-15, 15, N), rng.uniform(-2, 2, N), depth], -1)
    if planar:  # a wall: depth a linear function of x, 1 cm of relief
        Xc[:, 2] = 20 + 0.3 * Xc[:, 0] + rng.normal(0, 0.01, N)
    Xw = (np.linalg.inv(T_cw) @ np.c_[Xc, np.ones(N)].T).T[:, :3]
    uv = (K_NP.astype(np.float64) @ Xc.T).T
    uv = uv[:, :2] / uv[:, 2:] + rng.normal(0, 0.5, (N, 2))
    out = rng.random(N) >= inlier_share
    off = rng.uniform(20, 80, (N, 2)) * rng.choice([-1, 1], (N, 2))
    uv[out] += off[out]
    valid = np.zeros(N, bool)
    valid[rng.choice(N, n_valid, replace=False)] = True
    T_init = np.eye(4)
    T_init[:3, :3] = _rot(rng.normal(0, prior_noise, 3))
    T_init[:3, 3] = rng.normal(0, prior_noise, 3)
    T_init = T_init @ T_cw
    u = rng.uniform(np.finfo(np.float32).tiny, 1, (H, N))
    noise = -np.log(-np.log(u))
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    return f32(Xw), f32(uv), valid, f32(noise), f32(T_init)


def batch(seeds, device, with_prior=True, **kw):
    """(S, ...) tensors on `device` of one problem a seed."""
    probs = [problem(s, **kw) for s in seeds]
    Xw, uv, valid, noise, T_init = (torch.from_numpy(np.stack(a)).to(device)
                                    for a in zip(*probs))
    return (torch.from_numpy(K_NP).to(device), Xw, uv, valid, noise,
            T_init if with_prior else None)


def plain_stages(K, Xw, uv, valid, noise, params, T_init=None) -> pnp.KernelStages:
    """ransac_pnp_ref's intermediate results, its own helpers in its own
    order: the counterpart of the kernel's KernelStages."""
    lead = Xw.shape[:-2]
    valid_h = valid[..., None, :]
    scores = torch.where(valid_h, noise, -torch.inf)
    idx = torch.sort(scores, dim=-1, descending=True, stable=True)[1][..., :6]
    xn = pnp._normalize_pixels(K, uv)
    Rs, ts = pnp._dlt6(take_rows(Xw, idx, 2), take_rows(xn, idx, 2))
    T_h = se3.from_rt(Rs, ts)
    priors = []
    if T_init is not None:
        Ti = T_init[..., None, :, :] if T_init.dim() == len(lead) + 2 else T_init
        T_h = torch.cat([T_h, Ti], dim=-3)
        priors = [Ti[..., i, :, :] for i in range(Ti.shape[-3])]
    thr2 = params.reproj_threshold ** 2
    err2, z = pnp._reproj_errors(K, T_h, Xw, uv)
    finite = torch.all(torch.isfinite(T_h.flatten(-2)), dim=-1)
    res2 = torch.where(z > 0, torch.clamp(err2, max=thr2), thr2)
    msac = torch.sum(torch.where(valid_h, res2, 0.0), dim=-1)
    msac = torch.where(finite, msac, torch.inf)
    best = torch.argmin(msac, dim=-1)
    T_best = take_rows(T_h, best[..., None])[..., 0, :, :]

    def inliers_of(T, mult=1.0):
        err2_f, z_f = pnp._reproj_errors(K, T, Xw, uv)
        inl_f = (err2_f < thr2 * (mult * mult)) & (z_f > 0) & valid
        res2_f = torch.where(z_f > 0, torch.clamp(err2_f, max=thr2), thr2)
        return inl_f, torch.sum(torch.where(valid, res2_f, 0.0), dim=-1)

    def lo_from(T0, schedule):
        T_ref = T0
        for mult in schedule:
            sel, _ = inliers_of(T_ref, mult)
            T_ref = pnp._gn_refine(K, T_ref, Xw, uv, sel.to(torch.float32), params.refine_iters)
        return T_ref

    chains = []
    for T0 in priors:
        chains.append(lo_from(T0, (1.0,) * params.lo_rounds))
        chains.append(lo_from(T0, tuple(params.lo_anneal)))
    chains.append(lo_from(T_best, (1.0,) * params.lo_rounds))
    inl_lo, score_lo = zip(*(inliers_of(T) for T in chains))
    inl_lo = torch.stack(inl_lo, dim=-2)
    return pnp.KernelStages(
        idx=idx.to(torch.int32), T_h=T_h, msac=msac, best=best.to(torch.int32),
        T_lo=torch.stack(chains, dim=-3), count_lo=inl_lo.sum(-1).to(torch.float32),
        score_lo=torch.stack(score_lo, dim=-1), inliers_lo=inl_lo)


def _bits(t):
    """A tensor's bits, NaNs of any payload alike."""
    if not t.is_floating_point():
        return t
    return torch.where(torch.isnan(t), torch.full_like(t, float("nan")), t).view(torch.int32)


def stage_gaps(got: pnp.KernelStages, want: pnp.KernelStages, res, ref) -> dict:
    """Per stage: the largest gap (0.0: bit-equal) and the share of streams
    or masks that differ, kernel against plain."""
    def gap(a, b):
        a, b = a.double(), b.double()
        both = ~torch.isfinite(a) & ~torch.isfinite(b)
        d = torch.where(both, 0.0, (a - b).abs().nan_to_num(nan=float("inf")))
        return float(d.max()) if d.numel() else 0.0

    def share(a, b, dims):
        return float((_bits(a) != _bits(b)).flatten(-dims).any(-1).float().mean())

    return {
        "idx_share": share(got.idx, want.idx, 2),
        "T_h": gap(got.T_h, want.T_h), "T_h_share": share(got.T_h, want.T_h, 3),
        "msac_rel": gap(got.msac, want.msac) / max(float(want.msac.abs().max()), 1e-30),
        "best_share": share(got.best[..., None], want.best[..., None], 1),
        "T_lo": gap(got.T_lo, want.T_lo), "T_lo_share": share(got.T_lo, want.T_lo, 3),
        "count_lo_share": share(got.count_lo, want.count_lo, 1),
        "inliers_lo_share": share(got.inliers_lo, want.inliers_lo, 2),
        "T_wc": gap(res.T_wc, ref.T_wc), "T_wc_share": share(res.T_wc, ref.T_wc, 2),
        "inliers_share": share(res.inliers, ref.inliers, 1),
        "ok_share": share(res.ok[..., None], ref.ok[..., None], 1),
        "ratio": gap(res.inlier_ratio, ref.inlier_ratio),
    }


# ---- on the CPU -------------------------------------------------------------


def test_cpu_takes_the_plain_path_and_launches_nothing(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path built or loaded the kernel library")

    monkeypatch.setattr(_build, "load", no_build)
    _build.set_counters({"ransac_pnp.launches": 0})
    args = batch([3, 4], "cpu", inlier_share=0.7)
    got = pnp.ransac_pnp(*args[:5], RansacParams(), T_init=args[5])
    want = pnp.ransac_pnp_ref(*args[:5], RansacParams(), T_init=args[5])
    assert _build.counters()["ransac_pnp.launches"] == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["N", "dtype", "rounds", "T_init", "streams", "device"])
def test_unsupported_shape_raises_before_any_launch(monkeypatch, case):
    def no_build():
        raise AssertionError("the kernel library was loaded before the shape was checked")

    monkeypatch.setattr(_build, "load", no_build)
    _build.set_counters({"ransac_pnp.launches": 0})
    K, Xw, uv, valid, noise, T_init = batch([1, 2], "cpu")
    params = RansacParams()
    want = {"N": "N <= 2048", "dtype": "float32", "rounds": "at most 8",
            "T_init": "T_init must be", "streams": "1 to 65535", "device": "CUDA device"}[case]
    if case == "N":  # one slot past the wide path's 2048
        Xw, uv, valid = (torch.cat([t] * 16 + [t[:, :1]], dim=1) for t in (Xw, uv, valid))
        noise = torch.cat([noise] * 16 + [noise[..., :1]], dim=-1)
    elif case == "dtype":
        Xw = Xw.double()
    elif case == "rounds":
        params = RansacParams(lo_anneal=(4.0,) * 9)
    elif case == "T_init":
        T_init = T_init[..., :3, :]
    elif case == "streams":
        Xw, uv, valid, noise, T_init = (t[:0] for t in (Xw, uv, valid, noise, T_init))
    with pytest.raises(ValueError, match=want):
        pnp.ransac_pnp_kernel(K, Xw, uv, valid, noise, params, T_init)
    assert _build.counters()["ransac_pnp.launches"] == 0


@pytest.mark.parametrize("anneal", [(4.0, 1.0), (3.0, 1.7, 1.0), (2.5,)])
@pytest.mark.parametrize("thr", [8.0, 2.5, 0.7])
def test_params_packing_matches_the_plain_reading(thr, anneal):
    """Each packed gate splits float32 squared errors where the plain
    path's comparison err2 < thr2 * (mult * mult) splits them, the clamp
    at thr2 is the plain path's, and the rescue's margin * count + 2 is
    the plain path's float32 arithmetic."""
    params = RansacParams(reproj_threshold=thr, lo_rounds=3, lo_anneal=anneal, rescue_margin=1.3)
    kp = pnp.kernel_params(params)
    assert len(kp.strict) == params.lo_rounds and len(kp.anneal) == len(anneal)
    assert kp.iters == params.refine_iters
    thr2 = thr ** 2
    for gate, mult in [(g, 1.0) for g in kp.strict] + list(zip(kp.anneal, anneal)):
        g = np.float32(gate)
        around = np.array([np.nextafter(g, np.float32(0)), g, np.nextafter(g, np.float32(np.inf))],
                          np.float32)
        around = np.r_[around, around * np.float32(1 + 1e-7), around * np.float32(1 - 1e-7)]
        plain = torch.from_numpy(around) < thr2 * (mult * mult)
        assert np.array_equal(plain.numpy(), around < g)
    e = torch.tensor([thr2 * 0.5, thr2, thr2 * 2, float("nan")], dtype=torch.float32)
    np.testing.assert_array_equal(torch.clamp(e, max=thr2).numpy(),
                                  np.where(np.isnan(e), e, np.minimum(e, np.float32(kp.thr2))))
    cnt = torch.arange(0, 200, dtype=torch.float32)
    plain = params.rescue_margin * cnt + 2.0
    packed = np.float32(kp.margin) * cnt.numpy() + np.float32(2.0)
    np.testing.assert_array_equal(plain.numpy(), packed)


@pytest.mark.parametrize("S, bh_H, bh_g", [(1, 1, 1), (2, 8, 1), (3, 8, 1), (4, 4, 1), (8, 4, 1),
                                            (16, 4, 8), (32, 4, 8)])
def test_gn_split_is_the_reduction_read_on_the_card(S, bh_H, bh_g):
    """The threads a Gauss-Newton sum over 128 points is split among, as
    the kernel takes them, are what PyTorch's reduction used on the card
    (H100, PyTorch 2.11: each sum held against the orders of 1, 2, 4 and 8
    threads)."""
    assert (pnp.gn_split(S, N, 36), pnp.gn_split(S, N, 6)) == (bh_H, bh_g)


# The splits ATen's setReduceConfig picks on the H100 (132 multiprocessors)
# for the plain path's sums past 128 slots, as the kernel takes them:
# (bh_H, bh_g, ct_H, ct_g, bw_h, bw_s); the card tests hold torch.sum to them.
WIDE_SPLITS = {
    (1, 256): (16, 128, 1, 1, 32, 64), (1, 1024): (16, 128, 1, 1, 32, 256),
    (1, 2048): (16, 128, 1, 1, 32, 512), (8, 256): (4, 16, 1, 1, 32, 64),
    (8, 1024): (4, 16, 16, 1, 32, 64), (8, 2048): (4, 16, 32, 1, 32, 64),
    (16, 2048): (4, 8, 32, 16, 32, 32),
}


@pytest.mark.parametrize("S, n", sorted(WIDE_SPLITS))
def test_wide_splits_are_setreduceconfigs(S, n):
    """The kernel's reduction arguments past 128 slots: the Gauss-Newton
    sums' threads and blocks, the slot sums' widths; up to 128 the narrow
    path's (gn_split, one block, widths unused)."""
    assert pnp.kernel_split(S, n, 128, 1) == WIDE_SPLITS[S, n]
    assert pnp.kernel_split(S, 128, 128, 1) == (pnp.gn_split(S, 128, 36),
                                                 pnp.gn_split(S, 128, 6), 1, 1, 32, 32)


def emulate_slot_sum(x: np.ndarray, bw: int) -> np.ndarray:
    """torch.sum(x, -1) of a contiguous float32 (..., N), N >= 128, in the
    order the kernel repeats (csrc/ransac_pnp.cu wide_consensus): bw
    threads, thread t adding 4-vectors t, t + bw, ... into four
    accumulators and tail element 4 (N // 4) + t into the first, then a
    tree of offsets bw / 2 .. 1."""
    x = x.astype(np.float32)
    N = x.shape[-1]
    nvec, tail = N // 4, N % 4
    zero = np.zeros(x.shape[:-1], np.float32)
    parts = []
    for t in range(bw):
        acc = [zero.copy() for _ in range(4)]
        for v in range(t, nvec, bw):
            for i in range(4):
                acc[i] = acc[i] + x[..., 4 * v + i]
        if t < tail:
            acc[0] = acc[0] + x[..., 4 * nvec + t]
        parts.append(((acc[0] + acc[1]) + acc[2]) + acc[3])
    off = bw // 2
    while off:
        for t in range(off):
            parts[t] = parts[t] + parts[t + off]
        off //= 2
    return parts[0]


def emulate_point_sum(x: np.ndarray, bh: int, ct: int) -> np.ndarray:
    """torch.sum(x, -3) of a contiguous float32 (..., N, a, b) in the order
    the kernel repeats (wide_gn_sum): bh threads in each of ct blocks,
    thread q = y + bh c adding points q, q + bh ct, ... into four
    accumulators; each block's tree over y; with ct > 1, thread y adding
    blocks y, y + bh, ... from 0, then a tree over y."""
    x = x.astype(np.float32)
    N, nq = x.shape[-3], bh * ct
    zero = np.zeros(x.shape[:-3] + x.shape[-2:], np.float32)
    parts = []
    for q in range(nq):
        acc = [zero.copy() for _ in range(4)]
        for k, n in enumerate(range(q, N, nq)):
            acc[k % 4] = acc[k % 4] + x[..., n, :, :]
        parts.append(((acc[0] + acc[1]) + acc[2]) + acc[3])

    def tree(v):
        off = len(v) // 2
        while off:
            for y in range(off):
                v[y] = v[y] + v[y + off]
            off //= 2
        return v[0]

    blocks = [tree(parts[c * bh:(c + 1) * bh]) for c in range(ct)]
    if ct == 1:
        return blocks[0]
    fin = []
    for y in range(bh):
        acc = zero.copy()
        for c in range(y, ct, bh):
            acc = acc + blocks[c]
        fin.append(acc)
    return tree(fin)


def test_plain_stages_end_where_ransac_pnp_ref_ends():
    """The staged plain path the card tests compare against is
    ransac_pnp_ref's own arithmetic: its index sets, winner and chains
    give ransac_pnp_ref's result."""
    params = RansacParams()
    K, Xw, uv, valid, noise, T_init = batch([11, 12, 13], "cpu", inlier_share=0.7)
    st = plain_stages(K, Xw, uv, valid, noise, params, T_init)
    ref = pnp.ransac_pnp_ref(K, Xw, uv, valid, noise, params, T_init)
    # the result is one of the candidates: the winner as it is or a chain
    T_cw = se3.inverse(ref.T_wc)
    T_best = take_rows(st.T_h, st.best[..., None].long())
    cands = torch.cat([T_best, st.T_lo], dim=-3)
    assert bool(((cands - T_cw[..., None, :, :]).abs().amax((-1, -2)) < 1e-5).any(-1).all())
    assert st.idx.shape == (3, params.num_hypotheses, 6) and st.T_lo.shape == (3, 3, 4, 4)


# ---- on the card --------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: "
                    "python3 -m pytest tests/test_torch_pnp_kernel.py --noconftest -q)")
    return torch.device("cuda")


STAGES = ("idx", "T_h", "msac", "best", "T_lo", "count_lo", "score_lo", "inliers_lo")
RESULT = ("T_wc", "inliers", "inlier_ratio", "ok")


def _unequal(got, want, names):
    return [n for n in names if not torch.equal(_bits(getattr(got, n)), _bits(getattr(want, n)))]


def _check(args, params=None):
    """The kernel against the plain path on the same card: every stage and
    the result bit for bit."""
    params = params or RansacParams()
    res, st = pnp.ransac_pnp_kernel(*args[:5], params, args[5], stages=True)
    ref = pnp.ransac_pnp_ref(*args[:5], params, args[5])
    want = plain_stages(*args[:5], params, args[5])
    torch.cuda.synchronize()
    bad = _unequal(st, want, STAGES) + _unequal(res, ref, RESULT)
    assert not bad, f"differ from the plain path: {bad}; gaps {stage_gaps(st, want, res, ref)}"
    return res, st


@pytest.mark.chip
@pytest.mark.parametrize("share", [1.0, 0.7, 0.3])
@pytest.mark.parametrize("prior", [True, False])
@pytest.mark.parametrize("lead", [(), (1,), (8,), (16,)])
def test_kernel_bit_equal_to_plain_stage_by_stage(lead, prior, share):
    """lead (): one stream with no stream axis, StereoVO's frame step;
    (1,): one stream in the batched form, where the kernel picks the
    single-matrix orders by S alone and the plain path by its ops' shapes."""
    dev = _card()
    S = max(lead, default=1)
    args = batch(list(range(1000 * S, 1000 * S + S)), dev, with_prior=prior, inlier_share=share)
    if not lead:
        args = (args[0],) + tuple(a[0] if a is not None else None for a in args[1:])
    _check(args)


@pytest.mark.chip
@pytest.mark.parametrize("case", ["five_valid", "none_valid", "nan_prior", "planar"])
@pytest.mark.parametrize("S", [1, 8])
def test_kernel_edge_cases_bit_equal_to_plain(S, case):
    dev = _card()
    kw = {"five_valid": dict(n_valid=5), "none_valid": dict(n_valid=0),
          "nan_prior": dict(inlier_share=0.7), "planar": dict(planar=True, inlier_share=0.8)}[case]
    args = list(batch(list(range(7 * S, 8 * S)), dev, **kw))
    if case == "nan_prior":
        args[5] = args[5].clone()
        args[5][0, 1, 2] = float("nan")
    res, _ = _check(tuple(args))
    if case in ("five_valid", "none_valid"):
        assert not bool(res.ok.any())


def below_128(n, S, share, device):
    """The problem of a case with n < 128 slots, S streams with a prior
    (S = 1 without a stream axis, as StereoVO's frame step has it), and
    its parameters: at 96 the scaling config's 64 hypotheses
    (frontend_scaling_worker.py), else RansacParams()'s."""
    params = RansacParams(num_hypotheses=64) if n == 96 else RansacParams()
    first = 500 + n + int(100 * share)
    args = batch(list(range(first, first + S)), device, inlier_share=share, N=n,
                 H=params.num_hypotheses)
    if S == 1:
        args = (args[0],) + tuple(a[0] for a in args[1:])
    return args, params


# Below 128 slots the plain path's cuBLAS kernels and reduction configs
# change with N while the kernel keeps N = 128's orders: each stage's
# largest gap (stage_gaps) over the three inlier shares, read on the card
# (H100, PyTorch 2.11); 0.0 where the stage is bit-equal. At 8 streams
# every stage is; one stream's LO chain poses and result part by rounding
# (in every stream: share 1.0), their inlier masks and counts do not.
_BIT_EQUAL = dict.fromkeys(("idx_share", "T_h", "T_h_share", "msac_rel", "best_share", "T_lo",
                            "T_lo_share", "count_lo_share", "inliers_lo_share", "T_wc",
                            "T_wc_share", "inliers_share", "ok_share", "ratio"), 0.0)
BELOW_128_GAPS = {
    (96, 1): {**_BIT_EQUAL, "T_lo": 3.427267074584961e-07, "T_lo_share": 1.0,
              "T_wc": 3.129243850708008e-07, "T_wc_share": 1.0},
    (96, 8): _BIT_EQUAL,
    (64, 1): {**_BIT_EQUAL, "T_lo": 9.5367431640625e-07, "T_lo_share": 1.0,
              "T_wc": 9.5367431640625e-07, "T_wc_share": 1.0},
    (64, 8): _BIT_EQUAL,
}


@pytest.mark.chip
@pytest.mark.parametrize("share", [1.0, 0.7, 0.3])
@pytest.mark.parametrize("S", [1, 8])
@pytest.mark.parametrize("n", [96, 64])
def test_kernel_below_128_slots_within_the_measured_gaps(n, S, share):
    dev = _card()
    args, params = below_128(n, S, share, dev)
    res, st = pnp.ransac_pnp_kernel(*args[:5], params, args[5], stages=True)
    ref = pnp.ransac_pnp_ref(*args[:5], params, args[5])
    want = plain_stages(*args[:5], params, args[5])
    gaps = stage_gaps(st, want, res, ref)
    bound = BELOW_128_GAPS[n, S]
    assert set(gaps) == set(bound)
    assert all(gaps[k] <= bound[k] for k in gaps), {k: (gaps[k], bound[k]) for k in gaps}


@pytest.mark.chip
def test_stream_of_a_batch_against_its_single_call():
    """Stream s of an S = 8 call against the same stream alone: the index
    sets, DLT poses, scores and winner bit for bit; the LO chains and the
    result as close as the plain path's own S = 8 and S = 1 calls are (the
    Gauss-Newton sums and the single 4x4 products take S's orders)."""
    dev = _card()
    params = RansacParams()
    args = batch(list(range(40, 48)), dev, inlier_share=0.7)
    res8, st8 = pnp.ransac_pnp_kernel(*args[:5], params, args[5], stages=True)
    plain8 = pnp.ransac_pnp_ref(*args[:5], params, args[5])
    for s in range(8):
        one = tuple(a[s] for a in args[1:])
        res1, st1 = pnp.ransac_pnp_kernel(args[0], *one[:4], params, one[4], stages=True)
        plain1 = pnp.ransac_pnp_ref(args[0], *one[:4], params, one[4])
        for n in ("idx", "T_h", "msac", "best"):
            assert torch.equal(_bits(getattr(st8, n)[s]), _bits(getattr(st1, n))), n
        gap = float((res8.T_wc[s] - res1.T_wc).abs().max())
        plain_gap = float((plain8.T_wc[s] - plain1.T_wc).abs().max())
        assert gap == plain_gap, (s, gap, plain_gap)
        assert torch.equal(res1.T_wc, plain1.T_wc) and torch.equal(res8.T_wc[s], plain8.T_wc[s])


@pytest.mark.chip
def test_captured_replay_equals_eager_and_counts_launches():
    """ransac_pnp on the card launches the kernel twice a call, also inside
    a CUDA graph: a replay with new inputs copied in equals an eager call."""
    dev = _card()
    params = RansacParams()
    static = [a.clone() for a in batch(list(range(8)), dev, inlier_share=0.7)]
    _build.set_counters({"ransac_pnp.launches": 0})
    pnp.ransac_pnp(*static[:5], params, T_init=static[5])  # warm-up, builds the library
    assert _build.counters()["ransac_pnp.launches"] == 2
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.cuda.graph(graph):
        out = pnp.ransac_pnp(*static[:5], params, T_init=static[5])
    torch.cuda.current_stream().wait_stream(side)
    assert _build.counters()["ransac_pnp.launches"] == 4
    for seeds in (range(8, 16), range(16, 24)):
        fresh = batch(list(seeds), dev, inlier_share=0.7)
        for dst, src in zip(static, fresh):
            dst.copy_(src)
        graph.replay()
        want = pnp.ransac_pnp(*fresh[:5], params, T_init=fresh[5])
        torch.cuda.synchronize()
        assert not _unequal(out, want, RESULT)


# ---- on the card, past 128 slots (the wide path) --------------------------------

WIDE_N = (256, 1024, 2048)


@pytest.mark.chip
@pytest.mark.parametrize("n", WIDE_N)
@pytest.mark.parametrize("S", [1, 8])
def test_plain_sums_follow_the_wide_splits(S, n):
    """The plain path's sums past 128 slots, torch.sum on the card, bit for
    bit in the orders the kernel repeats: the MSAC score over the slots
    (S (H + P) outputs), a chain's score (S outputs) and the Gauss-Newton
    sums of H (36 a stream) and g (6); S = 1 with no stream axis, as
    StereoVO's frame step has it."""
    dev = _card()
    bh_H, bh_g, ct_H, ct_g, bw_h, bw_s = pnp.kernel_split(S, n, 128, 1)
    rng = np.random.default_rng(17 + S + n)
    lead = (S,) if S > 1 else ()
    cases = [
        (rng.uniform(0, 64, lead + (129, n)), lambda x: emulate_slot_sum(x, bw_h), -1),
        (rng.uniform(0, 64, lead + (n,)), lambda x: emulate_slot_sum(x, bw_s), -1),
        (rng.normal(0, 1e3, lead + (n, 6, 6)), lambda x: emulate_point_sum(x, bh_H, ct_H), -3),
        (rng.normal(0, 1e2, lead + (n, 6, 1)), lambda x: emulate_point_sum(x, bh_g, ct_g), -3),
    ]
    for x, emulate, dim in cases:
        x = x.astype(np.float32)
        got = torch.sum(torch.from_numpy(x).to(dev), dim=dim).cpu().numpy()
        want = emulate(x)
        assert got.view(np.int32).tolist() == want.view(np.int32).tolist(), (x.shape, dim)


def _gn_products(K, T, Xw, uv, w):
    """_gn_refine's per-point products of one step before its sums over the
    points: J^T (J w) and J^T (r w), in its own ops."""
    fx, fy = K[0, 0], K[1, 1]
    eye3 = torch.eye(3, dtype=Xw.dtype, device=Xw.device)
    w = w[..., None, None]
    Xc = se3.transform(T, Xw)
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = fx * x * inv_z + K[0, 2]
    v = fy * y * inv_z + K[1, 2]
    r = torch.stack([u - uv[..., 0], v - uv[..., 1]], dim=-1)
    zero = torch.zeros_like(x)
    Jpi = torch.stack([torch.stack([fx * inv_z, zero, -fx * x * inv_z * inv_z], dim=-1),
                       torch.stack([zero, fy * inv_z, -fy * y * inv_z * inv_z], dim=-1)], dim=-2)
    Jx = torch.cat([eye3.expand(Xc.shape[:-1] + (3, 3)), -se3.hat(Xc)], dim=-1)
    J = Jpi @ Jx
    Jt = J.transpose(-1, -2)
    return Jt @ (J * w), Jt @ (r[..., None] * w)


@pytest.mark.chip
@pytest.mark.parametrize("n", WIDE_N)
@pytest.mark.parametrize("S", [1, 8])
def test_plain_per_point_ops_keep_their_orders_past_128(S, n):
    """The plain path's per-point products (the reprojection's X R^T + t,
    for H + P poses and for one; the Gauss-Newton step's J, J^T J w and
    J^T r w) give a point the same bits at n slots as at 128, where the
    kernel's orders were read: cuBLAS keeps its orders as the batch grows."""
    dev = _card()
    K, Xw, uv, valid, noise, T_init = batch(list(range(60 + S, 60 + 2 * S)), dev, N=n,
                                            inlier_share=0.7)
    if S == 1:
        Xw, uv, valid, T_init = Xw[0], uv[0], valid[0], T_init[0]
    T_h = torch.stack([T_init] * 129, dim=-3)
    T_h = T_h + 1e-3 * torch.arange(129, device=dev, dtype=torch.float32)[:, None, None]
    w = (torch.arange(n, device=dev) % 3 != 0).to(torch.float32).expand(valid.shape)
    head = (..., slice(0, 128))
    for full, part, at in (
            (pnp._reproj_errors(K, T_h, Xw, uv),
             pnp._reproj_errors(K, T_h, Xw[..., :128, :], uv[..., :128, :]), head),
            (pnp._reproj_errors(K, T_init, Xw, uv),
             pnp._reproj_errors(K, T_init, Xw[..., :128, :], uv[..., :128, :]), head),
            (_gn_products(K, T_init, Xw, uv, w),
             _gn_products(K, T_init, Xw[..., :128, :], uv[..., :128, :], w[..., :128]),
             (..., slice(0, 128), slice(None), slice(None)))):
        for a, b in zip(full, part):
            assert torch.equal(_bits(a[at]), _bits(b)), (tuple(a.shape), tuple(b.shape))


@pytest.mark.chip
@pytest.mark.parametrize("share", [1.0, 0.7, 0.3])
@pytest.mark.parametrize("prior", [True, False])
@pytest.mark.parametrize("lead", [(), (8,)])
@pytest.mark.parametrize("n", WIDE_N)
def test_kernel_wide_bit_equal_to_plain_stage_by_stage(n, lead, prior, share):
    """Past 128 slots (the dense configuration's 2048 among them): every
    stage and the result bit for bit, one stream with no stream axis
    (StereoVO's frame step) and 8 streams."""
    dev = _card()
    S = max(lead, default=1)
    first = 3000 + n + int(100 * share)
    args = batch(list(range(first, first + S)), dev, with_prior=prior, inlier_share=share, N=n)
    if not lead:
        args = (args[0],) + tuple(a[0] if a is not None else None for a in args[1:])
    _check(args)


@pytest.mark.chip
def test_kernel_wide_captured_counts_launches_and_slots():
    """Past 128 slots a call is still two launches, also inside a CUDA
    graph, and counts its S x N slots; a replay with new inputs equals an
    eager call."""
    dev = _card()
    params = RansacParams()
    static = [a.clone() for a in batch(list(range(8)), dev, inlier_share=0.7, N=2048)]
    _build.set_counters({"ransac_pnp.launches": 0, "ransac_pnp.slots": 0})
    pnp.ransac_pnp(*static[:5], params, T_init=static[5])
    c = _build.counters()
    assert (c["ransac_pnp.launches"], c["ransac_pnp.slots"]) == (2, 8 * 2048)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.cuda.graph(graph):
        out = pnp.ransac_pnp(*static[:5], params, T_init=static[5])
    torch.cuda.current_stream().wait_stream(side)
    fresh = batch(list(range(8, 16)), dev, inlier_share=0.7, N=2048)
    for dst, src in zip(static, fresh):
        dst.copy_(src)
    graph.replay()
    want = pnp.ransac_pnp(*fresh[:5], params, T_init=fresh[5])
    torch.cuda.synchronize()
    assert not _unequal(out, want, RESULT)
