"""Windowed bundle adjustment: Schur-complement Levenberg-Marquardt.

Port of svo_tpu/ba/solver.py. The problem is a fixed-shape COO observation
table (observation -> camera slot, point slot, pixel measurement, validity
mask); variable counts are masks. Residuals and Jacobians are evaluated for
all observations at once, point marginalisation (the Schur trick) is
segment sums keyed by point, by camera and by (camera, point), the reduced
(6K x 6K) camera system is assembled with one dense product over the point
slots and solved dense, and LM damping with accept/reject runs a fixed
number of iterations (svo_tpu's lax.scan is a Python loop here).

Stereo-aware residuals: an observation optionally carries the right-camera
horizontal coordinate u_r; its third residual row pins the scale gauge that
left-only BA leaves free. Gauge: the first `n_fixed` cameras are frozen.
Cameras are parametrised by T_cw (world->camera); updates are
left-multiplicative twists, T_cw <- exp(delta) @ T_cw.

Leading axes: every leaf of a BAProblem may carry the same leading axes
(streams, blocks); each leading index is an independent problem, solved in
the same launches as the others, and every result carries those axes. What
svo_tpu gets from jax.vmap is written out here.

Segment sums: svo_tpu accumulates Hcc, Hpp, Wcp, bc and bp with
.at[idx].add. On the card index_add_ adds with atomics, in an order that
changes from run to run, and a cost at the accept/reject edge could fall
either way. The port sorts each key table once per solve (the keys do not
change over the iterations) and sums sorted runs (ops/index.segment_sum):
bit-identical from call to call, at the price of three stable sorts a
solve and one gather per sum.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.geometry import se3
from vobench.reference.ops.index import segment_sum, segments, take_rows
from vobench.reference.ops.linalg import inv3x3


class BAProblem(NamedTuple):
    """Fixed-shape windowed BA problem: K cameras, P point slots, O
    observation slots (leading axes allowed, see the module docstring)."""

    T_cw: torch.Tensor       # (K,4,4) world->camera poses
    cam_valid: torch.Tensor  # (K,) bool
    points: torch.Tensor     # (P,3) world points
    pnt_valid: torch.Tensor  # (P,) bool
    obs_cam: torch.Tensor    # (O,) i32 camera slot
    obs_pnt: torch.Tensor    # (O,) i32 point slot
    obs_uv: torch.Tensor     # (O,3) u_left, v_left, u_right (-1 if mono)
    obs_valid: torch.Tensor  # (O,) bool

class BAResult(NamedTuple):
    T_cw: torch.Tensor
    points: torch.Tensor
    cost0: torch.Tensor  # initial robust cost
    cost: torch.Tensor   # final robust cost
    n_obs: torch.Tensor  # i32 valid observations


def _residuals(K_mat, baseline_fx, T_cw, points, obs_cam, obs_pnt, obs_uv):
    """Residuals (..., O, 3) and Jacobians wrt the camera twist (..., O, 3, 6)
    and the point (..., O, 3, 3). The third row is the right-camera u
    residual (stereo), masked by obs_uv[..., 2] >= 0."""
    fx, fy = K_mat[0, 0], K_mat[1, 1]
    cx, cy = K_mat[0, 2], K_mat[1, 2]

    T = take_rows(T_cw, obs_cam)     # (..., O, 4, 4)
    X = take_rows(points, obs_pnt)   # (..., O, 3)
    Xc = se3.transform(T, X)
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    inv_z = 1.0 / zs
    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy
    # right camera of a rectified rig: u_r = u - fx*b/z
    u_r = u - baseline_fx * inv_z

    has_stereo = obs_uv[..., 2] >= 0.0
    r = torch.stack(
        [
            u - obs_uv[..., 0],
            v - obs_uv[..., 1],
            torch.where(has_stereo, u_r - obs_uv[..., 2], 0.0),
        ],
        dim=-1,
    )

    zero = torch.zeros_like(x)
    # d pi / d Xc for the 3 rows
    Jpi = torch.stack(
        [
            torch.stack([fx * inv_z, zero, -fx * x * inv_z * inv_z], dim=-1),
            torch.stack([zero, fy * inv_z, -fy * y * inv_z * inv_z], dim=-1),
            torch.stack([fx * inv_z, zero, (-fx * x + baseline_fx) * inv_z * inv_z], dim=-1),
        ],
        dim=-2,
    )
    one = torch.ones_like(zero)
    Jpi = Jpi * torch.stack([one, one, has_stereo.to(Jpi.dtype)], dim=-1)[..., None]

    # d Xc / d twist = [I | -hat(Xc)], d Xc / d X = R
    I3 = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape[:-1] + (3, 3))
    Jx = torch.cat([I3, -se3.hat(Xc)], dim=-1)
    return r, Jpi @ Jx, Jpi @ T[..., :3, :3]


def _robust_weights(r, valid, delta, reject):
    """Trimmed-Huber IRLS weights (..., O) and the robust cost (...,).

    Huber bounds an outlier's influence but never zeroes it; residuals
    beyond `reject` get weight 0, the BA-side analogue of the front-end's
    RANSAC outlier removal. The cost saturates for rejected rows so that
    accept/reject comparisons stay monotone."""
    e = torch.linalg.norm(r, dim=-1)
    w = torch.where(e <= delta, 1.0, delta / torch.clamp(e, min=1e-12))
    w = torch.where(e > reject, 0.0, w)
    w = w * valid.to(r.dtype)
    rho = torch.where(e <= delta, 0.5 * e * e, delta * (e - 0.5 * delta))
    rho = torch.clamp(rho, max=delta * (reject - 0.5 * delta))
    return w, torch.sum(rho * valid.to(r.dtype), dim=-1)


def _flatten_lead(problem: BAProblem) -> tuple[BAProblem, tuple]:
    """The problem with its leading axes folded into one, and those axes."""
    lead = tuple(problem.cam_valid.shape[:-1])
    return BAProblem(*(x.reshape((-1,) + x.shape[len(lead):]) for x in problem)), lead


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(table, -1, idx.long())


class _Setup(NamedTuple):
    """What both solvers derive from a flattened problem before iterating."""
    obs_cam: torch.Tensor   # (B, O) i32, clipped into range
    obs_pnt: torch.Tensor
    ov: torch.Tensor        # (B, O) bool: observation, its camera and its point valid
    fixed: torch.Tensor     # (B, K) bool: gauge anchors and invalid slots


def _setup(p: BAProblem, n_fixed: int) -> _Setup:
    Kc, P = p.T_cw.shape[-3], p.points.shape[-2]
    obs_cam = p.obs_cam.clamp(0, Kc - 1)
    obs_pnt = p.obs_pnt.clamp(0, P - 1)
    ov = p.obs_valid & _gather(p.cam_valid, obs_cam) & _gather(p.pnt_valid, obs_pnt)
    fixed = (torch.arange(Kc, device=ov.device) < n_fixed) | ~p.cam_valid
    return _Setup(obs_cam, obs_pnt, ov, fixed)


def _result(lead, T_cw, points, cost0, cost, ov) -> BAResult:
    return BAResult(
        T_cw=T_cw.reshape(lead + T_cw.shape[1:]),
        points=points.reshape(lead + points.shape[1:]),
        cost0=cost0.reshape(lead),
        cost=cost.reshape(lead),
        n_obs=torch.sum(ov.to(torch.int32), dim=-1, dtype=torch.int32).reshape(lead),
    )


def solve_ba(
    problem: BAProblem,
    K_mat: torch.Tensor,
    baseline_fx,
    iterations: int = 10,
    n_fixed: int = 1,
    huber_delta: float = 5.0,
    reject_threshold: float = 20.0,
    init_lambda: float = 1e-4,
) -> BAResult:
    """LM with Schur-complement camera reduction on a windowed problem (or
    on a stack of them, see the module docstring). A singular reduced
    system moves nothing: the solve returns inf/NaN without raising
    (solve_ex, no host sync) and the step is zeroed."""
    p, lead = _flatten_lead(problem)
    B, Kc, P = p.T_cw.shape[0], p.T_cw.shape[-3], p.points.shape[-2]
    obs_cam, obs_pnt, ov, fixed = _setup(p, n_fixed)
    f32, dev = p.T_cw.dtype, p.T_cw.device

    def residuals(T_cw, points):
        return _residuals(K_mat, baseline_fx, T_cw, points, obs_cam, obs_pnt, p.obs_uv)

    def cost_at(T_cw, points):
        return _robust_weights(residuals(T_cw, points)[0], ov, huber_delta, reject_threshold)[1]

    T_cw, points = p.T_cw, p.points
    cost0 = cost = cost_at(T_cw, points)
    if iterations:
        seg_c = segments(obs_cam, Kc)
        seg_p = segments(obs_pnt, P)
        seg_cp = segments(obs_cam.long() * P + obs_pnt, Kc * P)
        eye3 = torch.eye(3, dtype=f32, device=dev)
        fixed6 = fixed.repeat_interleave(6, dim=-1)       # (B, 6K)
        fixed66 = fixed6[:, :, None] | fixed6[:, None, :]
    lam = torch.full((B,), init_lambda, dtype=f32, device=dev)
    for _ in range(iterations):
        r, J_c, J_p = residuals(T_cw, points)
        w, _ = _robust_weights(r, ov, huber_delta, reject_threshold)
        wJ_c = (J_c * w[..., None, None]).mT                    # (B,O,6,3)
        wJ_p = (J_p * w[..., None, None]).mT                    # (B,O,3,3)

        # per-observation blocks, summed into dense tables by key; what
        # shares a key table shares one sum
        by_cam = torch.cat([(wJ_c @ J_c).flatten(-2), (wJ_c @ r[..., None])[..., 0]], dim=-1)
        by_pnt = torch.cat([(wJ_p @ J_p).flatten(-2), (wJ_p @ r[..., None])[..., 0]], dim=-1)
        by_cam = segment_sum(by_cam, seg_c)
        by_pnt = segment_sum(by_pnt, seg_p)
        Hcc, bc = by_cam[..., :36].reshape(B, Kc, 6, 6), by_cam[..., 36:]
        Hpp, bp = by_pnt[..., :9].reshape(B, P, 3, 3), by_pnt[..., 9:]
        Wcp = segment_sum(wJ_c @ J_p, seg_cp).reshape(B, Kc, P, 6, 3)

        # damped point-block inverse
        tr = torch.clamp(Hpp.diagonal(dim1=-2, dim2=-1).sum(-1), min=1e-6)
        Hpp_d = Hpp + lam[:, None, None, None] * eye3 * tr[..., None, None] / 3.0
        Hpp_d = Hpp_d + 1e-8 * eye3
        Hpp_inv = torch.where(p.pnt_valid[..., None, None], inv3x3(Hpp_d), 0.0)

        # Schur complement S = Hcc - Wcp Hpp^-1 Wcp^T: one dense product over
        # the point slots, written as (6K, 3P) matrices so that each problem
        # of a stack multiplies the shapes it would alone
        Wf = Wcp.permute(0, 1, 3, 2, 4).reshape(B, Kc * 6, P * 3)
        Yf = (Wcp @ Hpp_inv[:, None]).permute(0, 1, 3, 2, 4).reshape(B, Kc * 6, P * 3)
        S_off = Yf @ Wf.mT                                      # (B,6K,6K)
        # (matrix-vector products as multiply-and-sum: a stacked problem then
        # adds in the order it would alone, which bmm does not promise)
        yb = (Yf * bp.reshape(B, 1, P * 3)).sum(-1)
        Sf = -S_off
        Sf.view(B, Kc, 6, Kc, 6).diagonal(dim1=1, dim2=3).add_(Hcc.permute(0, 2, 3, 1))
        b_red = bc.reshape(B, Kc * 6) - yb

        # gauge fixing and damping
        Sf = torch.where(fixed66, 0.0, Sf)
        diag = Sf.diagonal(dim1=-2, dim2=-1)
        Sf = Sf + torch.diag_embed(
            torch.where(fixed6, 1.0, lam[:, None] * torch.clamp(diag, min=1e-6))
        )
        bf = torch.where(fixed6, 0.0, b_red)

        delta_c = -torch.linalg.solve_ex(Sf, bf[..., None], check_errors=False)[0]
        delta_c = delta_c.reshape(B, Kc, 6)
        finite = torch.isfinite(delta_c).flatten(1).all(dim=-1)
        delta_c = torch.where(finite[:, None, None], delta_c, 0.0)

        # back-substitute points: dp = -Hpp^-1 (bp + Wcp^T dc)
        rhs_p = bp + (Wf * delta_c.reshape(B, Kc * 6, 1)).sum(1).reshape(B, P, 3)
        delta_p = -(Hpp_inv @ rhs_p[..., None])[..., 0]
        delta_p = torch.where(p.pnt_valid[..., None], delta_p, 0.0)

        T_new = se3.compose(se3.exp(delta_c), T_cw)
        T_new = torch.where(fixed[..., None, None], T_cw, T_new)
        pts_new = points + delta_p

        new_cost = cost_at(T_new, pts_new)
        accept = (new_cost < cost) & torch.isfinite(new_cost)
        T_cw = torch.where(accept[:, None, None, None], T_new, T_cw)
        points = torch.where(accept[:, None, None], pts_new, points)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-9, 1e4)
    return _result(lead, T_cw, points, cost0, cost, ov)


def refine_alternate(
    problem: BAProblem,
    K_mat: torch.Tensor,
    baseline_fx,
    rounds: int = 6,
    n_fixed: int = 1,
    huber_delta: float = 5.0,
    reject_threshold: float = 20.0,
    mono_weight: float = 0.25,
    max_polish_span: int = 8,
    points_only: bool = False,
) -> BAResult:
    """Alternating resection-intersection refinement (the conservative
    back-end path).

    Joint pose+point BA can transport both variable sets coherently along
    weakly observable modes: reprojection cost drops while the trajectory
    walks away from truth. Alternation makes that move impossible by
    construction: each half-step optimises one variable set against the
    other held fixed.

    - intersection: per-point damped GN on the 3x3 normal system (points
      against fixed poses), multi-view re-triangulation;
    - resection: per-camera damped GN on the 6x6 normal system (poses
      against the fixed map), each camera an independent PnP polish.

    Each half-step is accepted only if the shared robust objective does not
    rise, so the sequence is monotone. points_only skips the resection."""
    p, lead = _flatten_lead(problem)
    B, Kc, P = p.T_cw.shape[0], p.T_cw.shape[-3], p.points.shape[-2]
    obs_cam, obs_pnt, ov, fixed = _setup(p, n_fixed)
    f32, dev = p.T_cw.dtype, p.T_cw.device
    seg_p = segments(obs_pnt, P)
    seg_c = None if points_only else segments(obs_cam, Kc)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye6 = torch.eye(6, dtype=f32, device=dev)

    def residuals(T_cw, points):
        return _residuals(K_mat, baseline_fx, T_cw, points, obs_cam, obs_pnt, p.obs_uv)

    def cost_at(T_cw, points):
        return _robust_weights(residuals(T_cw, points)[0], ov, huber_delta, reject_threshold)[1]

    mono_row = p.obs_uv[..., 2] < 0.0

    # Per-point polish gate by observation span: a point observed across
    # many frames of the window has accumulated chained-KLT drift in its
    # later measurements, and re-fitting it bakes that drift into the map.
    # Points with span > max_polish_span keep their positions.
    big = 1 << 20
    first_cam = torch.full((B, P), big, dtype=torch.int32, device=dev).scatter_reduce_(
        -1, obs_pnt.long(), torch.where(ov, obs_cam, big), "amin", include_self=True
    )
    last_cam = torch.full((B, P), -1, dtype=torch.int32, device=dev).scatter_reduce_(
        -1, obs_pnt.long(), torch.where(ov, obs_cam, -1), "amax", include_self=True
    )
    obs_span = torch.clamp(last_cam - first_cam, min=0)
    polish_ok = p.pnt_valid & (obs_span <= max_polish_span)

    def point_step(T_cw, points):
        r, _, J_p = residuals(T_cw, points)
        w, _ = _robust_weights(r, ov, huber_delta, reject_threshold)
        # down-weight mono tracking observations against the birth stereo
        # row: chained-track drift lives in the later mono measurements
        w = w * torch.where(mono_row, mono_weight, 1.0)
        wJ = (J_p * w[..., None, None]).mT
        by_pnt = torch.cat([(wJ @ J_p).flatten(-2), (wJ @ r[..., None])[..., 0]], dim=-1)
        by_pnt = segment_sum(by_pnt, seg_p)
        Hpp, bp = by_pnt[..., :9].reshape(B, P, 3, 3), by_pnt[..., 9:]
        tr = Hpp.diagonal(dim1=-2, dim2=-1).sum(-1)
        Hd = Hpp + 1e-6 * eye3 + 1e-3 * eye3 * tr[..., None, None] / 3.0
        dp = -(inv3x3(Hd) @ bp[..., None])[..., 0]
        ok = polish_ok[..., None] & torch.all(torch.isfinite(dp), dim=-1, keepdim=True)
        return points + torch.where(ok, dp, 0.0)

    def pose_step(T_cw, points):
        r, J_c, _ = residuals(T_cw, points)
        w, _ = _robust_weights(r, ov, huber_delta, reject_threshold)
        wJ = (J_c * w[..., None, None]).mT
        by_cam = torch.cat([(wJ @ J_c).flatten(-2), (wJ @ r[..., None])[..., 0]], dim=-1)
        by_cam = segment_sum(by_cam, seg_c)
        Hcc, bc = by_cam[..., :36].reshape(B, Kc, 6, 6), by_cam[..., 36:]
        tr = Hcc.diagonal(dim1=-2, dim2=-1).sum(-1)
        Hd = Hcc + 1e-6 * eye6 + 1e-3 * eye6 * tr[..., None, None] / 6.0
        dc = -torch.linalg.solve_ex(Hd, bc[..., None], check_errors=False)[0][..., 0]
        frozen = fixed[..., None] | ~torch.all(torch.isfinite(dc), dim=-1, keepdim=True)
        return se3.compose(se3.exp(torch.where(frozen, 0.0, dc)), T_cw)

    T_cw, points = p.T_cw, p.points
    cost0 = cost = cost_at(T_cw, points)
    for _ in range(rounds):
        pts_new = point_step(T_cw, points)
        c1 = cost_at(T_cw, pts_new)
        ok1 = torch.isfinite(c1) & (c1 <= cost)
        points = torch.where(ok1[:, None, None], pts_new, points)
        cost = torch.where(ok1, c1, cost)
        # points_only (the conservative global-refinement path): the caller
        # only ever applies the point half, and intersection against the
        # unmoved shipped poses keeps the polished map consistent with the
        # trajectory the front-end will extend
        if not points_only:
            T_new = pose_step(T_cw, points)
            c2 = cost_at(T_new, points)
            ok2 = torch.isfinite(c2) & (c2 <= cost)
            T_cw = torch.where(ok2[:, None, None, None], T_new, T_cw)
            cost = torch.where(ok2, c2, cost)
    return _result(lead, T_cw, points, cost0, cost, ov)
