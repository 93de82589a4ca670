"""The per-frame VO front-end.

Port of svo_tpu/pipeline/frontend.py: one step per frame,

    track (KLT prev->curr, forward-backward check)
    -> pose (RANSAC-PnP, motion gate, purge)
    -> keyframe? replenish: detect, stereo KLT, triangulate, allocate, merge
    -> window BA? (cfg.ba.enabled) solve the last keyframes, write back

as functions of (state, images) -> state. svo_tpu's lax.scan over a chunk
is a Python loop over frames here.

svo_tpu takes two data-dependent branches inside its jitted step, as
lax.cond: the dynamic keyframe rule's replenishment and the window BA.
Both are functions of the INCOMING state alone (the keyframe rule reads
prev_is_kf, the live feature count, frame_id and last_kf_id; the BA rule
the keyframe flags with this frame's written in), so _branch_key computes
them on the device before any work is done, and the step branches on
their host values, (any stream keyframes, any stream runs the BA): one
host read a frame (_read_key), where the branch depends on data at all.
That key also picks the step's CUDA graph: on the card make_step and the
cadenced chunk step replay one whole-step graph per key value over static
buffers with the state donated, as svo_tpu jits them
(pipeline/graph.py); graph=False is the eager loop, the parity
reference. Within a key, every per-stream choice is a torch.where, as in
svo_tpu.

The PnP noise comes from the state's threefry key, as in svo_tpu: each step
splits state.rng, keeps one half and draws its (hypotheses, N) Gumbel noise
from the other (ops/random.split_gumbel, one kernel launch on the card for
all streams). A step is therefore a function of state and frames alone,
and stream s draws what svo_tpu's stream s draws from the same key.

Scatters follow jax's mode="drop": rows whose index is out of range are
written to a spare row that is then cut off (ops/index.scatter_drop), never
raised on and never read back.

The stream axis: svo_tpu steps S streams in lockstep with jax.vmap of this
step. Here every function takes the state with a leading (S,) on each leaf
and images (S, H, W), written out as leading "..." axes, so the same body
steps one stream or S, with no loop over streams. Where some streams
branch and others do not, the branch is computed for all streams and
selected per stream (what jax.vmap makes of svo_tpu's lax.cond), and it is
skipped when no stream takes it.

The in-pipeline window BA (cfg.ba.enabled): on a keyframe step whose
keyframe count has reached cfg.ba.window and is a multiple of
cfg.ba.interval, solve_ba runs over the last cfg.ba.window keyframes and
writes points and poses back. Computing and selecting it on every keyframe
step instead of branching would cost `interval` times the solves
(thousands of launches each); with ba.enabled=False the step carries no BA
code and its key no BA flag.
"""

from __future__ import annotations

import dataclasses

import torch

from vobench.reference.ba.solver import solve_ba
from vobench.reference.ba.window import extract_kf_window, write_back_kf
from vobench.reference.config import Config
from vobench.reference.geometry import se3
from vobench.reference.geometry.camera import Camera, project as camera_project
from vobench.reference.geometry.pnp import ransac_pnp
from vobench.reference.geometry.triangulate import triangulate_dlt, triangulate_rectified
from vobench.reference.ops import detect as detect_mod
from vobench.reference.ops.index import scatter_drop, take_rows
from vobench.reference.ops.klt import KltTracker
from vobench.reference.ops.random import prng_key, split_gumbel
from vobench.reference.pipeline.state import FeatureSet, MapState, VoState


def _count(mask: torch.Tensor) -> torch.Tensor:
    """True entries along the last axis, i32."""
    return torch.sum(mask.to(torch.int32), dim=-1, dtype=torch.int32)


def _select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a where the per-stream flag cond (...,) holds, else b; a and b carry
    cond's axes first."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim())), a, b)


def _all_finite(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 1, 1) bool: every entry of the matrix finite."""
    return torch.all(torch.isfinite(T.flatten(-2)), dim=-1)[..., None, None]


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _alloc_points(
    mp: MapState, Xw: torch.Tensor, valid: torch.Tensor
) -> tuple[torch.Tensor, MapState]:
    """Allocate map-point slots for valid rows of Xw (monotone cursor).
    Returns per-row point ids (-1 where invalid or the table is full)."""
    M = mp.points.shape[-2]
    v = valid.to(torch.int32)
    offsets = torch.cumsum(v, -1, dtype=torch.int32) - v  # rank among valid rows
    ids = torch.where(valid, mp.n_points[..., None] + offsets, -1)
    ids = torch.where(ids < M, ids, -1)  # capacity guard
    points = scatter_drop(mp.points, ids, Xw)
    return ids, mp._replace(points=points, n_points=mp.n_points + _count(ids >= 0))


def _record_obs(
    mp: MapState,
    uv: torch.Tensor,
    pid: torch.Tensor,
    valid: torch.Tensor,
    frame_id: torch.Tensor,
    u_right: torch.Tensor | None = None,
) -> MapState:
    """Append (frame, point, uv[, u_right]) rows to the observation ring;
    u_right < 0 marks a mono observation."""
    O = mp.obs_u.shape[-1]
    v = valid.to(torch.int32)
    offs = torch.cumsum(v, -1, dtype=torch.int32) - v
    slots = torch.where(valid, (mp.obs_cursor[..., None] + offs) % O, O)  # O -> dropped
    if u_right is None:
        u_right = torch.full(pid.shape, -1.0, dtype=torch.float32, device=pid.device)
    return mp._replace(
        obs_u=scatter_drop(mp.obs_u, slots, uv[..., 0]),
        obs_v=scatter_drop(mp.obs_v, slots, uv[..., 1]),
        obs_ur=scatter_drop(mp.obs_ur, slots, u_right),
        obs_pid=scatter_drop(mp.obs_pid, slots, pid),
        obs_fid=scatter_drop(mp.obs_fid, slots, frame_id[..., None].expand(pid.shape)),
        obs_cursor=mp.obs_cursor + _count(valid),
    )


def _merge_features(
    feats: FeatureSet,
    new_pos: torch.Tensor,
    new_pid: torch.Tensor,
    new_score: torch.Tensor,
    new_valid: torch.Tensor,
) -> FeatureSet:
    """Merge tracked survivors with fresh detections into the fixed N slots.
    Tracked features always win a slot; leftovers go to the best-scoring
    detections.

    Every tracked key is 2e9 + age in f32, one value for all small ages, so
    the slot order comes from the tie rule alone: a stable sort keeps
    lax.top_k's lower-index-first order."""
    N = feats.pos.shape[-2]
    key_tracked = torch.where(feats.valid, 2e9 + feats.age.to(torch.float32), -1.0)
    key_new = torch.where(new_valid, torch.clamp(new_score, min=0.0), -1.0)
    keys = torch.cat([key_tracked, key_new], dim=-1)
    idx = torch.sort(keys, dim=-1, descending=True, stable=True)[1][..., :N]
    return FeatureSet(
        pos=take_rows(torch.cat([feats.pos, new_pos], dim=-2), idx),
        valid=torch.gather(keys, -1, idx) >= 0.0,
        point_id=torch.gather(torch.cat([feats.point_id, new_pid], dim=-1), -1, idx),
        age=torch.gather(torch.cat([feats.age, torch.zeros_like(new_pid)], dim=-1), -1, idx),
        anchor=take_rows(torch.cat([feats.anchor, new_pos], dim=-2), idx),
    )


# --------------------------------------------------------------------------
# replenishment: detect + stereo match + triangulate
# --------------------------------------------------------------------------

def _replenish(
    feats: FeatureSet,
    mp: MapState,
    left: torch.Tensor,
    pyr_l,
    right: torch.Tensor,
    pose: torch.Tensor,
    frame_id: torch.Tensor,
    camera: Camera,
    cfg: Config,
    lk_engine: str = "patches",
) -> tuple[FeatureSet, MapState]:
    # 1. detect with suppression around the current live features
    det_pos, _, det_valid = detect_mod.detect(left, feats.pos, feats.valid, cfg)

    # 2. stereo match left->right with KLT + vertical-disparity gate
    pyr_r = KltTracker.build_pyramid(right, cfg.stereo_klt.max_level)
    sres = KltTracker.track(
        pyr_l, pyr_r, det_pos, det_valid, cfg.stereo_klt, engine=lk_engine
    )
    y_ok = torch.abs(sres.pos[..., 1] - det_pos[..., 1]) < cfg.tracking.y_threshold
    s_valid = det_valid & sres.status & y_ok

    # 3. triangulate, cheirality z > 0, depth cap, to world via the pose
    if cfg.triangulator == "rectified":
        Xc = triangulate_rectified(camera.fx, camera.baseline, det_pos, sres.pos, camera.K)
    else:
        Xc = triangulate_dlt(camera.P_left, camera.P_right, det_pos, sres.pos)
    new_valid = s_valid & (Xc[..., 2] > 0)
    if cfg.tracking.max_depth_baselines > 0:
        new_valid = new_valid & (Xc[..., 2] < cfg.tracking.max_depth_baselines * camera.baseline)
    Xw = se3.transform(pose, Xc)

    # 4. allocate map points + record the triangulating (stereo) observation
    ids, mp = _alloc_points(mp, Xw, new_valid)
    new_valid = new_valid & (ids >= 0)
    u_right = torch.where(sres.status, sres.pos[..., 0], -1.0)
    mp = _record_obs(mp, det_pos, ids, new_valid, frame_id, u_right=u_right)

    # 5. merge: survivors re-anchor at this keyframe; new detections compete
    #    by selection order (spatially spread), not by raw score
    feats = feats._replace(anchor=feats.pos)
    D = det_pos.shape[-2]
    det_prio = torch.arange(D, 0, -1, dtype=torch.float32, device=det_pos.device)
    return _merge_features(feats, det_pos, ids, det_prio.expand(ids.shape), new_valid), mp


def _window_ba(
    mp: MapState, poses: torch.Tensor, kf_flags: torch.Tensor, fid: torch.Tensor,
    camera: Camera, cfg: Config,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One keyframe-window BA solve on the live state: the map's points and
    the trajectory after write-back (the input's where the solve did not
    lower its cost). Non-keyframe poses in the span ride their preceding
    keyframe's rigid correction (write_back_kf)."""
    problem, mapping = extract_kf_window(
        mp, poses, kf_flags, fid,
        n_cams=cfg.ba.window, n_points=cfg.ba.max_points, n_obs=cfg.ba.max_obs,
    )
    res = solve_ba(
        problem, camera.K, camera.K[0, 0] * camera.baseline,
        iterations=cfg.ba.iterations, n_fixed=cfg.ba.n_fixed,
        huber_delta=cfg.ba.huber_delta, reject_threshold=cfg.ba.reject_threshold,
        init_lambda=cfg.ba.init_lambda,
    )
    improved = res.cost <= res.cost0
    mp_out, poses_out = write_back_kf(
        mp, poses, mapping, fid,
        _select(improved, res.T_cw, problem.T_cw),
        _select(improved, res.points, problem.points),
        problem.pnt_valid, problem.cam_valid,
    )
    return mp_out.points, poses_out


# --------------------------------------------------------------------------
# the branch key
# --------------------------------------------------------------------------

def _branch_key(state: VoState, cfg: Config, kf_mode: str):
    """The coming frame's branches, per stream, from the incoming state
    alone, with the step's own expressions: (is_kf, kf_flags, run_ba).
    kf_flags is the trajectory's with is_kf written at the frame's id
    (dropped past capacity.max_frames, as the step drops it); run_ba is the
    window BA's rule on it, None where the step carries no BA
    (ba.enabled off, or kf_mode "never")."""
    fid = state.frame_id + 1
    if kf_mode == "dynamic":
        is_kf = (~state.prev_is_kf) & (state.features.count() < cfg.tracking.features_to_track)
        if cfg.tracking.kf_max_interval > 0:
            is_kf = is_kf | (
                (~state.prev_is_kf)
                & (fid - state.last_kf_id >= cfg.tracking.kf_max_interval)
            )
    else:
        is_kf = torch.full(fid.shape, kf_mode == "always", dtype=torch.bool, device=fid.device)
    kf_flags = scatter_drop(state.kf_flags, fid[..., None], is_kf[..., None])
    run_ba = None
    if cfg.ba.enabled and kf_mode != "never":
        kf_count = _count(kf_flags)
        run_ba = is_kf & (kf_count >= cfg.ba.window) & (kf_count % cfg.ba.interval == 0)
    return is_kf, kf_flags, run_ba


def _read_key(flags: torch.Tensor) -> tuple:
    """A step's one host read: (n,) bool flags -> n Python bools, in one
    device-to-host copy."""
    return tuple(flags.tolist())


def _host_key(is_kf: torch.Tensor, run_ba, kf_mode: str) -> tuple[bool, bool]:
    """(any stream keyframes, any stream runs the window BA): one read
    where either depends on data, none where both are fixed by kf_mode."""
    if kf_mode != "dynamic" and run_ba is None:
        return kf_mode == "always", False
    flags = [is_kf.any()] if run_ba is None else [is_kf.any(), run_ba.any()]
    got = _read_key(torch.stack(flags))
    return got[0], len(got) > 1 and got[1]


def step_key(state: VoState, cfg: Config, kf_mode: str = "dynamic") -> tuple[bool, bool]:
    """The branch key of the step from `state`, as host values: (any
    stream keyframes, any stream runs the window BA)."""
    is_kf, _, run_ba = _branch_key(state, cfg, kf_mode)
    return _host_key(is_kf, run_ba, kf_mode)


def _ba_schedule(state: VoState, cfg: Config, chunk: int, cadence: int) -> tuple:
    """Whether any stream runs the window BA at each keyframe step of a
    cadenced chunk from `state`: _branch_key frame by frame on the keyframe
    flags alone (a cadenced step's keyframe decision needs nothing else),
    in one host read."""
    due = []
    for i in range(chunk):
        _, kf_flags, run_ba = _branch_key(state, cfg, "always" if i % cadence == 0 else "never")
        if run_ba is not None:
            due.append(run_ba.any())
        state = state._replace(frame_id=state.frame_id + 1, kf_flags=kf_flags)
    return _read_key(torch.stack(due))


# --------------------------------------------------------------------------
# per-frame step
# --------------------------------------------------------------------------

def step_body(
    state: VoState,
    left: torch.Tensor,
    right: torch.Tensor,
    camera: Camera,
    cfg: Config,
    kf_mode: str = "dynamic",
    pnp_noise: torch.Tensor | None = None,
    lk_engine: str = "patches",
    branch: tuple[bool, bool] | None = None,
) -> VoState:
    """One full frame step: track -> PnP -> replenish -> window BA.

    kf_mode: "dynamic" (the reference's data-dependent keyframe rule plus
    the max-interval trigger), "never" (track only) or "always"
    (unconditional replenish). The step splits state.rng and draws the PnP
    sampling noise ((num_hypotheses, N) Gumbel) from it; `pnp_noise`, if
    given, is used in its place (the key is split all the same).
    lk_engine: the KLT engine of all three tracker calls, "patches" or
    "fused" (ops/klt.py). branch: the step's key from this state
    (step_key), which a caller that has read it hands in; without it the
    step reads it itself, once, where it depends on data.

    With a batched state (every leaf with a leading (S,)) and images
    (S, H, W) it steps S streams at once: the keys are (S, 2), the noise
    (S, hypotheses, N), drawn in one call. Under "dynamic" every stream
    keeps its own keyframe decision: replenishment is computed for all
    streams and selected per stream, as jax.vmap of svo_tpu's lax.cond; it
    is skipped when no stream keyframes."""
    if kf_mode not in ("dynamic", "never", "always"):
        raise ValueError(f"kf_mode {kf_mode!r}")
    dev = left.device
    fid = state.frame_id + 1
    eye4 = torch.eye(4, dtype=torch.float32, device=dev)

    # keyframe policy and the BA rule, evaluated on the PREVIOUS frame's
    # state; the branches' host values read once (svo_tpu's lax.conds)
    is_kf, kf_flags, run_ba = _branch_key(state, cfg, kf_mode)
    kf_any, ba_any = branch if branch is not None else _host_key(is_kf, run_ba, kf_mode)
    last_kf_id = torch.where(is_kf, fid, state.last_kf_id)

    pyr_l = KltTracker.build_pyramid(left, cfg.temporal_klt.max_level)

    # --- temporal tracking (anchored or chained, see TrackingParams) ---
    anchored = cfg.tracking.anchored_klt
    track_src = state.features.anchor if anchored else state.features.pos
    base_flow = state.features.pos - state.features.anchor if anchored else None

    if cfg.motion_prior:
        prior_ok = state.prior_ok
        rel = torch.where(prior_ok[..., None, None], state.rel_motion, eye4)
        T_wc_pred = se3.compose(rel, state.pose)
        if cfg.flow_seeding:
            T_cw_pred = se3.inverse(T_wc_pred)
            M = state.map.points.shape[-2]
            Xw_prior = take_rows(state.map.points, state.features.point_id.clamp(0, M - 1))
            uv_pred = camera_project(camera.K, se3.transform(T_cw_pred, Xw_prior))
            delta = uv_pred - state.features.pos
            flow_ok = (
                state.features.valid
                & prior_ok[..., None]
                & torch.all(torch.isfinite(delta), dim=-1)
                & (torch.sum(delta * delta, dim=-1) < 200.0**2)
            )
            seeded = uv_pred - track_src
            fallback = base_flow if base_flow is not None else torch.zeros_like(seeded)
            init_flow = torch.where(flow_ok[..., None], seeded, fallback)
        else:
            init_flow = base_flow
    else:
        T_wc_pred = state.pose
        init_flow = base_flow

    tres = KltTracker.track(
        state.prev_pyramid, pyr_l, track_src, state.features.valid,
        cfg.temporal_klt, init_flow=init_flow, engine=lk_engine,
    )
    t_status = state.features.valid & tres.status
    if cfg.tracking.fb_check:
        # forward-backward check: level 0, 8 iterations, from an exact seed
        fb_params = dataclasses.replace(cfg.temporal_klt, max_level=0, max_iters=8)
        bres = KltTracker.track(
            pyr_l, state.prev_pyramid, tres.pos, t_status,
            fb_params, init_flow=track_src - tres.pos, engine=lk_engine,
        )
        fb_err2 = torch.sum((bres.pos - track_src) ** 2, dim=-1)
        t_status = t_status & bres.status & (fb_err2 < cfg.tracking.fb_threshold ** 2)
    tracked = FeatureSet(
        pos=tres.pos,
        valid=t_status,
        point_id=state.features.point_id,
        age=state.features.age + 1,
        anchor=state.features.anchor,
    )
    n_tracked = tracked.count()

    # --- pose: LO-RANSAC PnP with the previous pose as an extra start ---
    M = state.map.points.shape[-2]
    Xw = take_rows(state.map.points, tracked.point_id.clamp(0, M - 1))
    rng, noise = split_gumbel(state.rng, (cfg.ransac.num_hypotheses, Xw.shape[-2]))
    if pnp_noise is not None:
        noise = pnp_noise
    pres = ransac_pnp(
        camera.K, Xw, tracked.pos, tracked.valid, noise, cfg.ransac,
        T_init=se3.inverse(state.pose),
    )
    pnp_ok = pres.ok
    if cfg.tracking.max_step_rot_deg > 0:
        # motion-sanity gate: a WEAK consensus must agree with the
        # constant-velocity prediction (no impossible rotation, no false
        # zero-motion lock); strong support is always accepted
        rel_step = se3.compose(pres.T_wc, se3.inverse(state.pose))
        rel_pred = torch.where(state.prior_ok[..., None, None], state.rel_motion, eye4)
        cos_a = torch.clamp(
            (rel_step[..., 0, 0] + rel_step[..., 1, 1] + rel_step[..., 2, 2] - 1.0) * 0.5,
            -1.0, 1.0,
        )
        step_deg = torch.rad2deg(torch.arccos(cos_a))
        not_locked = torch.linalg.norm(rel_step[..., :3, 3], dim=-1) >= 0.3 * torch.linalg.norm(
            rel_pred[..., :3, 3], dim=-1
        )
        strong = (_count(pres.inliers) >= cfg.tracking.sane_min_inliers) & (
            pres.inlier_ratio >= 0.5
        )
        sane = (step_deg <= cfg.tracking.max_step_rot_deg) & not_locked
        pnp_ok = pnp_ok & (sane | strong)
    pose = torch.where(pnp_ok[..., None, None], pres.T_wc, T_wc_pred)
    # never let a non-finite pose poison the recursive state
    pose = torch.where(_all_finite(pose), pose, state.pose)
    rel_motion = se3.compose(pose, se3.inverse(state.pose))
    rel_motion = torch.where(_all_finite(rel_motion), rel_motion, eye4)
    pnp_healthy = pnp_ok & (pres.inlier_ratio > 0.5)

    # purge features whose map point went stale under the new pose (behind
    # the camera / out of view) or whose track is too old; the inlier purge
    # applies only from an ACCEPTED solve
    Xc_now = se3.transform(se3.inverse(pose), Xw)
    uv_now = camera_project(camera.K, Xc_now)
    Hh, Ww = cfg.image_height, cfg.image_width
    geom_ok = (
        (Xc_now[..., 2] > 0.5)
        & (uv_now[..., 0] >= -20)
        & (uv_now[..., 0] < Ww + 20)
        & (uv_now[..., 1] >= -20)
        & (uv_now[..., 1] < Hh + 20)
    )
    if cfg.tracking.max_track_age > 0:
        geom_ok = geom_ok & (tracked.age < cfg.tracking.max_track_age)
    inl_keep = torch.where(pnp_ok[..., None], pres.inliers, tracked.valid)
    feats = tracked._replace(valid=tracked.valid & inl_keep & geom_ok)

    mp = _record_obs(state.map, feats.pos, feats.point_id, feats.valid, fid)

    # --- keyframe replenishment ---
    if kf_mode == "always":
        feats, mp = _replenish(
            feats, mp, left, pyr_l, right, pose, fid, camera, cfg, lk_engine
        )
    elif kf_mode == "dynamic" and kf_any:
        # streams that do not keyframe keep what they had
        new_feats, new_mp = _replenish(
            feats, mp, left, pyr_l, right, pose, fid, camera, cfg, lk_engine
        )
        feats = FeatureSet(*(_select(is_kf, a, b) for a, b in zip(new_feats, feats)))
        mp = MapState(*(_select(is_kf, a, b) for a, b in zip(new_mp, mp)))

    poses = scatter_drop(state.poses, fid[..., None], pose[..., None, :, :])

    # --- sliding-window bundle adjustment over the last cfg.ba.window
    #     KEYFRAMES, every cfg.ba.interval keyframes; track-only steps carry
    #     no BA code at all ---
    if run_ba is not None and ba_any:
        points_ba, poses_ba = _window_ba(mp, poses, kf_flags, fid, camera, cfg)
        mp = mp._replace(points=_select(run_ba, points_ba, mp.points))
        poses = _select(run_ba, poses_ba, poses)
        pose = take_rows(poses, fid[..., None])[..., 0, :, :]
    metrics_row = torch.stack(
        [
            n_tracked.to(torch.float32),
            pres.inlier_ratio,
            feats.count().to(torch.float32),
            is_kf.to(torch.float32),
            mp.n_points.to(torch.float32),
        ],
        dim=-1,
    )
    # anchored mode keeps the KEYFRAME pyramid as the template source;
    # chained mode carries the current frame's pyramid
    if not anchored or kf_mode == "always":
        out_pyr = pyr_l
    elif kf_mode == "never":
        out_pyr = state.prev_pyramid
    elif kf_any:
        levels, grads = pyr_l
        old_levels, old_grads = state.prev_pyramid
        out_pyr = (
            tuple(_select(is_kf, a, b) for a, b in zip(levels, old_levels)),
            tuple(
                (_select(is_kf, ax, bx), _select(is_kf, ay, by))
                for (ax, ay), (bx, by) in zip(grads, old_grads)
            ),
        )
    else:
        out_pyr = state.prev_pyramid
    return VoState(
        features=feats,
        map=mp,
        prev_pyramid=out_pyr,
        frame_id=fid,
        prev_is_kf=is_kf,
        last_kf_id=last_kf_id,
        pose=pose,
        rel_motion=rel_motion,
        prior_ok=pnp_healthy,
        poses=poses,
        kf_flags=kf_flags,
        metrics=scatter_drop(state.metrics, fid[..., None], metrics_row[..., None, :]),
        rng=rng,
    )


def _check_frames(state: VoState, left, right, lead_axes: int) -> None:
    """Frames must be ([K,] H, W) for one stream, ([K,] S, H, W) for a
    batched state of S streams (lead_axes: 1 with the chunk axis K)."""
    lead = tuple(state.frame_id.shape)  # () for one stream, (S,) batched
    k = "K, " if lead_axes else ""
    names = ("lefts_u8", "rights_u8") if lead_axes else ("left", "right")
    for name, x in zip(names, (left, right)):
        if x.dim() != 2 + lead_axes + len(lead) or tuple(x.shape[lead_axes:-2]) != lead:
            raise ValueError(
                f"{name}: expected ({k}{'S, ' if lead else ''}H, W) for a state of "
                f"{lead[0] if lead else 'no'} streams, got {tuple(x.shape)}"
            )


def _check_chunk(state: VoState, lefts_u8, rights_u8) -> None:
    _check_frames(state, lefts_u8, rights_u8, 1)


def make_step(camera: Camera, cfg: Config, lk_engine: str = "patches"):
    """Single-frame step with the data-dependent keyframe rule, eager:
    (state, left, right) -> state, frames ([S,] H, W) float32 or uint8
    (converted exactly)."""

    def step(state: VoState, left, right) -> VoState:
        return step_body(state, left.to(torch.float32), right.to(torch.float32), camera, cfg,
                         kf_mode="dynamic", lk_engine=lk_engine)

    return step


def make_cadenced_chunk_step(
    camera: Camera, cfg: Config, chunk: int, cadence: int, lk_engine: str = "patches",
):
    """Multi-frame step with a STATIC keyframe cadence, eager: each group of
    `cadence` frames starts with one unconditional-replenish step
    (kf_mode="always") followed by cadence-1 track-only steps
    (kf_mode="never"). Returns (state, lefts_u8 (K,[S,]H,W), rights_u8) ->
    state. With cfg.ba.enabled the window BA's schedule is read once a
    chunk (_ba_schedule)."""
    if cadence < 1 or chunk % cadence:
        raise ValueError(f"chunk {chunk} must be a positive multiple of cadence {cadence}")

    def run_chunk(state: VoState, lefts_u8, rights_u8) -> VoState:
        _check_chunk(state, lefts_u8, rights_u8)
        schedule = _ba_schedule(state, cfg, chunk, cadence) if cfg.ba.enabled else ()
        for i, (l, r) in enumerate(zip(lefts_u8, rights_u8)):
            kf = i % cadence == 0
            state = step_body(
                state, l.to(torch.float32), r.to(torch.float32), camera, cfg,
                kf_mode="always" if kf else "never", lk_engine=lk_engine,
                branch=(kf, kf and bool(schedule) and schedule[i // cadence]),
            )
        return state

    return run_chunk


def make_bootstrap(camera: Camera, cfg: Config, lk_engine: str = "patches"):
    """Bootstrap: frame 0 is always a keyframe — detect, stereo-match,
    triangulate at the identity pose. Returns (left, right, seed) ->
    VoState, svo_tpu's signature: the state's key is PRNGKey(seed).
    (S, H, W) stacks of first frames with S seeds give the batched state of
    S streams, stream s keyed by seed[s] (svo_tpu's vmapped bootstrap)."""

    def bootstrap(left: torch.Tensor, right: torch.Tensor, seed) -> VoState:
        dev = left.device
        lead = tuple(left.shape[:-2])  # () for one stream, (S,) for a stack
        rng = prng_key(seed, dev)
        if tuple(rng.shape[:-1]) != lead:
            raise ValueError(
                f"seed: expected one seed a stream, shape {lead}, for images "
                f"{tuple(left.shape)}; got {tuple(rng.shape[:-1])}"
            )
        N = cfg.capacity.max_features
        F = cfg.capacity.max_frames
        pyr_l = KltTracker.build_pyramid(left, cfg.temporal_klt.max_level)
        pose0 = se3.identity(device=dev).repeat(lead + (1, 1))
        zero_i = torch.zeros(lead, dtype=torch.int32, device=dev)
        feats, mp = _replenish(
            FeatureSet.empty(N, dev, lead), MapState.empty(cfg, dev, lead),
            left, pyr_l, right, pose0, zero_i, camera, cfg, lk_engine,
        )
        zero = torch.zeros(lead, dtype=torch.float32, device=dev)
        row0 = torch.stack(
            [zero, zero, feats.count().to(torch.float32), zero + 1.0,
             mp.n_points.to(torch.float32)],
            dim=-1,
        )
        rest = torch.zeros(lead + (F - 1, 5), dtype=torch.float32, device=dev)
        kf_flags = torch.zeros(lead + (F,), dtype=torch.bool, device=dev)
        kf_flags[..., 0] = True
        return VoState(
            features=feats,
            map=mp,
            prev_pyramid=pyr_l,
            frame_id=zero_i,
            prev_is_kf=torch.ones(lead, dtype=torch.bool, device=dev),
            last_kf_id=zero_i,
            pose=pose0,
            rel_motion=pose0.clone(),
            prior_ok=torch.zeros(lead, dtype=torch.bool, device=dev),
            poses=pose0[..., None, :, :].repeat((1,) * len(lead) + (F, 1, 1)),
            kf_flags=kf_flags,
            metrics=torch.cat([row0[..., None, :], rest], dim=-2),
            rng=rng,
        )

    return bootstrap
