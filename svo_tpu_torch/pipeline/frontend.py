"""The per-frame VO front-end.

Port of svo_tpu/pipeline/frontend.py: one step per frame,

    track (KLT prev->curr, forward-backward check)
    -> pose (RANSAC-PnP, motion gate, purge)
    -> keyframe? replenish: detect, stereo KLT, triangulate, allocate, merge

as functions of (state, images) -> state. svo_tpu's lax.scan over a chunk
is a Python loop over frames here. The cadenced chunk step makes no host
round trip per frame: every data-dependent choice is a torch.where, as in
svo_tpu. Only kf_mode="dynamic" branches on the host, once per frame.

Scatters follow jax's mode="drop": rows whose index is out of range are
written to a spare row that is then cut off (_scatter_drop), never raised
on and never read back.

The in-pipeline window BA (cfg.ba.enabled) is not ported yet (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses

import torch

from svo_tpu_torch.config import Config
from svo_tpu_torch.geometry import se3
from svo_tpu_torch.geometry.camera import Camera, project as camera_project
from svo_tpu_torch.geometry.pnp import gumbel_noise, ransac_pnp
from svo_tpu_torch.geometry.triangulate import triangulate_dlt, triangulate_rectified
from svo_tpu_torch.ops import detect as detect_mod
from svo_tpu_torch.ops.klt import KltTracker
from svo_tpu_torch.pipeline.state import FeatureSet, MapState, VoState


def _check_cfg(cfg: Config) -> None:
    if cfg.ba.enabled:
        raise NotImplementedError(
            "cfg.ba.enabled: the in-pipeline window BA is not ported yet "
            "(ROADMAP item A12)"
        )


def _scatter_drop(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """dst with dst[idx[i]] = src[i] (a new tensor); rows whose idx lies
    outside [0, len(dst)) are dropped, as jax's .at[].set(mode="drop")."""
    n = dst.shape[0]
    ok = (idx >= 0) & (idx < n)
    out = torch.cat([dst, dst[:1]])  # the spare last row takes dropped rows
    out.index_put_((torch.where(ok, idx, n).long(),), src)
    return out[:n]


def _count(mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(mask.to(torch.int32), dtype=torch.int32)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _alloc_points(
    mp: MapState, Xw: torch.Tensor, valid: torch.Tensor
) -> tuple[torch.Tensor, MapState]:
    """Allocate map-point slots for valid rows of Xw (monotone cursor).
    Returns per-row point ids (-1 where invalid or the table is full)."""
    M = mp.points.shape[0]
    v = valid.to(torch.int32)
    offsets = torch.cumsum(v, 0, dtype=torch.int32) - v  # rank among valid rows
    ids = torch.where(valid, mp.n_points + offsets, -1)
    ids = torch.where(ids < M, ids, -1)  # capacity guard
    points = _scatter_drop(mp.points, ids, Xw)
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
    O = mp.obs_u.shape[0]
    v = valid.to(torch.int32)
    offs = torch.cumsum(v, 0, dtype=torch.int32) - v
    slots = torch.where(valid, (mp.obs_cursor + offs) % O, O)  # O -> dropped
    if u_right is None:
        u_right = torch.full(pid.shape, -1.0, dtype=torch.float32, device=pid.device)
    return mp._replace(
        obs_u=_scatter_drop(mp.obs_u, slots, uv[:, 0]),
        obs_v=_scatter_drop(mp.obs_v, slots, uv[:, 1]),
        obs_ur=_scatter_drop(mp.obs_ur, slots, u_right),
        obs_pid=_scatter_drop(mp.obs_pid, slots, pid),
        obs_fid=_scatter_drop(mp.obs_fid, slots, frame_id.expand(pid.shape)),
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
    N = feats.pos.shape[0]
    key_tracked = torch.where(feats.valid, 2e9 + feats.age.to(torch.float32), -1.0)
    key_new = torch.where(new_valid, torch.clamp(new_score, min=0.0), -1.0)
    keys = torch.cat([key_tracked, key_new])
    idx = torch.sort(keys, descending=True, stable=True)[1][:N]
    return FeatureSet(
        pos=torch.cat([feats.pos, new_pos])[idx],
        valid=keys[idx] >= 0.0,
        point_id=torch.cat([feats.point_id, new_pid])[idx],
        age=torch.cat([feats.age, torch.zeros_like(new_pid)])[idx],
        anchor=torch.cat([feats.anchor, new_pos])[idx],
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
    y_ok = torch.abs(sres.pos[:, 1] - det_pos[:, 1]) < cfg.tracking.y_threshold
    s_valid = det_valid & sres.status & y_ok

    # 3. triangulate, cheirality z > 0, depth cap, to world via the pose
    if cfg.triangulator == "rectified":
        Xc = triangulate_rectified(camera.fx, camera.baseline, det_pos, sres.pos, camera.K)
    else:
        Xc = triangulate_dlt(camera.P_left, camera.P_right, det_pos, sres.pos)
    new_valid = s_valid & (Xc[:, 2] > 0)
    if cfg.tracking.max_depth_baselines > 0:
        new_valid = new_valid & (Xc[:, 2] < cfg.tracking.max_depth_baselines * camera.baseline)
    Xw = se3.transform(pose, Xc)

    # 4. allocate map points + record the triangulating (stereo) observation
    ids, mp = _alloc_points(mp, Xw, new_valid)
    new_valid = new_valid & (ids >= 0)
    u_right = torch.where(sres.status, sres.pos[:, 0], -1.0)
    mp = _record_obs(mp, det_pos, ids, new_valid, frame_id, u_right=u_right)

    # 5. merge: survivors re-anchor at this keyframe; new detections compete
    #    by selection order (spatially spread), not by raw score
    feats = feats._replace(anchor=feats.pos)
    D = det_pos.shape[0]
    det_prio = torch.arange(D, 0, -1, dtype=torch.float32, device=det_pos.device)
    return _merge_features(feats, det_pos, ids, det_prio, new_valid), mp


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
    generator: torch.Generator | None = None,
    pnp_noise: torch.Tensor | None = None,
    lk_engine: str = "patches",
) -> VoState:
    """One full frame step: track -> PnP -> replenish.

    kf_mode: "dynamic" (the reference's data-dependent keyframe rule plus
    the max-interval trigger), "never" (track only) or "always"
    (unconditional replenish). The PnP sampling noise is `pnp_noise`
    ((num_hypotheses, N) Gumbel) if given, else drawn from `generator`.
    lk_engine: the KLT engine of all three tracker calls, "patches" or
    "fused" (ops/klt.py)."""
    if kf_mode not in ("dynamic", "never", "always"):
        raise ValueError(f"kf_mode {kf_mode!r}")
    _check_cfg(cfg)
    dev = left.device
    fid = state.frame_id + 1
    eye4 = torch.eye(4, dtype=torch.float32, device=dev)

    # keyframe policy, evaluated on the PREVIOUS frame's state
    if kf_mode == "dynamic":
        is_kf = (~state.prev_is_kf) & (state.features.count() < cfg.tracking.features_to_track)
        if cfg.tracking.kf_max_interval > 0:
            is_kf = is_kf | (
                (~state.prev_is_kf)
                & (fid - state.last_kf_id >= cfg.tracking.kf_max_interval)
            )
    else:
        is_kf = torch.full((), kf_mode == "always", dtype=torch.bool, device=dev)
    last_kf_id = torch.where(is_kf, fid, state.last_kf_id)

    pyr_l = KltTracker.build_pyramid(left, cfg.temporal_klt.max_level)

    # --- temporal tracking (anchored or chained, see TrackingParams) ---
    anchored = cfg.tracking.anchored_klt
    track_src = state.features.anchor if anchored else state.features.pos
    base_flow = state.features.pos - state.features.anchor if anchored else None

    if cfg.motion_prior:
        prior_ok = state.prior_ok
        rel = torch.where(prior_ok, state.rel_motion, eye4)
        T_wc_pred = se3.compose(rel, state.pose)
        if cfg.flow_seeding:
            T_cw_pred = se3.inverse(T_wc_pred)
            M = state.map.points.shape[0]
            Xw_prior = state.map.points[state.features.point_id.clamp(0, M - 1).long()]
            uv_pred = camera_project(camera.K, se3.transform(T_cw_pred, Xw_prior))
            delta = uv_pred - state.features.pos
            flow_ok = (
                state.features.valid
                & prior_ok
                & torch.all(torch.isfinite(delta), dim=-1)
                & (torch.sum(delta * delta, dim=-1) < 200.0**2)
            )
            seeded = uv_pred - track_src
            fallback = base_flow if base_flow is not None else torch.zeros_like(seeded)
            init_flow = torch.where(flow_ok[:, None], seeded, fallback)
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
    M = state.map.points.shape[0]
    Xw = state.map.points[tracked.point_id.clamp(0, M - 1).long()]
    if pnp_noise is None:
        if generator is None:
            raise ValueError("step_body needs a generator or pnp_noise")
        pnp_noise = gumbel_noise((cfg.ransac.num_hypotheses, Xw.shape[0]), generator, dev)
    pres = ransac_pnp(
        camera.K, Xw, tracked.pos, tracked.valid, pnp_noise, cfg.ransac,
        T_init=se3.inverse(state.pose),
    )
    pnp_ok = pres.ok
    if cfg.tracking.max_step_rot_deg > 0:
        # motion-sanity gate: a WEAK consensus must agree with the
        # constant-velocity prediction (no impossible rotation, no false
        # zero-motion lock); strong support is always accepted
        rel_step = se3.compose(pres.T_wc, se3.inverse(state.pose))
        rel_pred = torch.where(state.prior_ok, state.rel_motion, eye4)
        cos_a = torch.clamp(
            (rel_step[0, 0] + rel_step[1, 1] + rel_step[2, 2] - 1.0) * 0.5, -1.0, 1.0
        )
        step_deg = torch.rad2deg(torch.arccos(cos_a))
        not_locked = torch.linalg.norm(rel_step[:3, 3]) >= 0.3 * torch.linalg.norm(
            rel_pred[:3, 3]
        )
        strong = (_count(pres.inliers) >= cfg.tracking.sane_min_inliers) & (
            pres.inlier_ratio >= 0.5
        )
        sane = (step_deg <= cfg.tracking.max_step_rot_deg) & not_locked
        pnp_ok = pnp_ok & (sane | strong)
    pose = torch.where(pnp_ok, pres.T_wc, T_wc_pred)
    # never let a non-finite pose poison the recursive state
    pose = torch.where(torch.all(torch.isfinite(pose)), pose, state.pose)
    rel_motion = se3.compose(pose, se3.inverse(state.pose))
    rel_motion = torch.where(torch.all(torch.isfinite(rel_motion)), rel_motion, eye4)
    pnp_healthy = pnp_ok & (pres.inlier_ratio > 0.5)

    # purge features whose map point went stale under the new pose (behind
    # the camera / out of view) or whose track is too old; the inlier purge
    # applies only from an ACCEPTED solve
    Xc_now = se3.transform(se3.inverse(pose), Xw)
    uv_now = camera_project(camera.K, Xc_now)
    Hh, Ww = cfg.image_height, cfg.image_width
    geom_ok = (
        (Xc_now[:, 2] > 0.5)
        & (uv_now[:, 0] >= -20)
        & (uv_now[:, 0] < Ww + 20)
        & (uv_now[:, 1] >= -20)
        & (uv_now[:, 1] < Hh + 20)
    )
    if cfg.tracking.max_track_age > 0:
        geom_ok = geom_ok & (tracked.age < cfg.tracking.max_track_age)
    inl_keep = torch.where(pnp_ok, pres.inliers, tracked.valid)
    feats = tracked._replace(valid=tracked.valid & inl_keep & geom_ok)

    mp = _record_obs(state.map, feats.pos, feats.point_id, feats.valid, fid)

    # --- keyframe replenishment ---
    if kf_mode == "always":
        feats, mp = _replenish(
            feats, mp, left, pyr_l, right, pose, fid, camera, cfg, lk_engine
        )
    elif kf_mode == "dynamic":
        # The one host round trip per frame, and only in this mode (svo_tpu
        # takes a lax.cond on device here); the cadenced chunk step never
        # comes here.
        kf_on_host = bool(is_kf)
        if kf_on_host:
            feats, mp = _replenish(
                feats, mp, left, pyr_l, right, pose, fid, camera, cfg, lk_engine
            )

    poses = _scatter_drop(state.poses, fid.reshape(1), pose[None])
    kf_flags = _scatter_drop(state.kf_flags, fid.reshape(1), is_kf.reshape(1))
    metrics_row = torch.stack(
        [
            n_tracked.to(torch.float32),
            pres.inlier_ratio,
            feats.count().to(torch.float32),
            is_kf.to(torch.float32),
            mp.n_points.to(torch.float32),
        ]
    )
    # anchored mode keeps the KEYFRAME pyramid as the template source;
    # chained mode carries the current frame's pyramid
    if not anchored or kf_mode == "always":
        out_pyr = pyr_l
    elif kf_mode == "never":
        out_pyr = state.prev_pyramid
    else:
        out_pyr = pyr_l if kf_on_host else state.prev_pyramid
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
        metrics=_scatter_drop(state.metrics, fid.reshape(1), metrics_row[None]),
    )


def make_cadenced_chunk_step(
    camera: Camera, cfg: Config, chunk: int, cadence: int, lk_engine: str = "patches"
):
    """Multi-frame step with a STATIC keyframe cadence: each group of
    `cadence` frames starts with one unconditional-replenish step
    (kf_mode="always") followed by cadence-1 track-only steps
    (kf_mode="never"), so no step branches on data.

    Returns (state, lefts_u8 (K,H,W), rights_u8, generator) -> state;
    `chunk` must be a multiple of `cadence`."""
    if cadence < 1 or chunk % cadence:
        raise ValueError(f"chunk {chunk} must be a positive multiple of cadence {cadence}")
    _check_cfg(cfg)

    def run_chunk(state: VoState, lefts_u8, rights_u8, generator) -> VoState:
        for i, (l, r) in enumerate(zip(lefts_u8, rights_u8)):
            state = step_body(
                state, l.to(torch.float32), r.to(torch.float32), camera, cfg,
                kf_mode="always" if i % cadence == 0 else "never",
                generator=generator, lk_engine=lk_engine,
            )
        return state

    return run_chunk


def make_bootstrap(camera: Camera, cfg: Config, lk_engine: str = "patches"):
    """Bootstrap: frame 0 is always a keyframe — detect, stereo-match,
    triangulate at the identity pose. Returns (left, right) -> VoState."""
    _check_cfg(cfg)

    def bootstrap(left: torch.Tensor, right: torch.Tensor) -> VoState:
        dev = left.device
        N = cfg.capacity.max_features
        F = cfg.capacity.max_frames
        pyr_l = KltTracker.build_pyramid(left, cfg.temporal_klt.max_level)
        pose0 = se3.identity(device=dev)
        zero_i = torch.zeros((), dtype=torch.int32, device=dev)
        feats, mp = _replenish(
            FeatureSet.empty(N, dev), MapState.empty(cfg, dev),
            left, pyr_l, right, pose0, zero_i, camera, cfg, lk_engine,
        )
        metrics0 = torch.zeros((F, 5), dtype=torch.float32, device=dev)
        metrics0[0, 2] = feats.count().to(torch.float32)
        metrics0[0, 3] = 1.0
        metrics0[0, 4] = mp.n_points.to(torch.float32)
        kf_flags = torch.zeros((F,), dtype=torch.bool, device=dev)
        kf_flags[0] = True
        return VoState(
            features=feats,
            map=mp,
            prev_pyramid=pyr_l,
            frame_id=zero_i,
            prev_is_kf=torch.ones((), dtype=torch.bool, device=dev),
            last_kf_id=zero_i,
            pose=pose0,
            rel_motion=torch.eye(4, dtype=torch.float32, device=dev),
            prior_ok=torch.zeros((), dtype=torch.bool, device=dev),
            poses=torch.eye(4, dtype=torch.float32, device=dev).repeat(F, 1, 1),
            kf_flags=kf_flags,
            metrics=metrics0,
        )

    return bootstrap
