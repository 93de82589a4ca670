"""Sliding-window problem extraction from the live map state, and write-back.

Port of svo_tpu/ba/window.py. Builds a fixed-shape BAProblem from the
observation ring (MapState.obs_*):

- observation rows are selected by frame id (the ring's overwrite semantics
  make old rows drop out by themselves),
- global point ids are remapped to dense window slots with a stable sort and
  a first-occurrence cumsum,
- after solve_ba, updated points scatter back into the global map and
  updated poses into the trajectory.

All capacities are static and all variable counts are masks. Every function
takes the state with any leading axes (streams, blocks), shared by all its
tensor arguments: frame_hi then has exactly those axes. The scatters here
write in-range indices that never repeat (row_slot, order, the first
occurrences, a window's point ids), so ops/index.scatter_drop serves them;
the per-slot observation counts are integer sums, exact in any order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svo_tpu_torch.ba.solver import BAProblem
from svo_tpu_torch.geometry import se3
from svo_tpu_torch.ops.index import scatter_drop, take_rows
from svo_tpu_torch.ops.select import _topk_stable
from svo_tpu_torch.pipeline.state import MapState, tensor

_BIG = 2**30


class WindowMapping(NamedTuple):
    slot_to_pid: torch.Tensor  # (P,) global point id per window slot (-1 empty)
    frame_lo: torch.Tensor     # first frame id in the window

    @staticmethod
    def from_numpy(tree, device=None) -> "WindowMapping":
        return WindowMapping(*(tensor(getattr(tree, f), device) for f in WindowMapping._fields))


class KfWindowMapping(NamedTuple):
    slot_to_pid: torch.Tensor  # (P,) global point id per window slot (-1 empty)
    cam_fids: torch.Tensor     # (K,) frame id of each camera slot (-1 empty),
    #                            ascending with the padding slots FIRST

    @staticmethod
    def from_numpy(tree, device=None) -> "KfWindowMapping":
        return KfWindowMapping(*(tensor(getattr(tree, f), device) for f in KfWindowMapping._fields))


def _full(like: torch.Tensor, n: int, value, dtype) -> torch.Tensor:
    return torch.full(like.shape[:-1] + (n,), value, dtype=dtype, device=like.device)


def _compact_and_remap(mp: MapState, sel, row_cam, n_points: int, n_obs: int):
    """Shared core of the window extractors: compact the selected ring rows
    into n_obs slots, remap global point ids to dense window slots, gate
    under-constrained points, and gather their world positions.

    sel: (..., O_ring) bool, ring rows that belong to the window; row_cam:
    (..., O_ring) i32, camera slot of each ring row (read only where sel).
    Returns (obs_cam, obs_pnt, obs_uv, obs_ok, slot_to_pid, pnt_valid, points)."""
    i32, f32 = torch.int32, torch.float32
    # --- compact selected rows into n_obs slots ---
    sel_i = sel.to(i32)
    rank = torch.cumsum(sel_i, -1, dtype=i32) - sel_i
    row_slot = torch.where(sel & (rank < n_obs), rank, n_obs)  # n_obs -> dropped

    obs_cam = scatter_drop(_full(sel, n_obs, -1, i32), row_slot, row_cam)
    obs_pid_g = scatter_drop(_full(sel, n_obs, -1, i32), row_slot, mp.obs_pid)
    obs_uv = torch.stack(
        [
            scatter_drop(_full(sel, n_obs, 0.0, f32), row_slot, mp.obs_u),
            scatter_drop(_full(sel, n_obs, 0.0, f32), row_slot, mp.obs_v),
            scatter_drop(_full(sel, n_obs, -1.0, f32), row_slot, mp.obs_ur),
        ],
        dim=-1,
    )
    obs_ok = obs_cam >= 0

    # --- remap global pids to dense window slots (sorted first occurrence) ---
    pids_for_sort = torch.where(obs_ok, obs_pid_g, _BIG)
    sorted_pids, order = torch.sort(pids_for_sort, dim=-1, stable=True)
    prev = torch.cat([_full(sel, 1, -2, i32), sorted_pids[..., :-1]], dim=-1)
    first = (sorted_pids != prev) & (sorted_pids < _BIG)
    slot_sorted = torch.cumsum(first.to(i32), -1, dtype=i32) - 1  # slot of each sorted row
    slot_sorted = torch.where(sorted_pids < _BIG, slot_sorted, n_points)

    # back to the original observation order (order is a permutation)
    obs_pnt = torch.zeros_like(obs_cam).scatter_(-1, order, slot_sorted.clamp(max=n_points))
    obs_ok = obs_ok & (obs_pnt < n_points)

    # window slot -> global pid table
    slot_to_pid = scatter_drop(
        _full(sel, n_points, -1, i32), torch.where(first, slot_sorted, n_points), sorted_pids
    )

    # --- gather window points ---
    # A point needs >= 2 observations in the window (or one stereo row, which
    # constrains depth by itself) to be well-posed; under-constrained points
    # would absorb damped-but-arbitrary updates and corrupt the global map on
    # write-back.
    slot_idx = obs_pnt.clamp(max=n_points).long()
    obs_per_slot = _full(sel, n_points + 1, 0, i32).scatter_add_(-1, slot_idx, obs_ok.to(i32))
    stereo_per_slot = _full(sel, n_points + 1, 0, i32).scatter_add_(
        -1, slot_idx, (obs_ok & (obs_uv[..., 2] >= 0)).to(i32)
    )
    constrained = (obs_per_slot[..., :n_points] >= 2) | (stereo_per_slot[..., :n_points] >= 1)
    pnt_valid = (slot_to_pid >= 0) & constrained
    points = take_rows(mp.points, slot_to_pid.clamp(min=0)) * pnt_valid[..., None]
    return obs_cam, obs_pnt, obs_uv, obs_ok, slot_to_pid, pnt_valid, points


def _problem(T_wc, cam_valid, points, pnt_valid, obs_cam, obs_pnt, obs_uv, obs_ok) -> BAProblem:
    return BAProblem(
        T_cw=se3.inverse(T_wc),
        cam_valid=cam_valid,
        points=points,
        pnt_valid=pnt_valid,
        obs_cam=obs_cam.clamp(0, cam_valid.shape[-1] - 1),
        obs_pnt=obs_pnt.clamp(0, pnt_valid.shape[-1] - 1),
        obs_uv=obs_uv,
        obs_valid=obs_ok,
    )


def extract_window(
    mp: MapState,
    poses_wc: torch.Tensor,
    frame_hi: torch.Tensor,
    n_cams: int,
    n_points: int,
    n_obs: int,
) -> tuple[BAProblem, WindowMapping]:
    """Build the BA problem for the FRAME window ending at frame_hi
    (inclusive): cameras are the n_cams consecutive frames up to frame_hi."""
    frame_lo = torch.clamp(frame_hi - (n_cams - 1), min=0)
    lo, hi = frame_lo[..., None], frame_hi[..., None]
    sel = (mp.obs_fid >= lo) & (mp.obs_fid <= hi) & (mp.obs_pid >= 0)
    row_cam = torch.clamp(mp.obs_fid - lo, 0, n_cams - 1)

    obs_cam, obs_pnt, obs_uv, obs_ok, slot_to_pid, pnt_valid, points = _compact_and_remap(
        mp, sel, row_cam, n_points, n_obs
    )

    cam_ids = lo + torch.arange(n_cams, dtype=torch.int32, device=lo.device)
    T_wc = take_rows(poses_wc, cam_ids.clamp(0, poses_wc.shape[-3] - 1))
    problem = _problem(T_wc, cam_ids <= hi, points, pnt_valid, obs_cam, obs_pnt, obs_uv, obs_ok)
    return problem, WindowMapping(slot_to_pid=slot_to_pid, frame_lo=frame_lo)


def extract_kf_window(
    mp: MapState,
    poses_wc: torch.Tensor,
    kf_flags: torch.Tensor,
    frame_hi: torch.Tensor,
    n_cams: int,
    n_points: int,
    n_obs: int,
) -> tuple[BAProblem, KfWindowMapping]:
    """Build the BA problem over the last n_cams KEYFRAMES at or before
    frame_hi. Only observations made AT those keyframes enter; with a
    keyframe cadence of c the window spans ~n_cams*c frames of trajectory
    for the same problem size as an n_cams frame window."""
    i32 = torch.int32
    F = kf_flags.shape[-1]
    fr = torch.arange(F, dtype=i32, device=kf_flags.device)
    is_kf = kf_flags & (fr <= frame_hi[..., None])
    kf_i = is_kf.to(i32)
    total = torch.sum(kf_i, dim=-1, keepdim=True, dtype=i32)
    in_win = is_kf & (torch.cumsum(kf_i, -1, dtype=i32) > total - n_cams)

    # camera slots ascending by frame id, empty (-1) slots first
    desc, _ = _topk_stable(torch.where(in_win, fr, -1), n_cams)
    cam_fids = desc.flip(-1)
    cam_valid = cam_fids >= 0

    # frame id -> camera slot lookup (the spare row F absorbs invalid slots)
    slots = torch.arange(n_cams, dtype=i32, device=fr.device).expand(cam_fids.shape)
    frame_to_cam = scatter_drop(
        _full(kf_flags, F + 1, -1, i32), torch.where(cam_valid, cam_fids, F), slots
    )
    row_cam = torch.gather(frame_to_cam, -1, mp.obs_fid.clamp(0, F).long())
    sel = (mp.obs_fid >= 0) & (row_cam >= 0) & (mp.obs_pid >= 0)

    obs_cam, obs_pnt, obs_uv, obs_ok, slot_to_pid, pnt_valid, points = _compact_and_remap(
        mp, sel, row_cam, n_points, n_obs
    )

    T_wc = take_rows(poses_wc, cam_fids.clamp(0, poses_wc.shape[-3] - 1))
    problem = _problem(T_wc, cam_valid, points, pnt_valid, obs_cam, obs_pnt, obs_uv, obs_ok)
    return problem, KfWindowMapping(slot_to_pid=slot_to_pid, cam_fids=cam_fids)


def _write_points(mp: MapState, slot_to_pid, points_opt, pnt_valid) -> MapState:
    """Optimised window points into the global map; a window's point ids do
    not repeat."""
    pid = torch.where(pnt_valid & (slot_to_pid >= 0), slot_to_pid, -1)
    return mp._replace(points=scatter_drop(mp.points, pid, points_opt))


def write_back(
    mp: MapState,
    poses_wc: torch.Tensor,
    mapping: WindowMapping,
    T_cw_opt: torch.Tensor,
    points_opt: torch.Tensor,
    pnt_valid: torch.Tensor,
    cam_valid: torch.Tensor,
) -> tuple[MapState, torch.Tensor]:
    """Scatter optimised points into the global map and optimised poses into
    the trajectory. Returns (new MapState, new poses)."""
    n_cams = T_cw_opt.shape[-3]
    cam_ids = mapping.frame_lo[..., None] + torch.arange(
        n_cams, dtype=torch.int32, device=T_cw_opt.device
    )
    fidx = torch.where(cam_valid, cam_ids, -1)
    poses = scatter_drop(poses_wc, fidx, se3.inverse(T_cw_opt))
    return _write_points(mp, mapping.slot_to_pid, points_opt, pnt_valid), poses


def write_back_kf(
    mp: MapState,
    poses_wc: torch.Tensor,
    mapping: KfWindowMapping,
    frame_hi: torch.Tensor,
    T_cw_opt: torch.Tensor,
    points_opt: torch.Tensor,
    pnt_valid: torch.Tensor,
    cam_valid: torch.Tensor,
) -> tuple[MapState, torch.Tensor]:
    """Write back a keyframe-window solve: optimised points scatter into the
    global map, keyframe poses land exactly, and every non-keyframe pose in
    [first window keyframe, frame_hi] is carried by the RIGID correction of
    its nearest preceding window keyframe (C_k = T_wc_new[k] inv(T_wc_old[k])):
    the relative pose from that keyframe, which BA did not observe, is
    preserved while the keyframe chain absorbs the drift correction."""
    i32 = torch.int32
    F = poses_wc.shape[-3]
    K = mapping.cam_fids.shape[-1]
    cam_fids = mapping.cam_fids                       # ascending, -1 pads first
    T_wc_new = se3.inverse(T_cw_opt)                  # (K,4,4)
    T_wc_old = take_rows(poses_wc, cam_fids.clamp(0, F - 1))
    corr = se3.compose(T_wc_new, se3.inverse(T_wc_old))

    # nearest preceding window keyframe for every frame index
    fr = torch.arange(F, dtype=i32, device=poses_wc.device).expand(cam_fids.shape[:-1] + (F,))
    k_of = torch.searchsorted(cam_fids.contiguous(), fr.contiguous(), right=True) - 1
    n_pad = torch.sum((~cam_valid).to(i32), dim=-1, keepdim=True, dtype=i32)
    first_fid = torch.gather(cam_fids, -1, n_pad.clamp(0, K - 1).long())
    in_span = (k_of >= n_pad) & (fr >= first_fid) & (fr <= frame_hi[..., None])

    corrected = se3.compose(take_rows(corr, k_of.clamp(0, K - 1)), poses_wc)
    poses = torch.where(in_span[..., None, None], corrected, poses_wc)
    # keyframe poses land exactly (corr @ old == new there up to rounding;
    # set them explicitly so that the anchor does not drift)
    poses = scatter_drop(poses, torch.where(cam_valid, cam_fids, -1), T_wc_new)
    return _write_points(mp, mapping.slot_to_pid, points_opt, pnt_valid), poses
