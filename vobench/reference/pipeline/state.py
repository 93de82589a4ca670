"""Pipeline state: fixed-capacity struct-of-arrays world model.

Port of svo_tpu/pipeline/state.py. FeatureSet is the live feature table,
MapState the preallocated map with its monotone allocation cursor and the
COO observation ring, VoState everything a frame step needs, svo_tpu's
threefry PRNG key (`rng`, ops/random.py) included: a copied state carries
its PnP noise, as svo_tpu's does.

A batched state of S streams (parallel/batched.py) is the same structure
with a leading (S,) on every leaf, as jax.vmap makes svo_tpu's. The key is
int32 (torch's uint32 has few ops), svo_tpu's uint32 bits.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from vobench.reference.config import Config


class FeatureSet(NamedTuple):
    pos: torch.Tensor       # (N, 2) f32 (x, y)
    valid: torch.Tensor     # (N,) bool
    point_id: torch.Tensor  # (N,) i32 map-point index, -1 if none
    age: torch.Tensor       # (N,) i32 frames survived
    anchor: torch.Tensor    # (N, 2) f32 position in the anchor keyframe

    @staticmethod
    def empty(n: int, device=None, lead: tuple = ()) -> "FeatureSet":
        """`lead` is () for one stream, (S,) for a batched state."""
        return FeatureSet(
            pos=torch.zeros(lead + (n, 2), dtype=torch.float32, device=device),
            valid=torch.zeros(lead + (n,), dtype=torch.bool, device=device),
            point_id=torch.full(lead + (n,), -1, dtype=torch.int32, device=device),
            age=torch.zeros(lead + (n,), dtype=torch.int32, device=device),
            anchor=torch.zeros(lead + (n, 2), dtype=torch.float32, device=device),
        )

    def count(self) -> torch.Tensor:
        return torch.sum(self.valid.to(torch.int32), dim=-1, dtype=torch.int32)


class MapState(NamedTuple):
    points: torch.Tensor      # (M, 3) f32 world positions
    n_points: torch.Tensor    # i32 allocation cursor
    obs_u: torch.Tensor       # (O,) f32 u_left
    obs_v: torch.Tensor       # (O,) f32 v_left
    obs_ur: torch.Tensor      # (O,) f32 u_right (-1 if mono)
    obs_pid: torch.Tensor     # (O,) i32 point id
    obs_fid: torch.Tensor     # (O,) i32 frame id
    obs_cursor: torch.Tensor  # i32 ring cursor

    @staticmethod
    def empty(cfg: Config, device=None, lead: tuple = ()) -> "MapState":
        m = cfg.capacity.max_points
        o = cfg.ba.ring_obs
        f32 = dict(dtype=torch.float32, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        return MapState(
            points=torch.zeros(lead + (m, 3), **f32),
            n_points=torch.zeros(lead, **i32),
            obs_u=torch.zeros(lead + (o,), **f32),
            obs_v=torch.zeros(lead + (o,), **f32),
            obs_ur=torch.full(lead + (o,), -1.0, **f32),
            obs_pid=torch.full(lead + (o,), -1, **i32),
            obs_fid=torch.full(lead + (o,), -1, **i32),
            obs_cursor=torch.zeros(lead, **i32),
        )


class VoState(NamedTuple):
    features: FeatureSet
    map: MapState
    prev_pyramid: Any          # ((levels...), ((gx, gy)...)) of the previous left image
    frame_id: torch.Tensor     # i32 id of the PREVIOUS processed frame
    prev_is_kf: torch.Tensor   # bool
    last_kf_id: torch.Tensor   # i32 id of the most recent keyframe
    pose: torch.Tensor         # (4,4) T_wc of the previous frame
    rel_motion: torch.Tensor   # (4,4) T_wc(t) @ inv(T_wc(t-1)), constant-velocity prior
    prior_ok: torch.Tensor     # bool — last PnP was healthy; gates the prior
    poses: torch.Tensor        # (F, 4, 4) trajectory (camera-to-world)
    kf_flags: torch.Tensor     # (F,) bool
    metrics: torch.Tensor      # (F, 5): n_tracked, inlier_ratio, n_final, is_kf, n_map_pts
    rng: torch.Tensor          # (2,) i32 threefry key (uint32 bits), svo_tpu's PRNG key

