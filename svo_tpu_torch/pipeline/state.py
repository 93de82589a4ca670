"""Pipeline state: fixed-capacity struct-of-arrays world model.

Port of svo_tpu/pipeline/state.py. FeatureSet is the live feature table,
MapState the preallocated map with its monotone allocation cursor and the
COO observation ring, VoState everything a frame step needs. svo_tpu's
VoState also carries a jax PRNG key; here the engine holds a
torch.Generator instead, so the port's VoState has no `rng` field.

A batched state of S streams (parallel/batched.py) is the same structure
with a leading (S,) on every leaf, as jax.vmap makes svo_tpu's; stack and
unstack convert between S single states and one batched state.

from_numpy / to_numpy convert between svo_tpu's state fetched to numpy
(jax.tree.map(np.asarray, state)) and this one, single or batched, so both
packages can run a step from the same state.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from svo_tpu_torch.config import Config


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


_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.bool_): torch.bool,
}


def tensor(a, device=None) -> torch.Tensor:
    """A numpy array of one of the state's dtypes (f32, i32, bool) as a tensor."""
    a = np.asarray(a)
    if a.dtype not in _DTYPES:
        raise TypeError(f"unexpected state dtype {a.dtype}")
    return torch.tensor(a, dtype=_DTYPES[a.dtype], device=device)


def from_numpy(tree, device) -> VoState:
    """svo_tpu's VoState with numpy leaves -> the port's VoState on
    `device`. Fields are read by name; the jax `rng` key is dropped (the
    engine's generator replaces it)."""
    def t(a):
        return tensor(a, device)

    levels, grads = tree.prev_pyramid
    return VoState(
        features=FeatureSet(*(t(getattr(tree.features, f)) for f in FeatureSet._fields)),
        map=MapState(*(t(getattr(tree.map, f)) for f in MapState._fields)),
        prev_pyramid=(
            tuple(t(l) for l in levels),
            tuple((t(gx), t(gy)) for gx, gy in grads),
        ),
        **{f: t(getattr(tree, f)) for f in VoState._fields[3:]},
    )


def to_numpy(state: VoState) -> VoState:
    """The port's VoState -> the same structure with numpy leaves."""
    return _map_leaves(lambda x: x.detach().cpu().numpy(), state)


def _map_leaves(fn, *states: VoState) -> VoState:
    """fn over corresponding leaves of the states, in the order of the
    fields (features, map, the pyramid's levels then its gradients, the
    rest): the order jax.tree.leaves gives svo_tpu's state."""
    features = FeatureSet(*(fn(*xs) for xs in zip(*(s.features for s in states))))
    mp = MapState(*(fn(*xs) for xs in zip(*(s.map for s in states))))
    pyrs = [s.prev_pyramid for s in states]
    levels = tuple(fn(*ls) for ls in zip(*(p[0] for p in pyrs)))
    grads = tuple(
        (fn(*(g[0] for g in gs)), fn(*(g[1] for g in gs)))
        for gs in zip(*(p[1] for p in pyrs))
    )
    return VoState(
        features=features,
        map=mp,
        prev_pyramid=(levels, grads),
        **{f: fn(*(getattr(s, f) for s in states)) for f in VoState._fields[3:]},
    )


def leaves(state: VoState) -> list:
    """Every leaf of the state in a fixed order, pyramid included."""
    out = []
    _map_leaves(out.append, state)
    return out


def unflatten(leaf_list, like: VoState) -> VoState:
    """The state with `like`'s structure whose leaves(), in order, are
    leaf_list."""
    it = iter(leaf_list)
    return _map_leaves(lambda _: next(it), like)


def stack(states) -> VoState:
    """S single-stream states -> one batched state, leaves (S, ...)."""
    return _map_leaves(lambda *xs: torch.stack(xs), *states)


def unstack(state: VoState) -> list[VoState]:
    """One batched state -> its S single-stream states."""
    S = state.frame_id.shape[0]
    return [_map_leaves(lambda x, s=s: x[s], state) for s in range(S)]
