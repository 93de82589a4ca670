"""Typed configuration for the svo_tpu_torch pipeline.

A copy of svo_tpu/config.py with the same dataclasses and defaults
(tests/test_torch_geometry.py holds the two equal). It is a copy, not an
import, because importing anything under svo_tpu imports jax, and the
port runs where jax is not installed. PyYAML is imported inside
load_config for the same reason.

Mirrors every knob of the reference config system (reference:
include/config_reader.h:13-44, configs/config.yaml:1-33) and additionally
surfaces the parameters the reference hardcodes (SURVEY.md §5):

- detection mask halfwidth 10 px            (reference: src/tracking.cpp:78)
- stereo KLT 11x11 / 3 levels / 30 iters    (reference: src/tracking.cpp:98-104)
- temporal KLT 21x21 / 3 levels / 50 iters  (reference: src/tracking.cpp:157-163)
- RANSAC 100 iters / 8 px / 0.999 / SQPNP   (reference: src/tracking.cpp:194)
- ORB extras: edge_threshold=patch_size, WTA_K=4, HARRIS_SCORE
                                            (reference: src/tracking.cpp:36-40)

The YAML loader accepts both plain YAML and the reference's OpenCV-flavoured
``%YAML:1.0`` files (the directive line is stripped before parsing).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class OrbParams:
    """ORB detector knobs (reference: include/config_reader.h:26-32)."""

    nfeatures: int = 500
    scale_factor: float = 1.2
    pyr_levels: int = 8
    patch_size: int = 31
    fast_treshold: int = 20  # [sic] reference spelling preserved in YAML key


@dataclass(frozen=True)
class FastParams:
    """FAST detector knobs (reference: include/config_reader.h:34-37)."""

    threshold: int = 20
    nonMaxSuppression: bool = True
    # Adaptive starvation floor (our robustness addition; the reference's
    # fixed threshold=20 goes completely blind on genuinely weak-texture
    # frames — box-fine-fast frames 127-139 have ZERO corners at 20, and the
    # pipeline dead-reckons through a turn). Corners with margin in
    # (min_threshold, threshold] form a WEAK tier that only fills detection
    # slots the strong tier leaves free (ops/select.py strong_gap), so
    # normally-textured frames are selected identically. Set equal to
    # `threshold` to disable.
    min_threshold: int = 5


@dataclass(frozen=True)
class TrackingParams:
    """Tracking knobs (reference: include/config_reader.h:39-42)."""

    y_threshold: float = 40.0
    features_to_track: int = 70
    # Forward-backward verification of temporal tracks: re-track curr->prev
    # and kill features whose round trip misses the start by more than
    # fb_threshold px. Breaks the prior->KLT->PnP positive feedback loop on
    # weak texture: a feature dragged to a gradient-free region by the motion
    # prior's flow seed cannot find its way back, while a genuine track can.
    fb_check: bool = True
    fb_threshold: float = 1.0
    # Eager keyframing beyond the reference's count-only rule: force a
    # keyframe every kf_max_interval frames (0 disables). Long keyframe gaps
    # let chained KLT drift and stale far-point triangulations degrade the
    # PnP problem into a flat valley (the reference survives only because
    # cv2's tracker sheds features faster, forcing replenishment).
    kf_max_interval: int = 6
    # Cap the depth (in baselines) of newly triangulated points: far points
    # carry large relative stereo depth error and drag translation. The
    # reference has no gate at all (cheirality only, src/tracking.cpp:136).
    # 200 baselines (~107 m at KITTI geometry): wide enough that open
    # scenes whose entire texture sits 60-100 m out (box worlds in the
    # multi-world suite) still triangulate — at 100 the pipeline collapsed
    # there with nothing to track; far-point depth bias is bounded by the
    # track age cap and the refinement's multi-view re-triangulation.
    max_depth_baselines: float = 200.0
    # Retire tracks older than this many frames (0 disables). Under receding
    # motion features never leave the view (they shrink toward the image
    # center), so chained-KLT template drift and stale one-shot
    # triangulations accumulate unboundedly in the PnP set; forward motion
    # self-heals only because features exit the FOV. The reference has no
    # cap — cv2's tracker sheds features fast enough that age never builds.
    # 30 frames (5 keyframe cadences): measured on the 8-stream bench to cut
    # reversed-stream ATE ~2x while slightly improving forward streams.
    max_track_age: int = 30
    # Motion-sanity gate on the PnP solve: reject a pose stepping more than
    # this many degrees of rotation from the previous frame's pose unless
    # the inlier support is strong (>= sane_min_inliers AND ratio >= 0.5).
    # On aliased near-textureless stretches (box-fine-fast) a handful of
    # coherently mistracked features can form a consensus for a 8-20 deg
    # single-frame rotation — physically impossible in the target domain
    # (KITTI sharp corner ~3 deg/frame at 10 fps) — which poisons the whole
    # downstream trajectory. 0 disables.
    max_step_rot_deg: float = 5.0
    sane_min_inliers: int = 25
    # Keyframe-anchored KLT: track every frame against the ANCHOR KEYFRAME's
    # template instead of chaining frame-to-frame. Both our tracker and cv2
    # carry a constant ~-0.02..-0.05 px flow measurement bias on real
    # imagery (scripts/probe_bias.py — identical for cv2, so the reference
    # pipeline integrates it too, src/tracking.cpp:154-179); chained
    # tracking integrates that bias EVERY FRAME into pitch/scale drift,
    # anchored tracking re-measures against the keyframe so it enters once
    # per keyframe generation — a ~cadence-fold cut in drift rate.
    anchored_klt: bool = False


@dataclass(frozen=True)
class KltParams:
    """Pyramidal Lucas-Kanade knobs. The reference hardcodes two call sites:
    stereo left->right (src/tracking.cpp:98-105) and temporal prev->curr
    (src/tracking.cpp:157-164)."""

    window: int = 21          # odd window side
    max_level: int = 3        # pyramid levels used = max_level + 1 (cv2 semantics)
    max_iters: int = 50
    eps: float = 1e-3         # convergence threshold on |delta| per iteration
    min_eig_threshold: float = 1e-4  # cv2 minEigThreshold default
    # Negative-x iteration travel budget (px, per pyramid level) — sizes the
    # patch the tracker extracts. 6 suffices for temporal tracking (the
    # coarse-to-fine chain leaves ~2-3 px of per-level residual); stereo
    # matching needs more: disparity moves features LEFT by up to
    # ~disparity/2^L px at the top level before the guess chain kicks in.
    margin_x: int = 6
    # Optional per-level iteration budgets, index = pyramid level (level 0
    # first; missing entries reuse the last). Iterations are statically
    # unrolled with a convergence mask, so a tighter budget shrinks the
    # program. Default None = max_iters everywhere (cv2 semantics):
    # measured on-chip, a (24,10,8,8) budget cut the lowered program ~13%
    # with NO throughput change (the unrolled iterations fuse well; the
    # dispatch floor lives elsewhere) while starving upper levels enough
    # to break large-flow border rejection (features stopped short of the
    # image edge instead of exiting and dying). Keep the knob, not the
    # diet.
    level_iters: tuple | None = None


@dataclass(frozen=True)
class RansacParams:
    """RANSAC-PnP knobs (reference: src/tracking.cpp:191-194).

    The reference uses cv::solvePnPRansac(iters=100, reproj=8.0, conf=0.999,
    SOLVEPNP_SQPNP). TPU-native design replaces adaptive iterations with a
    fixed batch of parallel hypotheses (static shapes under jit)."""

    num_hypotheses: int = 128
    reproj_threshold: float = 8.0
    refine_iters: int = 4     # Gauss-Newton iterations per LO round
    lo_rounds: int = 2        # refine <-> inlier-reselect alternations (LO-RANSAC)
    # Threshold-annealed LO (Lebeda-style multiplier schedule): each LO round
    # r selects inliers at lo_anneal[r] * reproj_threshold before its GN
    # pass; the FINAL consensus is always judged at the strict threshold.
    # Rescues the previous-pose candidate during fast rotation: at ~1.7
    # deg/frame of yaw its reprojections sit ~20 px out, where a strict
    # 8 px seed mask is EMPTY and masked GN cannot move (the round-4
    # box-world collapse: every minimal DLT hypothesis is degenerate on far
    # quasi-planar structure — median 0 inliers — so PnP success was a
    # Gumbel-draw lottery, scripts/probe_pnp_turn.py). The wide first gate
    # admits the whole smooth error field, GN contracts it, and the
    # schedule re-tightens to the strict gate deterministically. Two rounds
    # (4x then strict) measure as accurate as (4,2,1) on the box worlds and
    # cost one GN round less per frame.
    lo_anneal: tuple = (4.0, 1.0)
    # The annealed candidate is adopted only when its strict consensus
    # beats the best strict candidate's by this factor (+2): a rescue for
    # tracking collapse, not a per-frame competitor (see geometry/pnp.py).
    rescue_margin: float = 1.25


@dataclass(frozen=True)
class BucketParams:
    """Grid-bucketed feature selection. The reference shipped this as dead,
    buggy code (include/bucket.h, src/bucket.cpp, called nowhere; TODO at
    src/tracking.cpp:88). First-class here, bugs fixed."""

    enabled: bool = True
    bucket_size: int = 64          # cell side in pixels
    features_per_bucket: int = 8   # per-cell cap


@dataclass(frozen=True)
class BaParams:
    """Windowed bundle adjustment — the reference's declared-but-missing
    back-end (src/map.cpp:84-88, Ceres linked but never called)."""

    enabled: bool = False
    window: int = 8                # KEYFRAMES in the optimization window
    interval: int = 4              # run BA every `interval` keyframes
    n_fixed: int = 1               # gauge-anchor cameras at the window start
    max_points: int = 1024         # point slots in the window problem
    max_obs: int = 4096            # observation slots in the window problem
    ring_obs: int = 32768          # capacity of the global observation ring
    iterations: int = 10           # LM outer iterations
    huber_delta: float = 5.0       # px, robust loss width
    reject_threshold: float = 20.0  # px, hard outlier cutoff in robust weights
    init_lambda: float = 1e-4


@dataclass(frozen=True)
class Capacity:
    """Static capacities (fixed shapes under jit)."""

    # Per-frame feature slots. Every tracker/PnP op scales linearly with
    # this STATIC capacity (dead slots included), so it is sized to ~2x the
    # reference's features_to_track=70 target rather than generously: 128
    # slots keep ~100+ live tracks, and halving from round-1's 256 halves
    # the whole track-step cost for <2% ATE movement (measured).
    max_features: int = 128
    # Global map point slots. A full KITTI sequence allocates ~50k points at
    # the default keyframe cadence; the table is also touched by a per-step
    # layout copy under the chunked scan, so oversizing it costs real
    # per-frame milliseconds, not just memory.
    max_points: int = 1 << 17
    max_frames: int = 4608         # trajectory slots
    max_detections: int = 192      # new detection candidates per keyframe


@dataclass(frozen=True)
class Config:
    """Full pipeline configuration. Field names/defaults follow the reference
    Config struct (include/config_reader.h:13-44) plus TPU-native extensions."""

    # --- reference knobs (configs/config.yaml) ---
    path: str = ""
    gt_path: str = ""
    calib_path: str = ""
    fx: float = 718.8560
    fy: float = 718.8560
    cx: float = 607.1928
    cy: float = 185.2157
    bf: float = -386.1448          # parsed but unused in the reference too
    start_frame: int = 0
    end_frame: int = 4540
    show_gt: bool = True
    use_orb: bool = True
    orb_params: OrbParams = field(default_factory=OrbParams)
    fast_params: FastParams = field(default_factory=FastParams)
    tracking: TrackingParams = field(default_factory=TrackingParams)

    # --- surfaced hardcoded reference params ---
    mask_halfwidth: int = 10       # detection suppression half-width (tracking.cpp:78)
    # Iteration budgets below the reference's 30/50 (src/tracking.cpp:98-105,
    # 157-164): LK converges quadratically, cv2's eps exit typically fires
    # within ~5-10 updates, and with eager keyframing (fresh templates) the
    # extra budget only pays for features the fb-check kills anyway. The
    # updates are statically unrolled on TPU, so the budget is also the
    # exact per-level cost — and measured ATE is flat-to-better at 8 vs 12
    # (surplus iterations let weak low-texture tracks wander before the
    # convergence mask freezes them).
    stereo_klt: KltParams = field(
        default_factory=lambda: KltParams(
            window=11, max_level=3, max_iters=8, margin_x=16
        )
    )
    temporal_klt: KltParams = field(
        default_factory=lambda: KltParams(window=21, max_level=3, max_iters=8)
    )
    ransac: RansacParams = field(default_factory=RansacParams)

    # --- TPU-native extensions ---
    # "rectified": closed-form disparity triangulation (exact for rectified
    # rigs like KITTI, pure arithmetic). "dlt": 4x4 nullspace like
    # cv::triangulatePoints (reference parity; costs an eigensolve per point).
    triangulator: str = "rectified"
    # constant-velocity motion prior entering PnP as an extra verified
    # hypothesis (built from the relative motion the reference computes and
    # never uses, src/tracking.cpp:215)
    motion_prior: bool = True
    # additionally seed KLT flow with the prior's predicted displacement.
    # OFF by default: on weak texture this closes a self-confirming
    # prior->tracks->pose feedback loop (see pipeline/frontend.py).
    flow_seeding: bool = False
    bucket: BucketParams = field(default_factory=BucketParams)
    ba: BaParams = field(default_factory=BaParams)
    capacity: Capacity = field(default_factory=Capacity)
    image_height: int = 376        # static image shape for jit (KITTI seq 00)
    image_width: int = 1241


def _build(cls, data: dict[str, Any]):
    """Recursively build a (nested) dataclass from a dict, ignoring unknown
    keys and keeping defaults for missing ones."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if dataclasses.is_dataclass(f.type) if isinstance(f.type, type) else False:
            kwargs[f.name] = _build(f.type, v)
        elif isinstance(v, dict):
            # nested dataclass referenced by string annotation
            sub = _FIELD_TYPES.get((cls, f.name))
            kwargs[f.name] = _build(sub, v) if sub else v
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


_FIELD_TYPES = {
    (Config, "orb_params"): OrbParams,
    (Config, "fast_params"): FastParams,
    (Config, "tracking"): TrackingParams,
    (Config, "stereo_klt"): KltParams,
    (Config, "temporal_klt"): KltParams,
    (Config, "ransac"): RansacParams,
    (Config, "bucket"): BucketParams,
    (Config, "ba"): BaParams,
    (Config, "capacity"): Capacity,
}

# YAML keys in the reference use "tracking_params"; map to our field name.
_KEY_ALIASES = {"tracking_params": "tracking"}


def load_config(path: str) -> Config:
    """Load a YAML config. Accepts the reference's OpenCV ``%YAML:1.0`` files
    (reference: include/config_reader.h:47-87) and plain YAML."""
    import yaml

    with open(path) as f:
        text = f.read()
    lines = [ln for ln in text.splitlines() if not ln.startswith("%YAML")]
    data = yaml.safe_load("\n".join(lines)) or {}
    data = {_KEY_ALIASES.get(k, k): v for k, v in data.items()}
    # OpenCV YAML stores bools as 0/1
    for k in ("show_gt", "use_orb"):
        if k in data:
            data[k] = bool(data[k])
    return _build(Config, data)
