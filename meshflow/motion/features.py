"""Per-frame-pair feature matching: detect -> track -> per-subframe RANSAC
-> global least-squares homography.

Rebuilds the reference's L2 stack (/root/reference/meshflowstabilizer.py:455-629):

* ``_get_all_matched_features_between_subframes`` (:581-629): FAST keypoints
  on the early frame, pyramidal LK into the late frame, tracked-status
  filtering.  Detection runs per subframe in one batched kernel; tracking
  runs on per-subframe tile pyramids (the tile axis is just a batch dim),
  matching the reference's subframe-view windows and pyramid sizes exactly
  — whole-frame tracking measurably shifts the global least-squares fit on
  translation-dominated pairs.
* ``_get_features_in_subframe`` (:531-578): per-subframe RANSAC homography
  inlier masks (OpenCV reproj threshold 3.0); subframes with < 4 features
  contribute nothing.
* ``_get_matched_features_and_homography`` (:455-528): all surviving
  features feed one least-squares DLT+refine homography.  The reference
  returns (None, None, None) when fewer than
  homography_min_number_corresponding_features remain — and then crashes
  dereferencing it (SURVEY.md section 8.11).  Here that case is defined
  behavior: ok=False, identity homography, empty feature set.

Ragged OpenCV arrays become fixed-capacity (S, K) tensors with masks.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from meshflow.config import MeshFlowConfig
from meshflow.kernels.fast import detect_keypoints
from meshflow.kernels.homography import estimate_homography, ransac_homography
from meshflow.kernels.lk import lk_track
from meshflow.utils.grid import subframe_offsets


class MatchResult(NamedTuple):
    """Fixed-capacity match set for one frame pair (N = S*K slots)."""

    early: jnp.ndarray  # (N, 2) float32 positions in the early frame
    late: jnp.ndarray  # (N, 2) float32 tracked positions in the late frame
    inlier: jnp.ndarray  # (N,) bool — survived tracking + subframe RANSAC
    homography: jnp.ndarray  # (3, 3) float32 early->late (identity if not ok)
    ok: jnp.ndarray  # () bool — >= min corresponding features survived


def track_pair(
    early_keypoints,
    prev_levels,
    next_levels,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
):
    """LK-track one frame's keypoints into the next frame.

    prev_levels/next_levels: per-tile pyramids (tile axis leading, see
    motion.pipeline.tile_pyramid).  Keypoint positions are frame-relative;
    tracking happens in tile-local coordinates like the reference's
    subframe views, then converts back.
    Returns (late_positions (S, K, 2) frame-relative, tracked (S, K) bool).
    """
    offsets = jnp.asarray(
        subframe_offsets(config, frame_height, frame_width), jnp.float32
    )  # (S, 2) [x, y]
    local_pts = early_keypoints.positions - offsets[:, None, :]

    def per_tile(prev_lv, next_lv, pts, valid):
        return lk_track(
            prev_lv,
            next_lv,
            pts,
            valid,
            win_size=config.lk_window_size,
            max_iters=config.lk_max_iterations,
            eps=config.lk_epsilon,
            min_eig_threshold=config.lk_min_eig_threshold,
        )

    # Levels are (C, S, Hp, Wp): tiles on axis 1, channels stay per call.
    tracked_local, status = jax.vmap(per_tile, in_axes=(1, 1, 0, 0))(
        prev_levels, next_levels, local_pts, early_keypoints.valid
    )
    return tracked_local + offsets[:, None, :], status


def match_pair(
    early_keypoints,
    prev_levels,
    next_levels,
    key: jax.Array,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
) -> MatchResult:
    """Full L2 stack for one frame pair."""
    late_pos, tracked = track_pair(
        early_keypoints, prev_levels, next_levels, config,
        frame_height, frame_width,
    )
    return match_from_tracks(
        early_keypoints.positions,
        late_pos,
        tracked & early_keypoints.valid,
        key,
        config,
    )


def match_from_tracks(
    early_pos: jnp.ndarray,  # (S, K, 2) frame-relative
    late_pos: jnp.ndarray,  # (S, K, 2) tracked positions
    tracked: jnp.ndarray,  # (S, K) bool
    key: jax.Array,
    config: MeshFlowConfig,
) -> MatchResult:
    """Per-subframe RANSAC + global least-squares homography from
    precomputed LK tracks."""
    s, k = tracked.shape[-2:]

    # Per-subframe RANSAC outlier rejection (vmapped over subframes).
    keys = jax.random.split(key, s)

    def per_subframe(early_s, late_s, valid_s, key_s):
        _, mask, ok_s = ransac_homography(
            early_s,
            late_s,
            valid_s,
            key_s,
            threshold=config.ransac_reproj_threshold,
            iterations=config.ransac_iterations,
            refine_iterations=config.homography_refine_iterations,
            polish_rounds=config.ransac_polish_rounds,
        )
        return mask & ok_s

    inlier = jax.vmap(per_subframe)(early_pos, late_pos, tracked, keys)

    flat_early = early_pos.reshape(s * k, 2)
    flat_late = late_pos.reshape(s * k, 2)
    flat_inlier = inlier.reshape(s * k)

    count = jnp.sum(flat_inlier.astype(jnp.int32))
    ok = count >= config.homography_min_number_corresponding_features

    weights = flat_inlier.astype(jnp.float32)
    h = estimate_homography(
        flat_early, flat_late, weights, config.homography_refine_iterations
    )
    identity = jnp.eye(3, dtype=jnp.float32)
    h = jnp.where(ok & jnp.all(jnp.isfinite(h)), h, identity)

    return MatchResult(
        early=flat_early,
        late=flat_late,
        inlier=flat_inlier & ok,
        homography=h,
        ok=ok,
    )
