"""Batched FAST-9/16 corner detection as vectorized XLA ops.

Accelerator-native replacement for ``cv2.FastFeatureDetector_create()`` with its
defaults (threshold=10, nonmaxSuppression=True, TYPE_9_16), created at
/root/reference/meshflowstabilizer.py:99 and run per subframe at :613.

Design: instead of looping over 4x4 subframes per frame pair like the
reference (its `TODO parallelize` at :502), the segment test, score, and
non-max suppression are computed for every pixel of every frame at once
(shift-and-compare over the 16-pixel Bresenham circle — pure VPU work, no
gathers), then a fixed-capacity top-K per subframe turns the ragged OpenCV
keypoint lists into static-shape tensors with validity masks.

Subframe parity: the reference detects on 4x4 subframe *views*, so pixels
within 3 px of any subframe edge are never corner candidates (FAST needs a
radius-3 circle).  Zeroing scores in those bands on the full-frame score map
reproduces per-subframe detection exactly: a pixel >= 3 px inside its
subframe sees an identical neighborhood either way, and surviving corners in
adjacent subframes are >= 6 px apart so 3x3 NMS never couples them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from meshflow.config import MeshFlowConfig

# OpenCV's 16-pixel Bresenham circle offsets, (dx, dy), clockwise from the
# top (fast.cpp makeOffsets table).
CIRCLE_OFFSETS = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)


def _shift2d(img: jnp.ndarray, dx: int, dy: int) -> jnp.ndarray:
    """img shifted so out[y, x] = img[y + dy, x + dx], zero padded.

    Border values are wrong by construction; the score is zeroed within
    3 px of every (sub)frame edge, so they never matter.
    """
    h, w = img.shape[-2], img.shape[-1]
    pad = [(0, 0)] * (img.ndim - 2) + [(3, 3), (3, 3)]
    p = jnp.pad(img, pad)
    return jax.lax.slice_in_dim(
        jax.lax.slice_in_dim(p, 3 + dy, 3 + dy + h, axis=img.ndim - 2),
        3 + dx, 3 + dx + w, axis=img.ndim - 1,
    )


def fast_score_map(gray: jnp.ndarray) -> jnp.ndarray:
    """FAST-9/16 corner score per pixel.

    gray: uint8 (..., H, W).  Returns int32 scores matching OpenCV's
    cornerScore<16>: max over the 16 cyclic 9-pixel arcs of the arc's
    minimum brightness difference (both polarities), minus 1.  A pixel
    passes the segment test at threshold t iff score >= t.
    """
    center = gray.astype(jnp.int16)
    diffs = [
        _shift2d(gray, dx, dy).astype(jnp.int16) - center
        for dx, dy in CIRCLE_OFFSETS
    ]
    def arc_min9(d):
        # min over 9 cyclic consecutive entries for all 16 starting
        # points, as a log-step min tree over plain per-arc arrays.  A
        # stacked (..., H, W, 16) formulation with axis rolls materializes
        # each tree stage as a 16x-frame-sized buffer (measured ~470 MB of
        # transient HBM per 1080p frame); as an elementwise DAG on
        # (..., H, W) arrays XLA fuses the tree into the score pass.
        m2 = [jnp.minimum(d[k], d[(k + 1) % 16]) for k in range(16)]
        m4 = [jnp.minimum(m2[k], m2[(k + 2) % 16]) for k in range(16)]
        m8 = [jnp.minimum(m4[k], m4[(k + 4) % 16]) for k in range(16)]
        m9 = [jnp.minimum(m8[k], d[(k + 8) % 16]) for k in range(16)]
        out = m9[0]
        for k in range(1, 16):
            out = jnp.maximum(out, m9[k])
        return out

    bright = arc_min9(diffs)
    dark = arc_min9([-d for d in diffs])
    return (jnp.maximum(bright, dark).astype(jnp.int32) - 1)


def _dead_zone_mask(
    frame_height: int, frame_width: int, sub_h: int, sub_w: int
) -> np.ndarray:
    """bool (H, W), True where a pixel is >= 3 px inside its subframe."""
    y = np.arange(frame_height)
    x = np.arange(frame_width)
    # Position within the subframe (reference splits at multiples of
    # sub_h/sub_w; the last subframe may be smaller).
    y_in = y % sub_h
    x_in = x % sub_w
    sub_height = np.minimum(sub_h, frame_height - (y - y_in))
    sub_width = np.minimum(sub_w, frame_width - (x - x_in))
    y_ok = (y_in >= 3) & (y_in <= sub_height - 4)
    x_ok = (x_in >= 3) & (x_in <= sub_width - 4)
    return y_ok[:, None] & x_ok[None, :]


class Keypoints(NamedTuple):
    """Fixed-capacity keypoints per subframe.

    positions: (..., S, K, 2) float32 frame-relative [x, y]
    scores:    (..., S, K) int32
    valid:     (..., S, K) bool
    """

    positions: jnp.ndarray
    scores: jnp.ndarray
    valid: jnp.ndarray


@functools.partial(
    jax.jit, static_argnames=("config", "frame_height", "frame_width")
)
def detect_keypoints(
    gray: jnp.ndarray,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
) -> Keypoints:
    """FAST corners per subframe with static top-K capacity.

    gray: uint8 (..., H, W) -> Keypoints with S = num_subframes,
    K = max_features_per_subframe.  Keypoints are ordered by descending
    score (OpenCV returns scan order; order only influences downstream
    RANSAC sampling, which is randomized anyway).
    """
    sub_h, sub_w = config.subframe_shape(frame_height, frame_width)
    rows = config.mesh_outlier_subframe_row_count
    cols = config.mesh_outlier_subframe_col_count
    k = config.max_features_per_subframe

    score = fast_score_map(gray)
    score = jnp.where(
        jnp.asarray(_dead_zone_mask(frame_height, frame_width, sub_h, sub_w)),
        score,
        0,
    )

    # 3x3 non-max suppression, OpenCV semantics: a corner survives iff its
    # score is strictly greater than all 8 neighbors' corner scores
    # (non-corner neighbors contribute 0; adjacent equal-score corners
    # suppress each other).
    corner = score >= config.fast_threshold
    corner_score = jnp.where(corner, score, 0)
    neighbor_max = jnp.zeros_like(corner_score)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            neighbor_max = jnp.maximum(
                neighbor_max, _shift2d(corner_score, dx, dy)
            )
    keep = corner & (corner_score > neighbor_max)
    final_score = jnp.where(keep, score, 0)

    # Pad to an exact subframe grid, then top-K per subframe.
    pad_h = rows * sub_h - frame_height
    pad_w = cols * sub_w - frame_width
    batch = final_score.shape[:-2]
    padded = jnp.pad(
        final_score,
        [(0, 0)] * len(batch) + [(0, pad_h), (0, pad_w)],
    )
    tiled = padded.reshape(batch + (rows, sub_h, cols, sub_w))
    # Subframe order must match the reference's visit order (outer x, inner
    # y => column-major over (row, col)): index s = col * rows + row.
    tiled = jnp.moveaxis(tiled, -2, -3)  # (..., rows, cols, sub_h, sub_w)
    tiled = jnp.swapaxes(tiled, -4, -3)  # (..., cols, rows, sub_h, sub_w)
    flat = tiled.reshape(batch + (rows * cols, sub_h * sub_w))

    k_eff = min(k, sub_h * sub_w)
    top_scores, top_idx = jax.lax.top_k(flat, k_eff)  # (..., S, k_eff)
    if k_eff < k:  # pad out to the static capacity with invalid slots
        pad_spec = [(0, 0)] * (top_scores.ndim - 1) + [(0, k - k_eff)]
        top_scores = jnp.pad(top_scores, pad_spec)
        top_idx = jnp.pad(top_idx, pad_spec)
    valid = top_scores >= config.fast_threshold

    y_in = (top_idx // sub_w).astype(jnp.float32)
    x_in = (top_idx % sub_w).astype(jnp.float32)
    s_ids = jnp.arange(rows * cols)
    sub_col = s_ids // rows
    sub_row = s_ids % rows
    shape_s = (1,) * len(batch) + (rows * cols, 1)
    x = x_in + (sub_col * sub_w).reshape(shape_s).astype(jnp.float32)
    y = y_in + (sub_row * sub_h).reshape(shape_s).astype(jnp.float32)
    positions = jnp.stack([x, y], axis=-1)
    return Keypoints(positions=positions, scores=top_scores, valid=valid)
