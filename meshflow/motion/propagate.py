"""Feature -> mesh-vertex motion propagation (the reference's L3).

Rebuilds /root/reference/meshflowstabilizer.py:287-452:

* Global vertex motion: perspective-transform the vertex grid through the
  pair homography and subtract (:323-328).
* Residual motion: each inlier feature's residual velocity
  (late - H(early), :420) is scattered to every mesh vertex inside an
  ellipse of feature_ellipse_{row,col}_count mesh cells centered on the
  feature's fractional mesh coordinates (:426-450); median filter #1 takes
  the per-vertex median over contributing features, 0 for empty bins
  (:338-353, statistics.median semantics).
* Median filter #2: 3x3 spatial median over the (rows+1, cols+1) velocity
  field (cv2.medianBlur float32, :359-360) after the global+residual sum is
  cast to float32 (:354-355).

The Python scatter loop becomes one (V, N) membership mask and a masked
median — for integer vertex coordinates, `r >= ceil(x)` is exactly
`r >= x`, so the reference's ceil/floor index bounds translate to pure
comparisons (SURVEY.md section 8.7).
"""

from __future__ import annotations

import jax.numpy as jnp

from meshflow.config import MeshFlowConfig
from meshflow.kernels.homography import apply_homography
from meshflow.kernels.median import masked_median, median3x3


def ellipse_membership(
    feature_pos: jnp.ndarray,
    valid: jnp.ndarray,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
) -> jnp.ndarray:
    """(vertex_rows, vertex_cols, N) bool: feature n contributes to vertex
    (r, c) iff the vertex lies inside the feature's mesh-cell-unit ellipse.
    """
    re = float(config.feature_ellipse_row_count)
    ce = float(config.feature_ellipse_col_count)
    fr = (feature_pos[:, 1] / frame_height) * config.mesh_row_count  # (N,)
    fc = (feature_pos[:, 0] / frame_width) * config.mesh_col_count

    r = jnp.arange(config.vertex_rows, dtype=jnp.float32)  # (R+1,)
    c = jnp.arange(config.vertex_cols, dtype=jnp.float32)  # (C+1,)

    dr = (r[:, None] - fr[None, :]) / re  # (R+1, N)
    row_ok = jnp.abs(r[:, None] - fr[None, :]) <= re / 2.0
    half_width = ce * jnp.sqrt(jnp.maximum(0.25 - dr * dr, 0.0))  # (R+1, N)

    dc = c[None, :, None] - fc[None, None, :]  # (1, C+1, N)
    col_ok = jnp.abs(dc) <= half_width[:, None, :]  # (R+1, C+1, N)

    return col_ok & row_ok[:, None, :] & valid[None, None, :]


def vertex_velocities(
    match,
    vertex_grid: jnp.ndarray,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
) -> jnp.ndarray:
    """(vertex_rows, vertex_cols, 2) float32 vertex velocities for one pair.

    match: a MatchResult; vertex_grid: (R+1, C+1, 2) float32 pixel coords.
    """
    vr, vc = config.vertex_rows, config.vertex_cols
    grid_flat = vertex_grid.reshape(-1, 2)
    global_vel = (
        apply_homography(match.homography, grid_flat) - grid_flat
    ).reshape(vr, vc, 2)

    # Residual velocities of inlier features.
    projected = apply_homography(match.homography, match.early)
    residual = match.late - projected  # (N, 2)

    member = ellipse_membership(
        match.early, match.inlier, config, frame_height, frame_width
    )  # (vr, vc, N)

    res_x = masked_median(
        jnp.broadcast_to(residual[None, None, :, 0], member.shape), member
    )
    res_y = masked_median(
        jnp.broadcast_to(residual[None, None, :, 1], member.shape), member
    )

    vel_x = (global_vel[..., 0] + res_x).astype(jnp.float32)
    vel_y = (global_vel[..., 1] + res_y).astype(jnp.float32)

    return jnp.stack(
        [median3x3(vel_x), median3x3(vel_y)], axis=-1
    )
