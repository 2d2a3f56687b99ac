"""Track geometry: motion estimation on box-downscaled frames.

The reference's parity contract lives entirely at its demo resolution
(640x360; /root/reference/videos are all 640x360), but its per-pixel motion
stages — FAST detection (meshflowstabilizer.py:613), pyramidal LK
(:618-620), and the metric re-matching pass (:1195-1197) — scale linearly
with pixels while the mesh they feed stays 16x16.  Above ~0.27 MP this
package therefore runs every tracking stage on d x d box-downscaled frames
("track geometry", config.track_downscale) and converts the results back at
the solver boundary:

* vertex velocities scale by (sx, sy) = (w/tw, h/th) — exact, because the
  banded Jacobi solve is linear in the displacements
  (meshflowstabilizer.py:844-878),
* per-pair homographies conjugate as H_full = S H_track S^-1 with
  S = diag(sx, sy, 1) — which leaves the adaptive-weight features
  (translational component normalized by frame dims, affine eigenvalue
  ratio, :819-835) and the metric formulas (1/(H00*H11) at :1203, affine
  eigen-ratio at :1206-1210) invariant,
* the metric tracker compares the d-downscaled original against the
  d-downscaled output video, so its homography is the conjugate of the
  full-resolution one.

The downscale is an exact integer box mean with cv2.resize(INTER_AREA)
rounding semantics: both twins (NumPy on the host, JAX on the device)
reproduce cv2's tie behavior per factor (half-up for d in {2, 3},
half-even for even d >= 4), so host- and device-derived track planes agree
bit-for-bit with each other and with cv2 (tests/test_trackscale.py).
Frames are cropped to (th*d, tw*d) first so windows stay aligned at
non-divisible sizes (<= d-1 boundary pixels leave the tracked area).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from meshflow.config import MeshFlowConfig


def scale_factors(
    frame_height: int, frame_width: int, config: MeshFlowConfig
) -> tuple[float, float]:
    """(sx, sy): track-geometry displacements -> full-resolution pixels."""
    th, tw = config.track_shape(frame_height, frame_width)
    return frame_width / tw, frame_height / th


def _round_box_sum(s, d: int, xp):
    """Box sums of d*d uint8 values -> uint8 means with cv2 INTER_AREA's
    tie rule per factor; xp is numpy or jax.numpy."""
    dd = d * d
    base, rem = s // dd, s % dd
    if dd % 2 == 1:
        rounded = base + (2 * rem > dd)
    elif d == 2:
        rounded = base + (2 * rem >= dd)
    else:
        up = xp.where(2 * rem == dd, base % 2, (2 * rem > dd).astype(s.dtype))
        rounded = base + up
    return rounded.astype(xp.uint8)


def box_downscale_host(frames: np.ndarray, d: int) -> np.ndarray:
    """(F, H, W, C) uint8 -> (F, H//d, W//d, C), integer box mean.

    Host twin of box_downscale_dev (bit-identical, and so to
    cv2.resize(INTER_AREA) after cropping to a multiple of d), in NumPy
    alone: strided row sums, then strided column sums, in the narrowest
    exact accumulator.
    """
    if d == 1:
        return frames
    f, h, w, c = frames.shape
    th, tw = h // d, w // d
    acc = np.uint16 if d * d * 255 <= np.iinfo(np.uint16).max else np.int32
    x = frames[:, : th * d, : tw * d]
    rows = x[:, 0::d].astype(acc)
    for i in range(1, d):
        rows += x[:, i::d]
    s = rows[:, :, 0::d].copy()
    for j in range(1, d):
        s += rows[:, :, j::d]
    return _round_box_sum(s, d, np)


@functools.partial(jax.jit, static_argnames=("d",))
def box_downscale_dev(frames: jnp.ndarray, d: int) -> jnp.ndarray:
    """Device twin of box_downscale_host (bit-identical, uint8 in/out).

    Integer arithmetic throughout: the sum of d*d uint8 values is exact in
    int32, and the tie rule matches cv2's INTER_AREA per factor — the 2x2
    fixed-point fast path rounds half away from zero, the generic path
    rounds half to even (ties cannot occur at odd d*d, e.g. d=3).
    """
    if d == 1:
        return frames
    f, h, w, c = frames.shape
    th, tw = h // d, w // d
    cropped = frames[:, : th * d, : tw * d]
    s = jnp.sum(
        cropped.reshape(f, th, d, tw, d, c).astype(jnp.int32), axis=(2, 4)
    )
    return _round_box_sum(s, d, jnp)


def to_track_planes_dev(
    frames_bgr: jnp.ndarray, config: MeshFlowConfig
) -> jnp.ndarray:
    """Device twin of streaming.to_track_planes for device-resident frames:
    (F, H, W, 3) uint8 BGR -> downscaled (F, th, tw, C) tracker planes."""
    from meshflow.kernels.color import bgr_to_gray

    d = config.resolve_track_downscale(frames_bgr.shape[1], frames_bgr.shape[2])
    small = box_downscale_dev(frames_bgr, d)
    if config.track_planes == "gray":
        return bgr_to_gray(small)[..., None]
    return small


@jax.jit
def scale_velocities(
    velocities: jnp.ndarray, sx: float, sy: float
) -> jnp.ndarray:
    """Per-pair vertex velocities, track geometry -> full-res pixels."""
    return velocities * jnp.asarray([sx, sy], velocities.dtype)


@jax.jit
def conjugate_homographies(
    homographies: jnp.ndarray, sx: float, sy: float
) -> jnp.ndarray:
    """H_full = S H_track S^-1, S = diag(sx, sy, 1), batched over frames.

    Pure-scale conjugation: the half-pixel phase of the box downscale is
    absorbed (a constant sub-pixel offset of the mesh, invisible to the
    smoothing).  Normalization H22 = 1 is preserved.
    """
    s = jnp.asarray([sx, sy, 1.0], homographies.dtype)
    return homographies * (s[:, None] / s[None, :])
