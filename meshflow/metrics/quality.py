"""Stabilization quality metrics (the reference's L6).

Rebuilds /root/reference/meshflowstabilizer.py:1160-1259:

* cropping ratio: per frame, re-match features between the unstabilized and
  cropped frames (the full L2 stack again, :1195-1197) and take
  1 / (H00 * H11) (:1203); video value is the mean over frames.
* distortion score: ratio of the two largest eigenvalue magnitudes of the
  homography's affine part (:1206-1210); video value is np.min over frames
  (the docstring says "greatest"; the code takes the min — follow the code,
  SURVEY.md section 8.4).
* stability score: per-vertex FFT energy of the diff'd displacement
  profiles; fraction in frequency bins [1:6); x and y scored separately,
  averaged, then averaged over vertices (:1216-1259).

Defined behavior where the reference crashes or NaNs (SURVEY.md 8.11):
frames whose unstabilized<->cropped matching fails contribute ratio 1 and
distortion 1 (identity homography); all-zero vertex profiles contribute
stability 0 instead of 0/0.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from meshflow.config import MeshFlowConfig
from meshflow.kernels.eig3 import affine_eigen_ratio
from meshflow.motion.features import match_pair


@jax.jit
def stability_score(stab_disp: jnp.ndarray) -> jnp.ndarray:
    """stab_disp: (F, R+1, C+1, 2) -> scalar stability score."""
    profiles = jnp.diff(stab_disp, axis=0)  # (F-1, R+1, C+1, 2)
    freq = jnp.fft.fft(profiles, axis=0)
    energy = jnp.abs(freq) ** 2
    total = jnp.sum(energy, axis=0)  # (R+1, C+1, 2)
    low = jnp.sum(energy[1:6], axis=0)
    score = jnp.where(total > 0, low / jnp.where(total > 0, total, 1.0), 0.0)
    return (jnp.mean(score[..., 0]) + jnp.mean(score[..., 1])) / 2.0


@functools.partial(
    jax.jit,
    static_argnames=("config", "frame_height", "frame_width"),
)
def cropping_and_distortion_scanned(
    unstab_keypoints,
    unstab_frames: jnp.ndarray,
    cropped_frames: jnp.ndarray,
    key: jax.Array,
    key_offset: jnp.ndarray,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
):
    """Per-frame unstabilized->cropped homographies -> per-frame
    (ratios, distortions) arrays; the video-level mean/min reduction happens
    at the caller (which may be driving fixed-size chunks).  Pyramids are
    rebuilt per frame inside the scan (same memory policy as
    motion.pipeline).

    Callers that know the global crop must NOT seed the tracker from it
    (see the comment at the tracker call)."""
    from meshflow.motion.pipeline import packed_tile_pyramids, unpack_level

    num_frames = unstab_keypoints.valid.shape[0]
    max_level = config.lk_max_level(frame_height, frame_width)
    # Track like the reference (meshflowstabilizer.py:1195-1203): from the
    # unstabilized keypoints with cv2's zero-init, not seeded at the
    # analytic crop+stretch destination.  Seeding changes which features
    # survive, and that population is part of the metric's semantics.
    packed_un = packed_tile_pyramids(unstab_frames, config, max_level)
    packed_cr = packed_tile_pyramids(cropped_frames, config, max_level)

    def body(carry, t):
        kps_t = jax.tree.map(lambda a: a[t], unstab_keypoints)
        un_lv = tuple(unpack_level(pk, t) for pk in packed_un)
        cr_lv = tuple(unpack_level(pk, t) for pk in packed_cr)
        match = match_pair(
            kps_t, un_lv, cr_lv, jax.random.fold_in(key, t + key_offset), config,
            frame_height, frame_width,
        )
        h = match.homography
        ratio = 1.0 / (h[0, 0] * h[1, 1])
        distortion = affine_eigen_ratio(h)
        ratio = jnp.where(match.ok, ratio, 1.0)
        distortion = jnp.where(match.ok, distortion, 1.0)
        return carry, (ratio.astype(jnp.float32), distortion.astype(jnp.float32))

    _, (ratios, distortions) = jax.lax.scan(
        body, None, jnp.arange(num_frames)
    )
    return ratios, distortions
