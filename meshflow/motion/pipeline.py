"""Whole-clip motion estimation: the reference's stage 2
(/root/reference/meshflowstabilizer.py:236-284) as one jitted scan.

The reference loops frame pairs sequentially purely because of the running
cumulative sum at :281; every pair is independent.  Here pair matching runs
under lax.scan and the displacement integration is a single cumsum — which
becomes an associative scan over the frame-sharded mesh axis in the
multi-chip path (SURVEY.md section 2.3).

Memory policy (device memory is the budget, not FLOPs): only the uint8 gray frames
and the per-subframe keypoints persist across the scan; each pair's padded
pyramid levels and Scharr derivatives are rebuilt inside the scan body
(a few MFLOP per frame — noise next to the LK solve) instead of holding
F x levels x 3 float32 planes for the whole clip.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from meshflow.config import MeshFlowConfig
from meshflow.kernels.color import bgr_to_gray
from meshflow.kernels.fast import detect_keypoints
from meshflow.kernels.lk import PaddedLevel, prepare_level
from meshflow.kernels.pyramid import build_pyramid
from meshflow.motion.features import match_pair
from meshflow.motion.propagate import vertex_velocities
from meshflow.utils import grid

_DETECT_PIXEL_BUDGET = 32 * 640 * 360  # pixels per FAST invocation


def _detect_chunk(frame_height: int, frame_width: int) -> int:
    """Frames per FAST invocation, scaled down with resolution.

    The score map's 16-way shifted-diff stack and min-tree are transients
    of a few dozen values per pixel; bounding pixels-per-invocation keeps
    that transient at the 640x360 level at any resolution.
    32 frames at 640x360 (the demo suite, unchanged) -> 4 at 1080p ->
    1 at 4K.
    """
    per_frame = frame_height * frame_width
    return max(1, min(32, _DETECT_PIXEL_BUDGET // per_frame))


class MotionEstimate(NamedTuple):
    """Stage-2 outputs for a clip of F frames."""

    displacements: jnp.ndarray  # (F, R+1, C+1, 2) float32, frame 0 == 0
    homographies: jnp.ndarray  # (F, 3, 3) float32, index F-1 == identity
    pair_ok: jnp.ndarray  # (F-1,) bool — pair had >= min features


@functools.partial(jax.jit, static_argnames=("config", "frame_height", "frame_width"))
def detect_all_frames(
    gray8: jnp.ndarray,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
):
    """FAST keypoints for every frame, chunked over the frame axis."""
    f = gray8.shape[0]
    chunk = _detect_chunk(frame_height, frame_width)
    pad = (-f) % chunk
    padded = jnp.pad(gray8, [(0, pad), (0, 0), (0, 0)])
    blocks = padded.reshape(-1, chunk, frame_height, frame_width)
    kps = jax.lax.map(
        lambda g: detect_keypoints(g, config, frame_height, frame_width), blocks
    )
    return jax.tree.map(
        lambda a: a.reshape((-1,) + a.shape[2:])[:f], kps
    )


def frame_pyramid(gray8_frame: jnp.ndarray, max_level: int):
    """Padded pyramid levels + derivatives for one (H, W) uint8 frame."""
    return tuple(
        prepare_level(lvl)
        for lvl in build_pyramid(gray8_frame.astype(jnp.float32), max_level)
    )


def split_tiles(gray: jnp.ndarray, config: MeshFlowConfig):
    """(..., H, W) -> (..., S, tile_h, tile_w) in the reference's subframe
    order (outer loop over x, inner over y: s = col * rows + row,
    /root/reference/meshflowstabilizer.py:503-509).

    Non-divisible frames are edge-padded; the reference instead gives the
    last subframe its true (smaller) extent, so tracking near the padded
    edge can differ there — exact for the demo suite's 640x360.
    """
    h, w = gray.shape[-2], gray.shape[-1]
    rows = config.mesh_outlier_subframe_row_count
    cols = config.mesh_outlier_subframe_col_count
    tile_h, tile_w = config.subframe_shape(h, w)
    pad = [(0, 0)] * (gray.ndim - 2) + [
        (0, rows * tile_h - h),
        (0, cols * tile_w - w),
    ]
    g = jnp.pad(gray, pad, mode="edge")
    batch = gray.shape[:-2]
    g = g.reshape(batch + (rows, tile_h, cols, tile_w))
    g = jnp.moveaxis(g, -2, -4)  # (..., cols, rows, tile_h, tile_w)
    return g.reshape(batch + (rows * cols, tile_h, tile_w))


def tile_pyramid(frame: jnp.ndarray, config: MeshFlowConfig, max_level: int):
    """Per-subframe-tile padded pyramid for one frame.

    frame: (H, W, 3) uint8 BGR (or (H, W) gray).  The reference runs
    cv2.calcOpticalFlowPyrLK on 3-channel BGR subframe views
    (/root/reference/meshflowstabilizer.py:618-620), so (a) LK windows are
    clamped to tile support and pyramid levels derive from tile dims —
    whole-frame tracking measurably shifts the global least-squares fit on
    translation-dominated pairs — and (b) gradients/residuals accumulate
    over the three channels, which changes which weak-texture tracks pass
    OpenCV's minEig threshold.  Channels and tiles are batch dimensions:
    every level is (C, S, th_l+2P, tw_l+2P).
    """
    if frame.ndim == 3:
        chans = jnp.moveaxis(frame, -1, 0).astype(jnp.float32)
    else:
        chans = frame[None].astype(jnp.float32)
    tiles = split_tiles(chans, config)  # (C, S, th, tw)
    return tuple(
        prepare_level(lvl) for lvl in build_pyramid(tiles, max_level)
    )


def packed_tile_pyramids(
    frames_bgr: jnp.ndarray, config: MeshFlowConfig, max_level: int
):
    """Tile pyramids for a whole frame block, packed for device residency.

    Building pyramids per pair inside the scan costs hundreds of tiny
    elementwise ops per step; building them once for the block amortizes
    that across all frames.  Levels are stored exactly in compact dtypes: pyrDown levels are 8-bit values (uint8), Scharr
    derivatives x32 are integers within int16.

    frames_bgr: (F, H, W, C) uint8 (C=3 BGR or C=1 gray) -> tuple over
    levels of (image_u8, gx_i16, gy_i16), each (F, C, S, Hp_l, Wp_l).
    """
    chans = jnp.moveaxis(frames_bgr, -1, 1).astype(jnp.float32)  # (F, C, H, W)
    tiles = split_tiles(chans, config)  # (F, 3, S, th, tw)
    packed = []
    for lvl in build_pyramid(tiles, max_level):
        pl = prepare_level(lvl)
        packed.append(
            (
                pl.image.astype(jnp.uint8),
                jnp.round(pl.gx * 32.0).astype(jnp.int16),
                jnp.round(pl.gy * 32.0).astype(jnp.int16),
            )
        )
    return tuple(packed)


def unpack_level(packed_level, t) -> PaddedLevel:
    """One frame's PaddedLevel from a packed block level."""
    img, gx, gy = packed_level
    return PaddedLevel(
        image=img[t].astype(jnp.float32),
        gx=gx[t].astype(jnp.float32) * (1.0 / 32.0),
        gy=gy[t].astype(jnp.float32) * (1.0 / 32.0),
    )


def prepare_frames(frames_bgr: jnp.ndarray, config: MeshFlowConfig):
    """Shared per-frame work: gray conversion and keypoints.

    frames_bgr: (F, H, W, 3) uint8 BGR or (F, H, W, 1) uint8 gray (the
    track_planes="gray" transport, already converted with cv2's exact
    BGR2GRAY on the host).  Returns (keypoints, gray8 (F, H, W)) — FAST
    detection input is identical either way.
    """
    f, h, w = frames_bgr.shape[:3]
    gray8 = (
        frames_bgr[..., 0]
        if frames_bgr.shape[-1] == 1
        else bgr_to_gray(frames_bgr)
    )
    keypoints = detect_all_frames(gray8, config, h, w)
    return keypoints, gray8


@functools.partial(jax.jit, static_argnames=("config", "frame_height", "frame_width"))
def pair_velocity_scan(
    keypoints,
    frames_bgr: jnp.ndarray,
    key: jax.Array,
    key_offset: jnp.ndarray,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
):
    """Match+propagate for the F-1 adjacent pairs of a frame block.

    keypoints cover frames [0, F); frames_bgr is (F, H, W, 3) uint8 (the
    tracker consumes BGR like the reference).  Returns
    (velocities (F-1, R+1, C+1, 2), homographies (F-1, 3, 3), ok (F-1,)).
    key_offset keeps per-pair RANSAC seeds unique across chunks.
    """
    num_frames = frames_bgr.shape[0]
    vertex_grid = jnp.asarray(grid.vertex_grid(config, frame_height, frame_width))
    max_level = config.lk_max_level(frame_height, frame_width)
    packed = packed_tile_pyramids(frames_bgr, config, max_level)

    def pair_body(carry, t):
        kps_t = jax.tree.map(lambda a: a[t], keypoints)
        prev_lv = tuple(unpack_level(pk, t) for pk in packed)
        next_lv = tuple(unpack_level(pk, t + 1) for pk in packed)
        match = match_pair(
            kps_t, prev_lv, next_lv,
            jax.random.fold_in(key, t + key_offset), config,
            frame_height, frame_width,
        )
        velocity = vertex_velocities(
            match, vertex_grid, config, frame_height, frame_width
        )
        return carry, (velocity, match.homography, match.ok)

    _, out = jax.lax.scan(pair_body, None, jnp.arange(num_frames - 1))
    return out


def integrate_velocities(velocities: jnp.ndarray, homographies: jnp.ndarray, pair_ok):
    """(F-1) per-pair outputs -> MotionEstimate (cumsum + identity tail)."""
    displacements = jnp.concatenate(
        [
            jnp.zeros((1,) + velocities.shape[1:], velocities.dtype),
            jnp.cumsum(velocities, axis=0),
        ],
        axis=0,
    )
    homographies = jnp.concatenate(
        [homographies, jnp.eye(3, dtype=jnp.float32)[None]], axis=0
    )
    return MotionEstimate(
        displacements=displacements, homographies=homographies, pair_ok=pair_ok
    )


def estimate_motion_scanned(
    keypoints,
    frames_bgr: jnp.ndarray,
    key: jax.Array,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
) -> MotionEstimate:
    """Single-call variant (small clips / tests)."""
    out = pair_velocity_scan(
        keypoints, frames_bgr, key, jnp.asarray(0, jnp.int32), config,
        frame_height, frame_width,
    )
    return integrate_velocities(*out)


def estimate_motion_chunked(
    keypoints,
    frames_bgr: jnp.ndarray,
    key: jax.Array,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
    chunk_pairs: int = 128,
) -> MotionEstimate:
    """Host-driven chunked motion estimation.

    Processes pairs in fixed-size blocks so (a) one compiled scan serves any
    clip length and (b) long clips at high resolution never hold more than
    a chunk of working set.  The final chunk is padded by edge-replicating the
    last frame; padded pairs produce near-identity matches that are sliced
    away before integration.
    """
    num_frames = frames_bgr.shape[0]
    num_pairs = num_frames - 1
    pad = (-num_pairs) % chunk_pairs
    frames_p = jnp.concatenate(
        [frames_bgr, jnp.repeat(frames_bgr[-1:], pad, axis=0)], axis=0
    )
    kps_p = jax.tree.map(
        lambda a: jnp.concatenate([a, jnp.repeat(a[-1:], pad, axis=0)], axis=0),
        keypoints,
    )

    vel_chunks, homo_chunks, ok_chunks = [], [], []
    for start in range(0, num_pairs + pad, chunk_pairs):
        g = jax.lax.dynamic_slice_in_dim(frames_p, start, chunk_pairs + 1, axis=0)
        k = jax.tree.map(
            lambda a: jax.lax.dynamic_slice_in_dim(a, start, chunk_pairs + 1, axis=0),
            kps_p,
        )
        vel, homo, ok = pair_velocity_scan(
            k, g, key, jnp.asarray(start, jnp.int32), config,
            frame_height, frame_width,
        )
        vel_chunks.append(vel)
        homo_chunks.append(homo)
        ok_chunks.append(ok)

    velocities = jnp.concatenate(vel_chunks, axis=0)[:num_pairs]
    homographies = jnp.concatenate(homo_chunks, axis=0)[:num_pairs]
    pair_ok = jnp.concatenate(ok_chunks, axis=0)[:num_pairs]
    return integrate_velocities(velocities, homographies, pair_ok)


def estimate_motion(
    frames_bgr: jnp.ndarray, config: MeshFlowConfig, key: jax.Array
) -> MotionEstimate:
    """Convenience wrapper: frames (F, H, W, 3) uint8 -> MotionEstimate."""
    f, h, w = frames_bgr.shape[:3]
    keypoints, _ = prepare_frames(frames_bgr, config)
    return estimate_motion_scanned(keypoints, frames_bgr, key, config, h, w)
