"""Seeded synthetic clips: textured parallax layers under a known shake.

The test suite, chip_smoke.py and the benchmark need real-looking input at
any resolution without shipping video files.  A clip here is two textured
layers seen by a shaking camera:

* a far layer that moves by half the camera offset,
* a near band across the lower third that moves by the full camera offset
  plus a slow drift of its own (parallax: no single homography explains
  both layers, as in handheld footage),

where the camera offset per frame is a slow pan, a low-frequency sway and
seeded high-frequency jitter (shake_path).  Offsets are whole pixels, so a
frame is two slices of precomputed canvases and a 1080p clip costs a few
milliseconds per frame to make.  Texture is blurred blocks sized with the
frame (6 px at 360 lines): corners FAST detects and windows LK tracks, at
every resolution and after the track geometry's box downscale.
"""

from __future__ import annotations

import numpy as np


def shake_path(num_frames: int, height: int, seed: int = 0) -> np.ndarray:
    """(F, 2) integer camera offsets [x, y] in pixels: pan + sway + jitter,
    scaled with the frame height (360 lines = 1)."""
    rng = np.random.default_rng(seed)
    scale = height / 360.0
    t = np.arange(num_frames, dtype=np.float64)
    phase = rng.uniform(0.0, 2.0 * np.pi, size=2)
    pan = np.stack([0.5 * t, 0.1 * t], axis=1)
    sway = 4.0 * np.stack(
        [np.sin(2 * np.pi * t / 45 + phase[0]), np.sin(2 * np.pi * t / 60 + phase[1])],
        axis=1,
    )
    jitter = rng.normal(0.0, 2.0, size=(num_frames, 2))
    return np.round((pan + sway + jitter) * scale).astype(np.int64)


def _blocks(rng, height: int, width: int, block: int, channels: int):
    """(H, W, channels) float32 uniform [0, 1) random blocks."""
    bh, bw = -(-height // block), -(-width // block)
    small = rng.uniform(0.0, 1.0, size=(bh, bw, channels)).astype(np.float32)
    return np.repeat(np.repeat(small, block, axis=0), block, axis=1)[:height, :width]


def _blur(img: np.ndarray, passes: int) -> np.ndarray:
    """[1 2 1] / 4 blur along both axes, edge-clamped, `passes` times."""
    for axis in (0, 1):
        n = img.shape[axis]
        for _ in range(passes):
            lo = np.concatenate([img.take([0], axis), img], axis=axis)
            hi = np.concatenate([img, img.take([-1], axis)], axis=axis)
            img = 0.5 * img + 0.25 * (
                lo.take(range(n), axis) + hi.take(range(1, n + 1), axis)
            )
    return img


def _texture(rng, height: int, width: int, block: int) -> np.ndarray:
    """(H, W, 3) uint8: blurred random blocks with correlated channels,
    under a coarse contrast field so that some regions are nearly flat
    (few corners) and others busy, as in real footage."""
    detail = 0.7 * _blocks(rng, height, width, block, 1) + 0.3 * _blocks(
        rng, height, width, block, 3
    )
    # Contrast varies per detail block, smoothly over ~8 blocks.
    bh, bw = -(-height // block), -(-width // block)
    gain = _blur(_blocks(rng, bh, bw, 8, 1), 4)
    gain = np.repeat(np.repeat(gain, block, axis=0), block, axis=1)
    gain = gain[:height, :width]
    img = 128.0 + 255.0 * (detail - 0.5) * (0.1 + 0.9 * gain)
    return np.clip(np.round(_blur(img, 2)), 0, 255).astype(np.uint8)


def synthetic_clip(
    num_frames: int, height: int, width: int, seed: int = 0
) -> np.ndarray:
    """(F, H, W, 3) uint8 BGR clip of num_frames under shake_path(seed)."""
    rng = np.random.default_rng(seed + 1)
    block = max(2, round(6 * height / 360))
    cam = shake_path(num_frames, height, seed)
    far = cam // 2
    drift = np.round(
        np.arange(num_frames)[:, None] * np.array([0.4, 0.0]) * height / 360
    ).astype(np.int64)
    near = cam + drift

    def canvas_for(offsets):
        lo = offsets.min(axis=0)
        hi = offsets.max(axis=0)
        tex = _texture(
            rng, height + int(hi[1] - lo[1]), width + int(hi[0] - lo[0]), block
        )
        return tex, lo

    far_tex, far_lo = canvas_for(far)
    near_tex, near_lo = canvas_for(near)
    band0 = 2 * height // 3
    frames = np.empty((num_frames, height, width, 3), np.uint8)
    for t in range(num_frames):
        fx, fy = far[t] - far_lo
        frames[t] = far_tex[fy : fy + height, fx : fx + width]
        nx, ny = near[t] - near_lo
        frames[t, band0:] = near_tex[ny + band0 : ny + height, nx : nx + width]
    return frames
