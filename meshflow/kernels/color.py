"""Color conversion matching OpenCV bit-for-bit.

The reference feeds BGR frames straight into the FAST detector
(/root/reference/meshflowstabilizer.py:613); OpenCV converts to gray
internally with its fixed-point BGR2GRAY.  This OpenCV (5.0) quantizes the
BT.601 weights at shift 15: G and R rounded (19235, 9798) and B as the
remainder (3735) so the three sum to 2^15, with round-half-up descaling
(verified exhaustively against cv2.cvtColor).  FAST thresholds are sensitive
to off-by-one gray values, so the conversion must be exact, not float.
"""

from __future__ import annotations

import jax.numpy as jnp

_R2Y = 9798
_G2Y = 19235
_B2Y = 3735
_SHIFT = 15


def bgr_to_gray(bgr: jnp.ndarray) -> jnp.ndarray:
    """uint8 BGR (..., 3) -> uint8 gray (...), identical to
    cv2.cvtColor(img, cv2.COLOR_BGR2GRAY).  Takes NumPy or JAX arrays and
    returns the same kind (the host gray planes use it too)."""
    b = bgr[..., 0].astype(jnp.int32)
    g = bgr[..., 1].astype(jnp.int32)
    r = bgr[..., 2].astype(jnp.int32)
    y = (b * _B2Y + g * _G2Y + r * _R2Y + (1 << (_SHIFT - 1))) >> _SHIFT
    return y.astype(jnp.uint8)


def bgr_to_gray_f32(bgr: jnp.ndarray) -> jnp.ndarray:
    """float32 gray in [0, 255] from uint8 BGR, via the exact uint8 path."""
    return bgr_to_gray(bgr).astype(jnp.float32)


def gray_of_bgr_color(bgr: tuple) -> int:
    """Python-side exact gray of one (B, G, R) uint8 triple — the border
    color a gray-plane warp must use so border pixels equal
    bgr_to_gray(warped-BGR border) exactly."""
    b, g, r = (int(v) for v in bgr)
    return (b * _B2Y + g * _G2Y + r * _R2Y + (1 << (_SHIFT - 1))) >> _SHIFT
