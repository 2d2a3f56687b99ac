"""Median filters for vertex-velocity fields.

Two medians appear in the reference's motion propagation
(/root/reference/meshflowstabilizer.py:338-360):

1. Per-vertex median over a variable-length list of nearby-feature residual
   velocities (``statistics.median``; even counts average the two middle
   elements; empty lists yield 0).  On the accelerator the ragged lists become a masked
   fixed-capacity matrix and the median is read off a sort.
2. A 3x3 spatial median (``cv2.medianBlur`` on float32, which uses
   BORDER_REPLICATE) over the (rows+1, cols+1) velocity field.
"""

from __future__ import annotations

import jax.numpy as jnp


def masked_median(values: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Median over masked entries along the last axis.

    values: (..., N) float; mask: (..., N) bool.
    Returns (...,) with statistics.median semantics: the average of the two
    middle elements for even counts, 0.0 where the mask is empty
    (/root/reference/meshflowstabilizer.py:340-353).
    """
    big = jnp.asarray(jnp.inf, values.dtype)
    filled = jnp.where(mask, values, big)
    s = jnp.sort(filled, axis=-1)
    count = jnp.sum(mask, axis=-1)
    lo = jnp.maximum((count - 1) // 2, 0)
    hi = jnp.maximum(count // 2, 0)
    lo_v = jnp.take_along_axis(s, lo[..., None], axis=-1)[..., 0]
    hi_v = jnp.take_along_axis(s, hi[..., None], axis=-1)[..., 0]
    med = 0.5 * (lo_v + hi_v)
    return jnp.where(count > 0, med, jnp.zeros_like(med))


def median3x3(field: jnp.ndarray) -> jnp.ndarray:
    """3x3 spatial median with replicated borders on the last two axes.

    field: (..., H, W).  Matches cv2.medianBlur(float32 input, ksize=3),
    whose border mode is BORDER_REPLICATE
    (/root/reference/meshflowstabilizer.py:359-360).
    """
    padded = jnp.pad(
        field,
        [(0, 0)] * (field.ndim - 2) + [(1, 1), (1, 1)],
        mode="edge",
    )
    h, w = field.shape[-2], field.shape[-1]
    neighbors = [
        padded[..., dy : dy + h, dx : dx + w]
        for dy in range(3)
        for dx in range(3)
    ]
    stacked = jnp.stack(neighbors, axis=-1)  # (..., H, W, 9)
    return jnp.sort(stacked, axis=-1)[..., 4]
