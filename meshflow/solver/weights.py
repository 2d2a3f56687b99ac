"""Adaptive regularization weights (lambda_t) for the energy function.

Reference: /root/reference/meshflowstabilizer.py:786-841.  For the ORIGINAL
and FLIPPED variants, each frame's weight comes from a linear model over two
properties of that frame-pair's global homography (with the bottom row forced
to [0, 0, 1]):

* translational element  = sqrt((H02/W)^2 + (H12/H)^2)
* affine component       = ratio of the two largest eigenvalue magnitudes

    candidate_1 = -1.93 * translational + 0.95
    candidate_2 =  5.83 * affine + 4.88   (ORIGINAL)
                =  5.83 * affine - 4.88   (FLIPPED)
    lambda_t    = max(min(candidate_1, candidate_2), 0)

The last frame's homography is the identity (:274), giving lambda = 0.95 for
both variants.  CONSTANT_HIGH and CONSTANT_LOW are flat 100 / 1 (:836-839).

Everything is batched over frames; the eigen magnitudes come from the
closed-form 2x2 quadratic in kernels.eig3 rather than an iterative solver.
"""

from __future__ import annotations

import jax.numpy as jnp

from meshflow import config as cfg
from meshflow.kernels.eig3 import affine_eigen_ratio


def adaptive_weights(
    homographies: jnp.ndarray,
    frame_width: int,
    frame_height: int,
    adaptive_weights_definition: int,
) -> jnp.ndarray:
    """lambda_t per frame.  homographies: (F, 3, 3) -> (F,) float32."""
    num_frames = homographies.shape[0]
    dtype = homographies.dtype

    if adaptive_weights_definition == cfg.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH:
        return jnp.full(
            (num_frames,), cfg.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH_VALUE, dtype
        )
    if adaptive_weights_definition == cfg.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW:
        return jnp.full(
            (num_frames,), cfg.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW_VALUE, dtype
        )

    translational = jnp.sqrt(
        (homographies[:, 0, 2] / frame_width) ** 2
        + (homographies[:, 1, 2] / frame_height) ** 2
    )
    affine = affine_eigen_ratio(homographies)

    candidate_1 = -1.93 * translational + 0.95
    if adaptive_weights_definition == cfg.ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL:
        candidate_2 = 5.83 * affine + 4.88
    else:  # FLIPPED
        candidate_2 = 5.83 * affine - 4.88

    return jnp.maximum(jnp.minimum(candidate_1, candidate_2), 0.0)
