"""meshflow — MeshFlow video stabilization as batched accelerator compute.

A from-scratch JAX/XLA rebuild of the capabilities of the reference
implementation of "MeshFlow: Minimum Latency Online Video Stabilization"
(Liu et al., ECCV 2016): whole-clip stabilization as batched device compute
(corner detection, pyramidal Lucas-Kanade, RANSAC homographies, masked-median
motion propagation, banded Jacobi energy minimization, mesh warping) with
frame-axis sharding across chips, while preserving the reference's public API
(/root/reference/meshflowstabilizer.py:43-169):

    MeshFlowStabilizer(...).stabilize(input_path, output_path,
                                      adaptive_weights_definition=...)
    -> (cropping_ratio, distortion_score, stability_score)
"""

import jax as _jax

# On the GPU, JAX's default float32 matmul/convolution precision is TF32
# (10-bit mantissa, ~1e-3 relative).  This framework's matmuls are
# precision-critical: DLT/SVD/Gauss-Newton solves and the bilinear
# selection contractions of the LK tracker.  Pin the default to full
# float32; hot kernels that can afford bfloat16 opt in explicitly.
_jax.config.update("jax_default_matmul_precision", "highest")

from meshflow.config import (  # noqa: E402,F401
    ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL,
    ADAPTIVE_WEIGHTS_DEFINITION_FLIPPED,
    ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH,
    ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW,
    ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH_VALUE,
    ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW_VALUE,
    MeshFlowConfig,
)

__version__ = "0.1.0"

__all__ = [
    "MeshFlowConfig",
    "MeshFlowStabilizer",
    "ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL",
    "ADAPTIVE_WEIGHTS_DEFINITION_FLIPPED",
    "ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH",
    "ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW",
    "ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH_VALUE",
    "ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW_VALUE",
    "__version__",
]


def __getattr__(name):
    # Lazy import: the api module pulls in the video IO and the whole
    # pipeline, which not every consumer of the kernels needs.
    if name == "MeshFlowStabilizer":
        from meshflow.api import MeshFlowStabilizer

        return MeshFlowStabilizer
    raise AttributeError(f"module 'meshflow' has no attribute {name!r}")
