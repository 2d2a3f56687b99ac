"""Mesh-vertex and subframe geometry helpers.

The reference's vertex grid uses a ``ceil`` placement rule
(/root/reference/meshflowstabilizer.py:901-906):
``x = ceil((W-1) * col / C)``, ``y = ceil((H-1) * row / R)``.
"""

from __future__ import annotations

import numpy as np

from meshflow.config import MeshFlowConfig


def vertex_grid(config: MeshFlowConfig, frame_height: int, frame_width: int) -> np.ndarray:
    """Return float32 (vertex_rows, vertex_cols, 2) array of [x, y] pixel
    coordinates of the mesh vertices, matching the reference's ceil rule."""
    rows = np.arange(config.vertex_rows)
    cols = np.arange(config.vertex_cols)
    x = np.ceil((frame_width - 1) * cols / config.mesh_col_count)
    y = np.ceil((frame_height - 1) * rows / config.mesh_row_count)
    xx, yy = np.meshgrid(x, y)  # (vertex_rows, vertex_cols)
    return np.stack([xx, yy], axis=-1).astype(np.float32)


def subframe_offsets(config: MeshFlowConfig, frame_height: int, frame_width: int) -> np.ndarray:
    """Return int32 (num_subframes, 2) array of [x, y] top-left offsets of
    each subframe in the order the reference visits them: outer loop over
    subframe_left_x, inner loop over subframe_top_y
    (/root/reference/meshflowstabilizer.py:503-509)."""
    sub_h, sub_w = config.subframe_shape(frame_height, frame_width)
    offsets = [
        (x, y)
        for x in range(0, frame_width, sub_w)
        for y in range(0, frame_height, sub_h)
    ]
    return np.asarray(offsets, dtype=np.int32)
