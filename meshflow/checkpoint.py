"""Checkpoint / resume for the stabilization pipeline (SURVEY.md §5).

The reference has no checkpointing — the whole pipeline is one in-memory
pass (meshflowstabilizer.py:148-169).  Here the expensive state is pass 1
of the streaming pipeline (decode + detect + LK/RANSAC motion over every
frame pair); its outputs are tiny per-stage arrays (SURVEY §5
checkpoint note): displacements (F, V, 2), homographies (F, 3, 3), and
the per-frame keypoints the metric pass reuses.

Persisting them buys two things:

* resume: a killed run restarts at the solver instead of re-estimating
  motion (for a multi-minute 4K clip pass 1 is hours of the reference's
  CPU time);
* variant reuse: motion is independent of adaptive_weights_definition —
  only the solver consumes the variant — so stabilizing the same clip
  under all four variants runs pass 1 once.

The cache key covers the clip identity (path, size, mtime), the frame
geometry, and the motion-relevant config fields; a key mismatch silently
recomputes (a checkpoint is an optimization, never a correctness input).
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from typing import NamedTuple, Optional

import numpy as np

FORMAT_VERSION = 1


class MotionCheckpoint(NamedTuple):
    displacements: np.ndarray  # (F, R+1, C+1, 2) float32
    homographies: np.ndarray  # (F, 3, 3) float32
    pair_ok: np.ndarray  # (F-1,) bool
    kp_positions: np.ndarray  # (F, S, K, 2) float32
    kp_scores: np.ndarray  # (F, S, K) float32
    kp_valid: np.ndarray  # (F, S, K) bool


# Bump when the tracker changes numerically: the checkpoint caches tracker
# outputs, so a stale tracker revision must miss, not silently hit.
# Revision 3: the XLA tracker is the only one (checkpoints keyed to the
# removed Pallas tracker miss).
LK_KERNEL_REVISION = 3


def _tracker_key() -> str:
    """The tracker revision and the selection-matmul precision it runs at
    on this platform: a checkpoint written at another precision misses."""
    from meshflow.kernels import lk

    return f"xla-r{LK_KERNEL_REVISION}-{lk._selection_precision()}"


def _motion_config_key(config) -> str:
    """The config fields pass 1 depends on (solver/render fields excluded),
    plus the tracker key."""
    tracker = _tracker_key()
    fields = (
        tracker,
        config.mesh_row_count,
        config.mesh_col_count,
        config.mesh_outlier_subframe_row_count,
        config.mesh_outlier_subframe_col_count,
        config.feature_ellipse_row_count,
        config.feature_ellipse_col_count,
        config.homography_min_number_corresponding_features,
        config.max_features_per_subframe,
        config.fast_threshold,
        config.lk_max_iterations,
        config.lk_epsilon,
        config.lk_min_eig_threshold,
        config.ransac_iterations,
        config.ransac_polish_rounds,
        config.homography_refine_iterations,
        config.track_planes,
        config.track_downscale,
    )
    return repr(fields)


def cache_path(
    checkpoint_dir: str, input_path: str, config, seed_key: int
) -> str:
    st = os.stat(input_path)
    key = "|".join(
        [
            str(FORMAT_VERSION),
            os.path.abspath(input_path),
            str(st.st_size),
            str(int(st.st_mtime)),
            _motion_config_key(config),
            str(seed_key),
        ]
    )
    digest = hashlib.sha256(key.encode()).hexdigest()[:24]
    return os.path.join(checkpoint_dir, f"motion-{digest}.npz")


def save_motion(path: str, ckpt: MotionCheckpoint) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **ckpt._asdict())
    os.replace(tmp, path)


def load_motion(path: str) -> Optional[MotionCheckpoint]:
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as data:
            return MotionCheckpoint(
                **{name: data[name] for name in MotionCheckpoint._fields}
            )
    except (OSError, KeyError, ValueError, zipfile.BadZipFile):
        return None  # corrupt/partial checkpoint: recompute
