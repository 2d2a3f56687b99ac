"""Static configuration for the MeshFlow pipeline.

The reference (``/root/reference/meshflowstabilizer.py:43-99``) stores eleven
hyperparameters as instance attributes on ``MeshFlowStabilizer``.  Here they
live in a frozen, hashable dataclass so the whole pipeline can be traced once
per configuration under ``jax.jit`` (the config is a static argument:
mesh dims, subframe dims, capacities, and iteration counts all determine
array shapes or unrolled loop counts).

Extra fields (feature capacities, RANSAC iteration count, LK iteration count)
have no reference counterpart: they arise because jitted accelerator code needs fixed shapes
where OpenCV returned ragged arrays and ran data-dependent loops.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# Adaptive-weights variants — same names and values as the reference
# (/root/reference/meshflowstabilizer.py:32-40).
ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL = 0
ADAPTIVE_WEIGHTS_DEFINITION_FLIPPED = 1
ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH = 2
ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW = 3

ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH_VALUE = 100
ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW_VALUE = 1

_VALID_DEFINITIONS = (
    ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL,
    ADAPTIVE_WEIGHTS_DEFINITION_FLIPPED,
    ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH,
    ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW,
)


@dataclasses.dataclass(frozen=True)
class MeshFlowConfig:
    """Hashable pipeline configuration (static under jit).

    Defaults mirror the reference constructor
    (/root/reference/meshflowstabilizer.py:43-49).
    """

    # --- reference hyperparameters -------------------------------------
    mesh_row_count: int = 16
    mesh_col_count: int = 16
    mesh_outlier_subframe_row_count: int = 4
    mesh_outlier_subframe_col_count: int = 4
    feature_ellipse_row_count: int = 10
    feature_ellipse_col_count: int = 10
    homography_min_number_corresponding_features: int = 4
    temporal_smoothing_radius: int = 10
    optimization_num_iterations: int = 100
    color_outside_image_area_bgr: Tuple[int, int, int] = (0, 0, 255)
    visualize: bool = False

    # --- accelerator knobs (no reference counterpart) -----------------
    # FAST corner threshold / NMS follow OpenCV FastFeatureDetector_create()
    # defaults (threshold=10, nonmaxSuppression=True, TYPE_9_16).
    fast_threshold: int = 10
    # Fixed per-subframe feature capacity (top-K by FAST score).  OpenCV
    # returns ragged keypoint lists; jitted code needs a static shape.  512 covers
    # the densest subframes of the reference demo suite (~130 mean, a few
    # hundred peak corners per 160x90 subframe).
    max_features_per_subframe: int = 512
    # Lucas-Kanade parameters: OpenCV calcOpticalFlowPyrLK defaults are
    # winSize=(21,21), maxLevel=3, criteria=(30 iters, eps=0.01).  The
    # effective pyramid depth is derived from the subframe size the way
    # OpenCV's buildOpticalFlowPyramid clamps it (see lk_max_level()).
    lk_window_size: int = 21
    lk_max_level_cap: int = 3
    lk_max_iterations: int = 30
    lk_epsilon: float = 0.01
    lk_min_eig_threshold: float = 1e-4
    # Fixed-iteration RANSAC replacing OpenCV's adaptive-iteration RANSAC
    # (cv2.findHomography(method=RANSAC), reproj threshold 3.0).
    ransac_iterations: int = 256
    ransac_reproj_threshold: float = 3.0
    ransac_seed: int = 0
    # LO-RANSAC inlier polish: after the consensus vote, re-estimate the
    # inlier set against the refit model and refit, this many rounds.
    # Different seed draws contract to a common inlier fixed point, which
    # removes most of the seed-to-seed spread of the RANSAC-dependent
    # metrics (measured: video-10/constant-high distortion 5-seed spread
    # 19.1% -> see tests/fixtures/our_seed_variance_*).  OpenCV's RANSAC
    # is internally deterministic so the reference has no spread to match;
    # this knob trades a little extra solver work for estimator stability.
    ransac_polish_rounds: int = 2
    # Gauss-Newton refinement iterations for least-squares homographies
    # (OpenCV refines with an LM solver capped at 10 iterations).
    homography_refine_iterations: int = 10
    # Motion-estimation geometry.  The reference's parity contract lives
    # entirely at its demo resolution (640x360, ~0.23 MP); above ~1 MP the
    # per-pixel stages (FAST, pyramid packing, LK plane loads) dominate the
    # device budget while the mesh the solver smooths stays 16x16.  With
    # track_downscale = d > 1, detection, LK tracking, RANSAC, and the
    # metric tracker all run on d x d box-downscaled frames; the solved
    # vertex displacements scale back by (w/tw, h/th) at the render
    # boundary (exact: the solver is linear in the displacements, and the
    # adaptive weights are invariant under the conjugation
    # H_full = S H_track S^-1, S = diag(sx, sy, 1) — see solver/weights).
    # 0 = auto: the smallest d whose track area fits the track-pixel
    # budget, i.e. d=1 through 480p (~0.41 MP, where full-resolution
    # tracking is already cheap), 2 at 720p, 3 at 1080p, 6 at 4K — the
    # latter three all land at or near the 640x360 demo geometry.
    # 1 = always full resolution (the reference-parity geometry).
    # Affects motion results, so it is part of the motion checkpoint key.
    track_downscale: int = 0
    # Pixel planes the trackers consume.  "bgr" matches the reference,
    # which runs cv2.calcOpticalFlowPyrLK on 3-channel BGR subframes
    # (/root/reference/meshflowstabilizer.py:618-620) — LK gradients and
    # residuals accumulate over the three channels.  "gray" tracks on the
    # exact-cv2 gray plane instead: 3x less host->device transfer and 3x
    # less pyramid/window device work, at the cost of slightly different
    # weak-texture track survival (FAST detection is on gray either way,
    # so keypoints are identical).  Affects motion results, so it is part
    # of the motion checkpoint key.
    track_planes: str = "bgr"
    # Serving mode.  The reference computes its three quality scores
    # inside stabilize() unconditionally — the cropping-ratio/distortion
    # pass re-runs the full feature-match stack between every
    # unstabilized frame and its cropped output
    # (the reference's meshflowstabilizer.py:1195-1197): a second full
    # tracker pass per frame.  Those scores are an EVALUATION artifact: a
    # production serving path only needs the stabilized video.  With
    # compute_metrics = False the cropping/distortion pass (and its host
    # downscales + uploads) is skipped entirely and stabilize() returns
    # NaN for cropping_ratio and distortion_score; stability_score is
    # still returned (it derives from the solver state already in hand,
    # /root/reference/meshflowstabilizer.py:1216-1259, ~free).  The
    # output video is bit-identical either way.
    compute_metrics: bool = True

    def __post_init__(self):
        if self.mesh_row_count < 1 or self.mesh_col_count < 1:
            raise ValueError("mesh dimensions must be positive")
        if self.temporal_smoothing_radius < 1:
            raise ValueError("temporal_smoothing_radius must be positive")
        if self.track_planes not in ("bgr", "gray"):
            raise ValueError("track_planes must be 'bgr' or 'gray'")
        if self.track_downscale < 0:
            raise ValueError("track_downscale must be >= 0 (0 = auto)")

    # Track area the auto policy fits: just above 854x480, so every
    # geometry where full-resolution tracking is already fast (the demo
    # suite's 640x360 included) keeps d=1 and the exact reference
    # geometry; 720p and up downscale to (at or near) 640x360.
    TRACK_PIXEL_BUDGET = int(854 * 480 * 1.05)

    def resolve_track_downscale(self, frame_height: int, frame_width: int) -> int:
        """Concrete box-downscale factor for this frame geometry."""
        if self.track_downscale:
            return self.track_downscale
        d = 1
        while (frame_height // d) * (frame_width // d) > self.TRACK_PIXEL_BUDGET:
            d += 1
        return d

    def track_shape(self, frame_height: int, frame_width: int) -> Tuple[int, int]:
        """(track_height, track_width) the motion stages run at."""
        d = self.resolve_track_downscale(frame_height, frame_width)
        return frame_height // d, frame_width // d

    # --- derived static geometry ---------------------------------------
    @property
    def vertex_rows(self) -> int:
        return self.mesh_row_count + 1

    @property
    def vertex_cols(self) -> int:
        return self.mesh_col_count + 1

    @property
    def num_vertices(self) -> int:
        return self.vertex_rows * self.vertex_cols

    @property
    def num_subframes(self) -> int:
        return (
            self.mesh_outlier_subframe_row_count
            * self.mesh_outlier_subframe_col_count
        )

    @property
    def max_features_per_frame(self) -> int:
        return self.num_subframes * self.max_features_per_subframe

    def subframe_shape(self, frame_height: int, frame_width: int) -> Tuple[int, int]:
        """(height, width) of a subframe, matching the reference's ceil split
        (/root/reference/meshflowstabilizer.py:493-494)."""
        return (
            math.ceil(frame_height / self.mesh_outlier_subframe_row_count),
            math.ceil(frame_width / self.mesh_outlier_subframe_col_count),
        )

    def lk_max_level(self, frame_height: int, frame_width: int) -> int:
        """Effective pyramid max level for LK tracking.

        The reference tracks within subframes, so OpenCV's
        buildOpticalFlowPyramid clamps maxLevel based on the *subframe*
        size: a level is usable only while both dimensions exceed the LK
        window.  We reproduce that clamp from the subframe geometry even
        though our tracker samples whole-frame pyramids.
        """
        sub_h, sub_w = self.subframe_shape(frame_height, frame_width)
        level = 0
        h, w = sub_h, sub_w
        while level < self.lk_max_level_cap:
            h, w = (h + 1) // 2, (w + 1) // 2
            if h <= self.lk_window_size or w <= self.lk_window_size:
                break
            level += 1
        return level


def validate_adaptive_weights_definition(adaptive_weights_definition: int) -> None:
    """Raise the reference's ValueError for invalid variants
    (/root/reference/meshflowstabilizer.py:136-146)."""
    if adaptive_weights_definition not in _VALID_DEFINITIONS:
        raise ValueError(
            "Invalid value for `adaptive_weights_definition`. Expecting value of "
            "`MeshFlowStabilizer.ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL`, "
            "`MeshFlowStabilizer.ADAPTIVE_WEIGHTS_DEFINITION_FLIPPED`, "
            "`MeshFlowStabilizer.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH`, or"
            "`MeshFlowStabilizer.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW`."
        )
