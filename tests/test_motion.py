"""Motion-layer tests: ellipse membership oracle, velocity assembly, and a
stage-parity check against the actual reference implementation
(/root/reference/meshflowstabilizer.py) on a synthetic integer-shift clip.
"""

import math
import sys

import numpy as np
import cv2
import jax
import jax.numpy as jnp
import pytest

from meshflow.config import MeshFlowConfig
from meshflow.motion.features import MatchResult
from meshflow.motion.pipeline import estimate_motion
from meshflow.motion.propagate import ellipse_membership, vertex_velocities
from meshflow.utils.grid import vertex_grid


def _reference_ellipse_oracle(feature_pos, config, h, w):
    """Direct transcription of the reference's loop bounds
    (/root/reference/meshflowstabilizer.py:426-450) for one feature."""
    members = np.zeros((config.vertex_rows, config.vertex_cols), bool)
    fx, fy = feature_pos
    feature_row = (fy / h) * config.mesh_row_count
    feature_col = (fx / w) * config.mesh_col_count
    re, ce = config.feature_ellipse_row_count, config.feature_ellipse_col_count
    top = max(0, math.ceil(feature_row - re / 2))
    bottom = 1 + min(config.mesh_row_count, math.floor(feature_row + re / 2))
    for r in range(top, bottom):
        hw = ce * math.sqrt(max(0.0, 1 / 4 - ((r - feature_row) / re) ** 2))
        left = max(0, math.ceil(feature_col - hw))
        right = 1 + min(config.mesh_col_count, math.floor(feature_col + hw))
        for c in range(left, right):
            members[r, c] = True
    return members


def test_ellipse_membership_matches_reference_loops(rng):
    config = MeshFlowConfig()
    h, w = 360, 640
    pts = rng.uniform(0, [w - 1, h - 1], size=(50, 2)).astype(np.float32)
    member = np.asarray(
        ellipse_membership(jnp.asarray(pts), jnp.ones(50, bool), config, h, w)
    )
    for n in range(50):
        oracle = _reference_ellipse_oracle(pts[n], config, h, w)
        np.testing.assert_array_equal(member[:, :, n], oracle, err_msg=f"feature {n}")


def test_ellipse_membership_invalid_features_excluded(rng):
    config = MeshFlowConfig()
    pts = np.full((4, 2), 320.0, np.float32)
    valid = np.array([True, False, True, False])
    member = np.asarray(ellipse_membership(jnp.asarray(pts), jnp.asarray(valid), config, 360, 640))
    assert member[:, :, 1].sum() == 0 and member[:, :, 3].sum() == 0
    assert member[:, :, 0].sum() > 0


def test_vertex_velocities_pure_translation(rng):
    config = MeshFlowConfig()
    h, w = 360, 640
    n = 200
    early = rng.uniform([50, 50], [w - 50, h - 50], size=(n, 2)).astype(np.float32)
    shift = np.array([4.0, -3.0], np.float32)
    late = early + shift
    hmat = np.eye(3, dtype=np.float32)
    hmat[:2, 2] = shift
    match = MatchResult(
        early=jnp.asarray(early),
        late=jnp.asarray(late),
        inlier=jnp.ones(n, bool),
        homography=jnp.asarray(hmat),
        ok=jnp.asarray(True),
    )
    vg = jnp.asarray(vertex_grid(config, h, w))
    vel = np.asarray(vertex_velocities(match, vg, config, h, w))
    # Pure translation: every vertex moves by exactly the shift.
    np.testing.assert_allclose(vel[..., 0], shift[0], atol=1e-4)
    np.testing.assert_allclose(vel[..., 1], shift[1], atol=1e-4)


def _synthetic_clip(rng, num_frames=8, h=180, w=320, max_shift=12):
    """Integer-shift crops of one textured canvas: ground-truth global
    translations with no resampling error."""
    canvas = rng.integers(0, 256, size=((h + 4 * max_shift) // 6, (w + 4 * max_shift) // 6), dtype=np.uint8)
    canvas = cv2.resize(canvas, (w + 4 * max_shift, h + 4 * max_shift), interpolation=cv2.INTER_NEAREST)
    canvas = cv2.GaussianBlur(canvas, (5, 5), 1.0)
    canvas = cv2.cvtColor(canvas, cv2.COLOR_GRAY2BGR)
    # random-walk integer shifts
    shifts = [np.array([0, 0])]
    for _ in range(num_frames - 1):
        step = rng.integers(-3, 4, size=2)
        shifts.append(np.clip(shifts[-1] + step, -max_shift, max_shift))
    frames = []
    for s in shifts:
        y0 = 2 * max_shift + s[1]
        x0 = 2 * max_shift + s[0]
        frames.append(canvas[y0 : y0 + h, x0 : x0 + w].copy())
    return np.stack(frames), np.array(shifts)


def test_estimate_motion_synthetic_translations(rng):
    config = MeshFlowConfig(max_features_per_subframe=128)
    frames, shifts = _synthetic_clip(rng)
    est = estimate_motion(jnp.asarray(frames), config, jax.random.PRNGKey(0))
    assert bool(np.asarray(est.pair_ok).all())
    disp = np.asarray(est.displacements)
    # canvas shifts by s => scene content moves by -delta(s)
    expected = -(shifts - shifts[0])
    for t in range(len(frames)):
        np.testing.assert_allclose(
            disp[t, 8, 8], expected[t], atol=0.25,
            err_msg=f"frame {t}",
        )
    # homographies: translation component matches per-pair deltas
    homos = np.asarray(est.homographies)
    for t in range(len(frames) - 1):
        np.testing.assert_allclose(
            homos[t][:2, 2], -(shifts[t + 1] - shifts[t]), atol=0.2
        )
    np.testing.assert_array_equal(homos[-1], np.eye(3))


@pytest.mark.slow
def test_stage2_parity_with_reference(rng):
    sys.path.insert(0, "/root/reference")
    import meshflowstabilizer as ref_mod

    frames, _ = _synthetic_clip(rng, num_frames=6)
    ref = ref_mod.MeshFlowStabilizer()
    ref_disp, ref_homos = ref._get_unstabilized_vertex_displacements_and_homographies(
        len(frames), list(frames)
    )

    config = MeshFlowConfig(max_features_per_subframe=512)
    est = estimate_motion(jnp.asarray(frames), config, jax.random.PRNGKey(0))
    disp = np.asarray(est.displacements)

    # Clean synthetic clip: medians agree; displacements within a small
    # tolerance (RANSAC inlier sets and LK quantization differ slightly).
    err = np.abs(disp - ref_disp)
    assert np.median(err) < 0.05, f"median {np.median(err)}"
    assert np.percentile(err, 95) < 0.3, f"p95 {np.percentile(err, 95)}"

    homos = np.asarray(est.homographies)
    herr = np.abs(homos[:, :2, 2] - ref_homos[:, :2, 2]).max()
    assert herr < 0.2, f"translation err {herr}"

