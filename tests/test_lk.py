"""Oracle tests: pyramid + pyramidal LK vs OpenCV.

OpenCV's tracker quantizes windows to Q5 fixed point and bilinear weights to
Q14; ours is float32, so endpoints differ at the 1e-2 px level.  Parity
gates are therefore tolerance-based (SURVEY.md section 7 'hard parts').
"""

import cv2
import numpy as np
import jax.numpy as jnp

from meshflow.kernels.lk import lk_track, prepare_level, scharr_deriv
from meshflow.kernels.pyramid import build_pyramid, pyramid_shapes
from meshflow.synth import synthetic_clip


def _textured(rng, h, w):
    img = rng.integers(0, 256, size=(h // 6, w // 6), dtype=np.uint8)
    img = cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)
    return cv2.GaussianBlur(img, (5, 5), 1.2)


def test_pyramid_matches_pyrdown(rng):
    img = _textured(rng, 120, 160)
    levels = build_pyramid(jnp.asarray(img, jnp.float32), 2)
    ref = img
    for lvl in range(1, 3):
        ref = cv2.pyrDown(ref)
        ours = np.asarray(levels[lvl])
        assert ours.shape == ref.shape
        # pyrDown's fixed-point rounding can differ by 1 at exact halves.
        assert np.abs(ours - ref.astype(np.float32)).max() <= 1.0
        assert (np.abs(ours - ref.astype(np.float32)) > 0).mean() < 0.01


def test_scharr_matches_opencv(rng):
    img = _textured(rng, 64, 80).astype(np.float32)
    gx, gy = scharr_deriv(jnp.asarray(img))
    ref_gx = cv2.Scharr(img, cv2.CV_32F, 1, 0, scale=1.0 / 32.0)
    ref_gy = cv2.Scharr(img, cv2.CV_32F, 0, 1, scale=1.0 / 32.0)
    # Interior must match exactly; cv2.Scharr's default border differs.
    np.testing.assert_allclose(np.asarray(gx)[1:-1, 1:-1], ref_gx[1:-1, 1:-1], atol=1e-3)
    np.testing.assert_allclose(np.asarray(gy)[1:-1, 1:-1], ref_gy[1:-1, 1:-1], atol=1e-3)


def _track_pair(prev_gray, next_gray, pts, max_level):
    prev_pyr = [prepare_level(l) for l in build_pyramid(jnp.asarray(prev_gray, jnp.float32), max_level)]
    next_pyr = [prepare_level(l) for l in build_pyramid(jnp.asarray(next_gray, jnp.float32), max_level)]
    out, status = lk_track(
        tuple(prev_pyr), tuple(next_pyr),
        jnp.asarray(pts, jnp.float32), jnp.ones(len(pts), bool),
    )
    return np.asarray(out), np.asarray(status)


def _cv_track(prev_gray, next_gray, pts, max_level):
    nxt, st, _ = cv2.calcOpticalFlowPyrLK(
        prev_gray, next_gray, pts[:, None, :].astype(np.float32), None,
        maxLevel=max_level,
    )
    return nxt[:, 0, :], st.flatten().astype(bool)


def test_lk_synthetic_translation(rng):
    img = _textured(rng, 180, 240)
    shift = (3.6, -2.4)
    m = np.float32([[1, 0, shift[0]], [0, 1, shift[1]]])
    moved = cv2.warpAffine(img, m, (240, 180))
    det = cv2.FastFeatureDetector_create()
    kps = det.detect(img)
    pts = np.array([k.pt for k in kps], np.float32)
    # stay away from borders where the warp introduces new content
    keep = (pts[:, 0] > 30) & (pts[:, 0] < 200) & (pts[:, 1] > 30) & (pts[:, 1] < 150)
    pts = pts[keep][:200]

    ours, st = _track_pair(img, moved, pts, 2)
    ref, st_cv = _cv_track(img, moved, pts, 2)

    flow = ours[st] - pts[st]
    err = np.linalg.norm(flow - np.array(shift), axis=1)
    assert st.mean() > 0.95
    assert np.median(err) < 0.05
    # agreement with OpenCV endpoints
    both = st & st_cv
    disagreement = np.linalg.norm(ours[both] - ref[both], axis=1)
    assert np.median(disagreement) < 0.05
    assert (disagreement < 0.5).mean() > 0.95


def test_lk_real_frames():
    """Consecutive 640x360 frames of the seeded synthetic clip: parallax
    layers under shake, FAST corners from cv2."""
    f1, f2 = synthetic_clip(2, 360, 640, seed=4)
    g1 = cv2.cvtColor(f1, cv2.COLOR_BGR2GRAY)
    g2 = cv2.cvtColor(f2, cv2.COLOR_BGR2GRAY)
    det = cv2.FastFeatureDetector_create()
    pts = np.array([k.pt for k in det.detect(g1)], np.float32)[:500]

    ours, st = _track_pair(g1, g2, pts, 2)
    ref, st_cv = _cv_track(g1, g2, pts, 2)

    agree = (st == st_cv).mean()
    assert agree > 0.9
    both = st & st_cv
    disagreement = np.linalg.norm(ours[both] - ref[both], axis=1)
    assert np.median(disagreement) < 0.1
    assert (disagreement < 1.0).mean() > 0.9


def test_lk_status_out_of_bounds(rng):
    img = _textured(rng, 120, 160)
    # huge motion pushes the track out of the image
    moved = np.roll(img, 100, axis=1)
    pts = np.array([[150.0, 60.0], [10.0, 10.0]], np.float32)
    ours, st = _track_pair(img, moved, pts, 2)
    assert ours.shape == (2, 2)
    # no crash; status is defined (no assertion on exact values — OpenCV's
    # behavior for failed tracks is content-dependent)


def test_lk_invalid_slots_passthrough(rng):
    img = _textured(rng, 120, 160)
    pts = np.array([[50.0, 50.0], [80.0, 60.0]], np.float32)
    valid = np.array([True, False])
    prev_pyr = tuple(prepare_level(l) for l in build_pyramid(jnp.asarray(img, jnp.float32), 2))
    out, st = lk_track(prev_pyr, prev_pyr, jnp.asarray(pts), jnp.asarray(valid))
    out, st = np.asarray(out), np.asarray(st)
    assert not st[1]
    np.testing.assert_array_equal(out[1], pts[1])
    # tracking an image onto itself converges to the start
    assert st[0]
    np.testing.assert_allclose(out[0], pts[0], atol=0.01)


def test_pyramid_shapes_helper():
    assert pyramid_shapes(90, 160, 2) == [(90, 160), (45, 80), (23, 40)]
