"""Oracle tests: homography kernels vs OpenCV / NumPy."""

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from meshflow.kernels.homography import (
    apply_homography,
    dlt_homography,
    estimate_homography,
    ransac_homography,
)


def random_homography(rng, scale=0.15):
    h = np.eye(3)
    h[:2, :2] += rng.normal(scale=scale, size=(2, 2))
    h[:2, 2] = rng.normal(scale=20.0, size=2)
    h[2, :2] = rng.normal(scale=1e-4, size=2)
    return h


def project(h, pts):
    p = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ h.T
    return p[:, :2] / p[:, 2:3]


def test_apply_homography_matches_cv2(rng):
    h = random_homography(rng)
    pts = rng.uniform(0, 640, size=(50, 2)).astype(np.float32)
    ours = np.asarray(apply_homography(jnp.asarray(h, jnp.float32), jnp.asarray(pts)))
    ref = cv2.perspectiveTransform(pts[:, None, :], h)[:, 0, :]
    np.testing.assert_allclose(ours, ref, atol=1e-2)


def test_dlt_exact_on_noiseless_points(rng):
    h = random_homography(rng)
    pts = rng.uniform(0, 640, size=(30, 2)).astype(np.float32)
    pts2 = project(h, pts).astype(np.float32)
    ours = np.asarray(
        dlt_homography(jnp.asarray(pts), jnp.asarray(pts2), jnp.ones(30, jnp.float32))
    )
    # Compare reprojection, not matrix entries (scale/sign free).
    reproj = project(ours.astype(np.float64), pts)
    np.testing.assert_allclose(reproj, pts2, atol=0.05)


def test_dlt_four_points_exact(rng):
    # The per-cell homography case: exactly 4 correspondences
    # (/root/reference/meshflowstabilizer.py:1041-1042).
    for _ in range(10):
        h = random_homography(rng)
        pts = np.array([[0, 0], [40, 0], [0, 23], [40, 23]], np.float32)
        pts += rng.normal(scale=3.0, size=pts.shape).astype(np.float32)
        pts2 = project(h, pts).astype(np.float32)
        ours = np.asarray(
            dlt_homography(jnp.asarray(pts), jnp.asarray(pts2), jnp.ones(4, jnp.float32))
        )
        reproj = project(ours.astype(np.float64), pts)
        np.testing.assert_allclose(reproj, pts2, atol=0.05)


def test_estimate_matches_cv2_least_squares_noisy(rng):
    h = random_homography(rng)
    pts = rng.uniform(0, 640, size=(100, 2)).astype(np.float32)
    pts2 = (project(h, pts) + rng.normal(scale=0.5, size=(100, 2))).astype(np.float32)
    ours = np.asarray(
        estimate_homography(jnp.asarray(pts), jnp.asarray(pts2), jnp.ones(100, jnp.float32))
    )
    ref, _ = cv2.findHomography(pts[:, None], pts2[:, None])
    # Both minimize geometric error; compare their actions on a grid.
    grid = np.stack(
        np.meshgrid(np.linspace(0, 640, 9), np.linspace(0, 360, 9)), -1
    ).reshape(-1, 2)
    np.testing.assert_allclose(
        project(ours.astype(np.float64), grid), project(ref, grid), atol=0.2
    )


def test_masked_points_are_ignored(rng):
    h = random_homography(rng)
    pts = rng.uniform(0, 640, size=(40, 2)).astype(np.float32)
    pts2 = project(h, pts).astype(np.float32)
    # Corrupt masked-out rows badly.
    pts2_bad = pts2.copy()
    pts2_bad[30:] += 500.0
    w = np.ones(40, np.float32)
    w[30:] = 0.0
    ours = np.asarray(
        estimate_homography(jnp.asarray(pts), jnp.asarray(pts2_bad), jnp.asarray(w))
    )
    reproj = project(ours.astype(np.float64), pts[:30])
    np.testing.assert_allclose(reproj, pts2[:30], atol=0.05)


def test_ransac_rejects_outliers(rng):
    h = random_homography(rng)
    n, n_out = 120, 40
    pts = rng.uniform(0, 640, size=(n, 2)).astype(np.float32)
    pts2 = project(h, pts).astype(np.float32)
    pts2 += rng.normal(scale=0.3, size=pts2.shape).astype(np.float32)
    outlier_rows = rng.choice(n, size=n_out, replace=False)
    pts2[outlier_rows] += rng.uniform(30, 200, size=(n_out, 2)).astype(np.float32)
    valid = np.ones(n, bool)

    hh, mask, ok = ransac_homography(
        jnp.asarray(pts), jnp.asarray(pts2), jnp.asarray(valid),
        jax.random.PRNGKey(0),
    )
    hh, mask, ok = np.asarray(hh), np.asarray(mask), bool(ok)
    assert ok
    # All true outliers rejected; most inliers kept.
    assert not mask[outlier_rows].any()
    inlier_rows = np.setdiff1d(np.arange(n), outlier_rows)
    assert mask[inlier_rows].mean() > 0.9
    reproj = project(hh.astype(np.float64), pts[inlier_rows])
    err = np.linalg.norm(reproj - pts2[inlier_rows], axis=1)
    assert np.median(err) < 1.0


def test_ransac_polish_contracts_seed_spread(rng):
    """LO-RANSAC polish rounds collapse the seed-to-seed model spread.

    The distortion metric is a MIN over frames of a RANSAC-dependent
    eigenvalue ratio (/root/reference/meshflowstabilizer.py:1206-1212), so
    per-draw model wobble propagates straight into the video-level value.
    With polish, draws whose initial consensus sets differ re-estimate the
    inlier set against the refit model and converge to a common fixed
    point.  Use a hard instance (noisy inliers + structured outliers) so
    the unpolished spread is visible."""
    h = random_homography(rng)
    n, n_out = 96, 40
    pts = rng.uniform(0, 640, size=(n, 2)).astype(np.float32)
    pts2 = project(h, pts).astype(np.float32)
    pts2 += rng.normal(scale=1.5, size=pts2.shape).astype(np.float32)
    outlier_rows = rng.choice(n, size=n_out, replace=False)
    # Structured outliers (a coherent shift) create competing consensus sets.
    pts2[outlier_rows] += np.float32([14.0, -11.0])
    valid = np.ones(n, bool)

    def spread(polish_rounds):
        models = []
        for seed in range(8):
            hh, _, ok = ransac_homography(
                jnp.asarray(pts), jnp.asarray(pts2), jnp.asarray(valid),
                jax.random.PRNGKey(seed), iterations=64,
                polish_rounds=polish_rounds,
            )
            assert bool(ok)
            models.append(np.asarray(hh).ravel())
        models = np.stack(models)
        return float(np.max(np.ptp(models, axis=0)))

    s0, s2 = spread(0), spread(2)
    assert s2 <= s0 * 0.5 + 1e-6, (s0, s2)


def test_ransac_handles_too_few_points():
    pts = np.zeros((16, 2), np.float32)
    valid = np.zeros(16, bool)
    valid[:3] = True  # fewer than 4 valid
    h, mask, ok = ransac_homography(
        jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(valid), jax.random.PRNGKey(0)
    )
    assert not bool(ok)
    assert not np.asarray(mask).any()
    np.testing.assert_array_equal(np.asarray(h), np.eye(3, dtype=np.float32))


def test_ransac_padding_rows_never_inliers(rng):
    h = random_homography(rng)
    pts = np.zeros((64, 2), np.float32)
    pts[:20] = rng.uniform(0, 640, size=(20, 2)).astype(np.float32)
    pts2 = pts.copy()
    pts2[:20] = project(h, pts[:20]).astype(np.float32)
    valid = np.zeros(64, bool)
    valid[:20] = True
    _, mask, ok = ransac_homography(
        jnp.asarray(pts), jnp.asarray(pts2), jnp.asarray(valid), jax.random.PRNGKey(1)
    )
    assert bool(ok)
    assert not np.asarray(mask)[20:].any()


def test_sample_distinct4_uniform_no_repeats():
    """Draws are distinct within each 4-tuple and uniform over [0, m)."""
    from meshflow.kernels.homography import _sample_distinct4

    m = 7  # awkward size: the old `raw % m` scheme was visibly biased here
    iters = 20000
    draws = np.asarray(
        _sample_distinct4(jax.random.PRNGKey(3), iters, jnp.asarray(m))
    )
    assert draws.min() >= 0 and draws.max() < m
    # no repeated index within any 4-sample
    assert all(len(set(row)) == 4 for row in draws)
    # marginal uniformity: each value appears ~ iters*4/m times
    counts = np.bincount(draws.ravel(), minlength=m)
    expected = iters * 4 / m
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    # chi-square with m-1=6 dof; 99.9th percentile ~= 22.5
    assert chi2 < 22.5, counts
