"""Oracle tests: closed-form affine eigen magnitudes vs np.linalg.eigvals."""

import numpy as np
import jax.numpy as jnp

from meshflow.kernels.eig3 import affine_eigen_ratio, affine_eigenvalue_magnitudes


def _oracle(h):
    a = h.copy().astype(np.float64)
    a[2] = [0, 0, 1]
    return np.sort(np.abs(np.linalg.eigvals(a)))


def test_magnitudes_match_numpy(rng):
    for _ in range(200):
        h = np.eye(3)
        h[:2, :] = rng.normal(scale=1.0, size=(2, 3))
        h[2, :2] = rng.normal(scale=1e-3, size=2)  # ignored (affine part)
        ours = np.asarray(affine_eigenvalue_magnitudes(jnp.asarray(h, jnp.float32)))
        ref = _oracle(h)
        np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


def test_complex_pair(rng):
    # Rotation-like matrices have complex eigenvalues.
    theta = 0.7
    h = np.eye(3)
    h[:2, :2] = 1.3 * np.array(
        [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
    )
    ours = np.asarray(affine_eigenvalue_magnitudes(jnp.asarray(h, jnp.float32)))
    np.testing.assert_allclose(ours, _oracle(h), rtol=1e-5)


def test_ratio_matches_reference_formula(rng):
    for _ in range(50):
        h = np.eye(3)
        h[:2, :] = np.eye(2, 3) + rng.normal(scale=0.1, size=(2, 3))
        mags = _oracle(h)
        ref_ratio = mags[-2] / mags[-1]
        ours = float(affine_eigen_ratio(jnp.asarray(h, jnp.float32)))
        np.testing.assert_allclose(ours, ref_ratio, rtol=1e-4, atol=1e-5)


def test_identity_gives_ratio_one():
    # The last frame's identity homography => affine component 1
    # (/root/reference/meshflowstabilizer.py:274 feeding :824).
    assert float(affine_eigen_ratio(jnp.eye(3, dtype=jnp.float32))) == 1.0
