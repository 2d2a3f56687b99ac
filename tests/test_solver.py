"""Oracle tests for the banded Jacobi solver and adaptive weights.

The dense oracle below re-derives the reference's system from its documented
equations (SURVEY.md section 2.1 rows 13-15): Gaussian weights
w_{t,r} = exp(-((3/Omega)(t-r))^2), off-diagonal A = -2 diag(lambda) W
band-masked to |t-r| <= Omega (band mask INCLUDES the main diagonal), and
on-diagonal D = 1 + 2 lambda_t * (full, unmasked row sum).  Iteration:
x <- (b - A_off x) / D, x0 = b, fixed iteration count.
"""

import numpy as np
import jax.numpy as jnp

from meshflow import config as cfg
from meshflow.solver.jacobi import jacobi_smooth, on_diagonal
from meshflow.solver.weights import adaptive_weights


def dense_jacobi_oracle(b, lambdas, omega, iterations):
    f = len(lambdas)
    t, r = np.indices((f, f))
    w = np.exp(-np.square((3.0 / omega) * (t - r)))
    combined = np.diag(lambdas) @ w
    off = -2.0 * combined
    band = np.abs(t - r) <= omega  # includes the diagonal
    off = np.where(band, off, 0.0)
    diag = 1.0 + 2.0 * np.sum(combined, axis=1)
    x = b.copy()
    inv_diag = (1.0 / diag).reshape((f,) + (1,) * (b.ndim - 1))
    for _ in range(iterations):
        x = inv_diag * (b - np.tensordot(off, x, axes=(1, 0)))
    return x


def test_on_diagonal_matches_full_row_sum(rng):
    f, omega = 97, 10
    lambdas = rng.uniform(0, 100, f)
    t, r = np.indices((f, f))
    w = np.exp(-np.square((3.0 / omega) * (t - r)))
    ref = 1.0 + 2.0 * lambdas * w.sum(axis=1)
    ours = np.asarray(on_diagonal(jnp.asarray(lambdas, jnp.float32), omega))
    np.testing.assert_allclose(ours, ref, rtol=3e-6)


def test_windowed_row_sum_radius_is_exact():
    # The implementation windows the reference's full row sum; terms beyond
    # radius ceil(omega*sqrt(745)/3) underflow to zero even in float64, so
    # the windowing is exact, not an approximation.
    omega = 10
    radius = int(np.ceil(omega * np.sqrt(745.0) / 3.0))
    tail = np.exp(-(((3.0 / omega) * (radius + 1)) ** 2))
    assert tail == 0.0


def test_jacobi_matches_dense_oracle(rng):
    f, omega, iters = 60, 10, 100
    lambdas = rng.uniform(0.0, 10.0, f)
    b = rng.normal(scale=20.0, size=(f, 5, 2))
    ref = dense_jacobi_oracle(b, lambdas, omega, iters)
    ours = np.asarray(
        jacobi_smooth(jnp.asarray(b, jnp.float32), jnp.asarray(lambdas, jnp.float32),
                      omega, iters)
    )
    np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-4)


def test_jacobi_constant_high_weights(rng):
    # lambda = 100 stresses the iteration (largest off-diag/diag ratio).
    f, omega, iters = 48, 10, 100
    lambdas = np.full(f, 100.0)
    b = rng.normal(scale=50.0, size=(f, 3, 2))
    ref = dense_jacobi_oracle(b, lambdas, omega, iters)
    ours = np.asarray(
        jacobi_smooth(jnp.asarray(b, jnp.float32), jnp.asarray(lambdas, jnp.float32),
                      omega, iters)
    )
    np.testing.assert_allclose(ours, ref, rtol=3e-4, atol=3e-4)


def test_jacobi_short_sequence(rng):
    # F smaller than the band width exercises the padding edges.
    f, omega, iters = 8, 10, 50
    lambdas = rng.uniform(0, 5, f)
    b = rng.normal(size=(f, 2, 2))
    ref = dense_jacobi_oracle(b, lambdas, omega, iters)
    ours = np.asarray(
        jacobi_smooth(jnp.asarray(b, jnp.float32), jnp.asarray(lambdas, jnp.float32),
                      omega, iters)
    )
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


def _weights_oracle(homographies, w, h, definition):
    # Reimplements /root/reference/meshflowstabilizer.py:812-841 semantics.
    f = len(homographies)
    affine = homographies.copy()
    affine[:, 2, :] = [0, 0, 1]
    out = np.empty(f)
    for i in range(f):
        mags = np.sort(np.abs(np.linalg.eigvals(affine[i])))
        trans = np.sqrt((affine[i][0, 2] / w) ** 2 + (affine[i][1, 2] / h) ** 2)
        ratio = mags[-2] / mags[-1]
        c1 = -1.93 * trans + 0.95
        c2 = 5.83 * ratio + (4.88 if definition == 0 else -4.88)
        out[i] = max(min(c1, c2), 0)
    return out


def test_adaptive_weights_original_and_flipped(rng):
    f = 30
    homos = np.tile(np.eye(3), (f, 1, 1))
    homos[:, :2, :] += rng.normal(scale=0.05, size=(f, 2, 3))
    homos[:, :2, 2] += rng.normal(scale=10.0, size=(f, 2))
    homos[-1] = np.eye(3)
    for definition in (cfg.ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL,
                       cfg.ADAPTIVE_WEIGHTS_DEFINITION_FLIPPED):
        ref = _weights_oracle(homos, 640, 360, definition)
        ours = np.asarray(
            adaptive_weights(jnp.asarray(homos, jnp.float32), 640, 360, definition)
        )
        np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


def test_adaptive_weights_constants():
    homos = jnp.tile(jnp.eye(3, dtype=jnp.float32), (5, 1, 1))
    hi = adaptive_weights(homos, 640, 360, cfg.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH)
    lo = adaptive_weights(homos, 640, 360, cfg.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW)
    assert np.all(np.asarray(hi) == 100.0)
    assert np.all(np.asarray(lo) == 1.0)


def test_identity_last_frame_weight():
    # Identity homography => translational 0, affine ratio 1 =>
    # ORIGINAL: min(0.95, 10.71) = 0.95; FLIPPED: min(0.95, 0.95) = 0.95.
    homos = jnp.eye(3, dtype=jnp.float32)[None]
    for definition in (0, 1):
        w = float(adaptive_weights(homos, 640, 360, definition)[0])
        np.testing.assert_allclose(w, 0.95, rtol=1e-6)
