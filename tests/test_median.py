"""Oracle tests: masked median vs statistics.median, 3x3 median vs cv2.medianBlur."""

import statistics

import cv2
import numpy as np
import jax.numpy as jnp

from meshflow.kernels.median import masked_median, median3x3


def test_masked_median_matches_statistics(rng):
    for _ in range(100):
        n = 32
        count = int(rng.integers(0, n + 1))
        values = rng.normal(size=n).astype(np.float32)
        mask = np.zeros(n, bool)
        mask[rng.choice(n, size=count, replace=False)] = True
        ours = float(masked_median(jnp.asarray(values), jnp.asarray(mask)))
        if count == 0:
            assert ours == 0.0
        else:
            ref = statistics.median([float(v) for v in values[mask]])
            np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)


def test_masked_median_batched(rng):
    values = rng.normal(size=(17, 17, 40)).astype(np.float32)
    mask = rng.random((17, 17, 40)) < 0.3
    ours = np.asarray(masked_median(jnp.asarray(values), jnp.asarray(mask)))
    for r in range(17):
        for c in range(17):
            sel = values[r, c][mask[r, c]]
            ref = statistics.median(sel.tolist()) if len(sel) else 0.0
            np.testing.assert_allclose(ours[r, c], ref, rtol=1e-6, atol=1e-7)


def test_median3x3_matches_cv2(rng):
    # The reference applies cv2.medianBlur(ksize=3) to the float32 velocity
    # field (/root/reference/meshflowstabilizer.py:359-360).
    field = rng.normal(size=(17, 17)).astype(np.float32)
    ours = np.asarray(median3x3(jnp.asarray(field)))
    ref = cv2.medianBlur(field, 3)
    np.testing.assert_array_equal(ours, ref)


def test_median3x3_batch(rng):
    fields = rng.normal(size=(5, 17, 17)).astype(np.float32)
    ours = np.asarray(median3x3(jnp.asarray(fields)))
    for i in range(5):
        np.testing.assert_array_equal(ours[i], cv2.medianBlur(fields[i], 3))
