"""Fast multichip smoke (default test tier).

The full shard-invariance suite (test_sharding.py) is slow-tier; this
reuses the dryrun's tiny geometry (96x128, truncated config) so every
default `pytest -m "not slow"` run still compiles and executes the
frame-sharded pipeline — ppermute halo, distributed prefix sum, Omega-halo
Jacobi, collective crop/metric reductions — on a 2-device mesh.
"""

import numpy as np
import jax
import jax.numpy as jnp

from meshflow.config import MeshFlowConfig
from meshflow.parallel.pipeline import (
    frame_sharding,
    make_mesh,
    stabilize_sharded,
)


def _tiny_config():
    return MeshFlowConfig(
        max_features_per_subframe=64,
        ransac_iterations=64,
        lk_max_iterations=10,
        optimization_num_iterations=20,
    )


def _tiny_frames(rng, num_frames, h=96, w=128):
    base = rng.integers(0, 256, size=(h // 4 + 8, w // 4 + 8), dtype=np.uint8)
    canvas = np.kron(base, np.ones((4, 4), np.uint8)).astype(np.float32)
    for _ in range(1):
        for axis in (0, 1):
            canvas = (
                0.25 * np.roll(canvas, 1, axis)
                + 0.5 * canvas
                + 0.25 * np.roll(canvas, -1, axis)
            )
    canvas = canvas.astype(np.uint8)
    frames = []
    for t in range(num_frames):
        dy = int(round(4 + 2 * np.sin(0.7 * t)))
        dx = int(round(6 + 3 * np.sin(0.4 * t + 1.0)))
        frames.append(canvas[dy : dy + h, dx : dx + w])
    frames = np.stack(frames).astype(np.uint8)
    return np.repeat(frames[..., None], 3, axis=-1)


def test_sharded_pipeline_smoke(rng):
    """2 shards x 12 frames: > Omega per shard so the halo solver engages."""
    config = _tiny_config()
    h, w = 96, 128
    frames = _tiny_frames(rng, 24, h, w)
    mesh = make_mesh(jax.devices("cpu")[:2])
    sharded = jax.device_put(jnp.asarray(frames), frame_sharding(mesh))
    cropped, crop, cr, ds, ss = stabilize_sharded(
        sharded, jax.random.PRNGKey(0), config, h, w, mesh
    )
    crop = np.asarray(crop)
    assert np.asarray(cropped).shape == (24, h, w, 3)
    assert np.isfinite([float(cr), float(ds), float(ss)]).all()
    assert 0 <= crop[0] <= crop[2] < w
    assert 0 <= crop[1] <= crop[3] < h


def test_sharded_serving_mode(rng):
    """compute_metrics=False prunes the metric tracker from the sharded
    program: identical cropped pixels and crop window, NaN scores."""
    import dataclasses

    config = _tiny_config()
    h, w = 96, 128
    frames = _tiny_frames(rng, 24, h, w)
    mesh = make_mesh(jax.devices("cpu")[:2])
    sharded = jax.device_put(jnp.asarray(frames), frame_sharding(mesh))
    key = jax.random.PRNGKey(0)
    cropped, crop, cr, ds, ss = stabilize_sharded(
        sharded, key, config, h, w, mesh
    )
    serve_cfg = dataclasses.replace(config, compute_metrics=False)
    cropped2, crop2, cr2, ds2, ss2 = stabilize_sharded(
        sharded, key, serve_cfg, h, w, mesh
    )
    np.testing.assert_array_equal(np.asarray(cropped), np.asarray(cropped2))
    np.testing.assert_array_equal(np.asarray(crop), np.asarray(crop2))
    assert np.isnan(float(cr2)) and np.isnan(float(ds2))
    assert float(ss2) == float(ss)
