"""Multi-chip sharding tests on the 8-virtual-device CPU mesh.

Shard-count invariance is this framework's fake-backend analog (SURVEY.md
section 4): the N-shard pipeline must reproduce the 1-shard (single-chip)
result up to float-association noise in the distributed prefix sum.
"""

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from meshflow.config import MeshFlowConfig
from meshflow.parallel.pipeline import (
    frame_sharding,
    make_mesh,
    stabilize_sharded,
)


def _small_config():
    return MeshFlowConfig(
        max_features_per_subframe=64,
        ransac_iterations=64,
        lk_max_iterations=10,
        optimization_num_iterations=20,
    )


def _clip(rng, num_frames, h=96, w=128, max_shift=8):
    canvas = rng.integers(0, 256, size=((h + 4 * max_shift) // 6, (w + 4 * max_shift) // 6), dtype=np.uint8)
    canvas = cv2.resize(canvas, (w + 4 * max_shift, h + 4 * max_shift), interpolation=cv2.INTER_NEAREST)
    canvas = cv2.GaussianBlur(canvas, (3, 3), 0.8)
    canvas = cv2.cvtColor(canvas, cv2.COLOR_GRAY2BGR)
    frames = []
    s = np.array([0, 0])
    for _ in range(num_frames):
        y0, x0 = 2 * max_shift + s[1], 2 * max_shift + s[0]
        frames.append(canvas[y0 : y0 + h, x0 : x0 + w].copy())
        s = np.clip(s + rng.integers(-2, 3, size=2), -max_shift, max_shift)
    return np.stack(frames)


@pytest.mark.slow
def test_shard_count_invariance(rng):
    config = _small_config()
    frames = _clip(rng, 16)
    key = jax.random.PRNGKey(3)

    results = {}
    for n_dev in (1, 4):
        mesh = make_mesh(jax.devices("cpu")[:n_dev])
        sharded = jax.device_put(jnp.asarray(frames), frame_sharding(mesh))
        out = stabilize_sharded(sharded, key, config, 96, 128, mesh)
        cropped, crop, cr, ds, ss = out
        results[n_dev] = (
            np.asarray(cropped),
            np.asarray(crop),
            float(cr),
            float(ds),
            float(ss),
        )

    c1, crop1, cr1, ds1, ss1 = results[1]
    c4, crop4, cr4, ds4, ss4 = results[4]
    # Crop rectangles must agree exactly (integer decisions).
    np.testing.assert_array_equal(crop1, crop4)
    # Metrics agree to float tolerance.
    np.testing.assert_allclose(cr1, cr4, rtol=1e-3)
    np.testing.assert_allclose(ds1, ds4, rtol=1e-3)
    np.testing.assert_allclose(ss1, ss4, rtol=1e-3)
    # Frames agree except bilinear rounding at +-1.
    diff = np.abs(c1.astype(int) - c4.astype(int))
    assert (diff <= 1).mean() > 0.999


@pytest.mark.slow
def test_sharded_runs_on_eight_devices(rng):
    config = _small_config()
    frames = _clip(rng, 16)
    mesh = make_mesh(jax.devices("cpu"))
    assert mesh.shape["frames"] == 8
    sharded = jax.device_put(jnp.asarray(frames), frame_sharding(mesh))
    cropped, crop, cr, ds, ss = stabilize_sharded(
        sharded, jax.random.PRNGKey(0), config, 96, 128, mesh
    )
    assert np.isfinite([cr, ds, ss]).all()
    assert np.asarray(cropped).shape == (16, 96, 128, 3)


@pytest.mark.slow
def test_halo_solver_matches_replicated(rng):
    """Omega-halo sharded Jacobi == replicated solve, 4 shards x 12 frames
    (block > Omega so the halo path actually engages)."""
    config = _small_config()
    frames = _clip(rng, 48)
    key = jax.random.PRNGKey(5)
    mesh = make_mesh(jax.devices("cpu")[:4])
    sharded = jax.device_put(jnp.asarray(frames), frame_sharding(mesh))

    outs = {}
    for mode in ("replicated", "halo"):
        cropped, crop, cr, ds, ss = stabilize_sharded(
            sharded, key, config, 96, 128, mesh, solver_mode=mode
        )
        outs[mode] = (np.asarray(cropped), np.asarray(crop), float(cr), float(ds), float(ss))

    np.testing.assert_array_equal(outs["halo"][0], outs["replicated"][0])
    np.testing.assert_array_equal(outs["halo"][1], outs["replicated"][1])
    assert outs["halo"][2:] == outs["replicated"][2:]


@pytest.mark.slow
def test_multi_clip_batch_matches_sequential(rng, tmp_path):
    """Batched clips across 2 devices produce the same metrics and outputs
    as solo runs (multi-clip batch parallelism, SURVEY §2.3 axis 6)."""
    from meshflow.api import MeshFlowStabilizer
    from meshflow.parallel.batch import BatchJob, stabilize_batch

    clips = []
    for i in range(2):
        path = tmp_path / f"clip{i}.avi"
        frames = _clip(rng, 12)
        writer = cv2.VideoWriter(
            str(path), cv2.VideoWriter_fourcc(*"MJPG"), 30.0, (128, 96)
        )
        for f in frames:
            writer.write(f)
        writer.release()
        clips.append(path)

    config = _small_config()
    solo = []
    for i, path in enumerate(clips):
        m = MeshFlowStabilizer(config=config)
        solo.append(m.stabilize(str(path), str(tmp_path / f"solo{i}.avi"), 0))

    jobs = [
        BatchJob(str(path), str(tmp_path / f"batch{i}.avi"))
        for i, path in enumerate(clips)
    ]
    batched = stabilize_batch(
        jobs, config=config, devices=jax.devices("cpu")[:2]
    )
    assert tuple(solo) == tuple(batched)
