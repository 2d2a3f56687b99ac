"""Online sliding-window stabilizer tests."""

import cv2
import numpy as np
import pytest

from meshflow.config import MeshFlowConfig
from meshflow.online import OnlineMeshFlowStabilizer


def _clip(rng, num_frames, h=96, w=128, max_shift=6):
    canvas = rng.integers(0, 256, size=((h + 4 * max_shift) // 6, (w + 4 * max_shift) // 6), dtype=np.uint8)
    canvas = cv2.resize(canvas, (w + 4 * max_shift, h + 4 * max_shift), interpolation=cv2.INTER_NEAREST)
    canvas = cv2.GaussianBlur(canvas, (3, 3), 0.8)
    canvas = cv2.cvtColor(canvas, cv2.COLOR_GRAY2BGR)
    frames, shifts = [], []
    s = np.array([0, 0])
    for _ in range(num_frames):
        y0, x0 = 2 * max_shift + s[1], 2 * max_shift + s[0]
        frames.append(canvas[y0 : y0 + h, x0 : x0 + w].copy())
        shifts.append(s.copy())
        s = np.clip(s + rng.integers(-2, 3, size=2), -max_shift, max_shift)
    return frames, np.array(shifts)


@pytest.mark.slow
def test_online_stream_reduces_jitter(rng):
    config = MeshFlowConfig(
        max_features_per_subframe=64,
        ransac_iterations=64,
        lk_max_iterations=10,
    )
    frames, shifts = _clip(rng, 14)
    stab = OnlineMeshFlowStabilizer(config=config, crop_ratio=0.8)

    outs = [stab.process(f) for f in frames]
    assert all(o.shape == frames[0].shape for o in outs)
    assert all(o.dtype == np.uint8 for o in outs)
    # First frame passes through unchanged (one-frame latency bootstrap).
    np.testing.assert_array_equal(outs[0], frames[0])

    # Jitter reduction: track the center patch across output frames; its
    # drift should be smoother than the raw input shake.
    def center_drift(seq):
        drifts = []
        for a, b in zip(seq[:-1], seq[1:]):
            ga = cv2.cvtColor(a, cv2.COLOR_BGR2GRAY).astype(np.float32)
            gb = cv2.cvtColor(b, cv2.COLOR_BGR2GRAY).astype(np.float32)
            shift, _ = cv2.phaseCorrelate(ga, gb)
            drifts.append(shift)
        return np.array(drifts)

    in_jitter = np.abs(np.diff(center_drift(frames), axis=0)).mean()
    out_jitter = np.abs(np.diff(center_drift(outs[2:]), axis=0)).mean()
    assert out_jitter < in_jitter


def test_online_state_bootstrap(rng):
    config = MeshFlowConfig(
        max_features_per_subframe=32, ransac_iterations=32, lk_max_iterations=5
    )
    frames, _ = _clip(rng, 3)
    stab = OnlineMeshFlowStabilizer(config=config)
    out0 = stab.process(frames[0])
    np.testing.assert_array_equal(out0, frames[0])
    out1 = stab.process(frames[1])
    assert out1.shape == frames[1].shape
    assert np.isfinite(out1.astype(np.float64)).all()


def test_online_gray_transport(rng):
    """track_planes='gray' ships single-plane frames to the device; the
    stabilized output is still full BGR (host warp from the input frame)."""
    from meshflow.render import host as host_render

    if not host_render.available():
        pytest.skip("native streaming renderer not built")
    config = MeshFlowConfig(
        max_features_per_subframe=32,
        ransac_iterations=32,
        lk_max_iterations=5,
        track_planes="gray",
    )
    frames, _ = _clip(rng, 4)
    stab = OnlineMeshFlowStabilizer(config=config)
    outs = [stab.process(f) for f in frames]
    np.testing.assert_array_equal(outs[0], frames[0])
    for o in outs[1:]:
        assert o.shape == frames[0].shape and o.dtype == np.uint8
        assert np.isfinite(o.astype(np.float64)).all()
