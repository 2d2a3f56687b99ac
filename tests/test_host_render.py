"""Native host render path vs the device render path (same algorithm)."""

import cv2
import numpy as np
import jax.numpy as jnp
import pytest

from meshflow.config import MeshFlowConfig
from meshflow.render import host as host_render
from meshflow.render.stabilize import crop_frames, render_stabilized
from meshflow.utils.grid import vertex_grid

@pytest.fixture(autouse=True)
def native_warp():
    if not host_render.available():
        pytest.skip("native warp library does not build on this host")


def _inputs(rng, num_frames=3, h=120, w=160):
    img = rng.integers(0, 256, size=(h // 6, w // 6, 3), dtype=np.uint8)
    frame = cv2.GaussianBlur(
        cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST), (3, 3), 0.8
    )
    frames = np.stack([frame] * num_frames)
    config = MeshFlowConfig()
    vr, vc = config.vertex_rows, config.vertex_cols
    unstab = rng.normal(scale=2.0, size=(num_frames, vr, vc, 2)).astype(np.float32)
    diff = cv2.GaussianBlur(
        rng.normal(scale=3.0, size=(num_frames * vr, vc * 2)).astype(np.float32),
        (5, 5), 1.5,
    ).reshape(num_frames, vr, vc, 2)
    stab = unstab + diff
    return frames, unstab, stab, config


def test_host_render_matches_device(rng, monkeypatch):
    # The self-contained C++ float path is the strict device-parity twin;
    # the cv2 backend adds OpenCV's 1/32-px fixed-point quantization and is
    # gated separately below.
    monkeypatch.setenv("MESHFLOW_HOST_REMAP", "cpp")
    frames, unstab, stab, config = _inputs(rng)
    h, w = frames.shape[1:3]

    vg = jnp.asarray(vertex_grid(config, h, w))
    dev_frames, dev_crop = render_stabilized(
        jnp.asarray(frames), jnp.asarray(unstab), jnp.asarray(stab), vg, config, h, w
    )
    dev_frames = np.asarray(dev_frames)
    dev_crop = np.asarray(dev_crop)

    host_frames, host_crop = host_render.render_stabilized_host(
        frames, unstab, stab, config
    )

    np.testing.assert_array_equal(host_crop, dev_crop)
    diff = np.abs(host_frames.astype(int) - dev_frames.astype(int))
    assert (diff <= 1).mean() > 0.995, f"match {(diff <= 1).mean()}"


def test_host_crop_resize_matches_device(rng, monkeypatch):
    monkeypatch.setenv("MESHFLOW_HOST_REMAP", "cpp")
    frames, unstab, stab, config = _inputs(rng)
    h, w = frames.shape[1:3]
    crop = np.array([11, 8, 149, 109], np.int32)
    dev = np.asarray(crop_frames(jnp.asarray(frames), jnp.asarray(crop), h, w))
    host = host_render.crop_frames_host(frames, crop)
    diff = np.abs(host.astype(int) - dev.astype(int))
    assert diff.max() <= 1
    assert (diff == 0).mean() > 0.99


def test_host_render_identity(rng):
    frames, _, _, config = _inputs(rng, num_frames=2)
    zeros = np.zeros((2, config.vertex_rows, config.vertex_cols, 2), np.float32)
    out, crop = host_render.render_stabilized_host(frames, zeros, zeros, config)
    np.testing.assert_array_equal(out, frames)


def test_cv2_backend_matches_cpp(rng, monkeypatch):
    """The cv2 remap backend agrees with the C++ float path within
    OpenCV's fixed-point quantization, and its crop rect is identical."""
    if not host_render._use_cv2_remap():
        pytest.skip("cv2 remap backend unavailable")
    frames, unstab, stab, config = _inputs(rng)

    monkeypatch.setenv("MESHFLOW_HOST_REMAP", "cpp")
    cpp_frames, cpp_crop = host_render.render_stabilized_host(
        frames, unstab, stab, config
    )
    monkeypatch.setenv("MESHFLOW_HOST_REMAP", "cv2")
    cv_frames, cv_crop = host_render.render_stabilized_host(
        frames, unstab, stab, config
    )

    np.testing.assert_array_equal(cv_crop, cpp_crop)
    diff = np.abs(cv_frames.astype(int) - cpp_frames.astype(int))
    assert (diff <= 2).mean() > 0.995, f"match {(diff <= 2).mean()}"
    assert diff.max() <= 16  # isolated taps at hard border transitions


def test_cv2_fused_equals_two_stage(rng):
    """render_cropped_host == render_stabilized_host + crop_frames_host,
    byte-exact, on the cv2 backend (the streaming pipeline's invariant)."""
    if not host_render._use_cv2_remap():
        pytest.skip("cv2 remap backend unavailable")
    frames, unstab, stab, config = _inputs(rng)
    stab_frames, crop = host_render.render_stabilized_host(
        frames, unstab, stab, config
    )
    two_stage = host_render.crop_frames_host(stab_frames, crop)
    fused = host_render.render_cropped_host(frames, unstab, stab, crop, config)
    np.testing.assert_array_equal(fused, two_stage)
