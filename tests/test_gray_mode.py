"""track_planes="gray" transport: single-plane tracking path.

The reference tracks on 3-channel BGR subframes
(/root/reference/meshflowstabilizer.py:618-620); track_planes="gray" is a
transport option that ships and processes one exact-cv2 gray
plane instead (3x less host->device transfer and pyramid/window work at
high resolutions).  These tests pin the invariants that make it sound:

* the host conversion is bit-identical to the device's bgr_to_gray and
  to cv2's BGR2GRAY (so FAST keypoints are identical in both modes),
* the gray warp path commutes with gray conversion to within bilinear
  rounding (<=1 LSB), with an identical crop rectangle,
* the streaming and in-memory pipelines remain bit-identical to each
  other under gray mode,
* motion checkpoints never cross modes.
"""

import cv2
import numpy as np
import jax.numpy as jnp
import pytest

from meshflow import MeshFlowConfig
from meshflow.kernels.color import bgr_to_gray, gray_of_bgr_color
from meshflow.streaming import to_track_planes


def test_to_track_planes_matches_device_gray(rng):
    frames = rng.integers(0, 256, (3, 24, 32, 3), dtype=np.uint8)
    config = MeshFlowConfig(track_planes="gray")
    out = to_track_planes(frames, config)
    assert out.shape == (3, 24, 32, 1) and out.dtype == np.uint8
    dev = np.asarray(bgr_to_gray(jnp.asarray(frames)))
    np.testing.assert_array_equal(out[..., 0], dev)
    # bgr mode is a no-copy passthrough
    assert to_track_planes(frames, MeshFlowConfig()) is frames


def test_to_track_planes_matches_cv2_gray(rng):
    frames = rng.integers(0, 256, (2, 37, 53, 3), dtype=np.uint8)
    out = to_track_planes(frames, MeshFlowConfig(track_planes="gray"))
    ref = np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in frames])
    np.testing.assert_array_equal(out[..., 0], ref)


def test_border_gray_matches_cv2():
    for color in [(0, 0, 255), (17, 200, 3), (255, 255, 255), (0, 0, 0)]:
        px = np.array([[color]], np.uint8)
        assert gray_of_bgr_color(color) == int(
            cv2.cvtColor(px, cv2.COLOR_BGR2GRAY)[0, 0]
        )


def test_gray_warp_commutes_with_gray_conversion(rng):
    """render_stabilized(gray planes) == bgr_to_gray(render_stabilized(BGR))
    within bilinear rounding; the crop rectangle (a function of the
    displacement fields alone) is identical."""
    from meshflow.render.stabilize import render_stabilized
    from meshflow.utils import grid

    config = MeshFlowConfig(mesh_row_count=4, mesh_col_count=4)
    f, h, w = 3, 48, 64
    frames = rng.integers(0, 256, (f, h, w, 3), dtype=np.uint8)
    vr, vc = config.vertex_rows, config.vertex_cols
    du = rng.normal(0, 1.0, (f, vr, vc, 2)).astype(np.float32)
    ds = rng.normal(0, 1.0, (f, vr, vc, 2)).astype(np.float32)
    unstab_grid = jnp.asarray(grid.vertex_grid(config, h, w))

    stab_bgr, crop_bgr = render_stabilized(
        jnp.asarray(frames), jnp.asarray(du), jnp.asarray(ds),
        unstab_grid, config, h, w,
    )
    gray_in = np.asarray(bgr_to_gray(jnp.asarray(frames)))[..., None]
    stab_gray, crop_gray = render_stabilized(
        jnp.asarray(gray_in), jnp.asarray(du), jnp.asarray(ds),
        unstab_grid, config, h, w,
    )
    assert stab_gray.shape == (f, h, w, 1)
    np.testing.assert_array_equal(np.asarray(crop_bgr), np.asarray(crop_gray))
    gray_of_warp = np.asarray(bgr_to_gray(stab_bgr)).astype(np.int16)
    warp_of_gray = np.asarray(stab_gray)[..., 0].astype(np.int16)
    diff = np.abs(gray_of_warp - warp_of_gray)
    assert diff.max() <= 2, diff.max()
    assert (diff <= 1).mean() > 0.99


def test_gray_checkpoint_key_differs(tmp_path):
    from meshflow import checkpoint as ckpt

    clip = tmp_path / "c.mp4"
    clip.write_bytes(b"x")
    a = ckpt.cache_path(str(tmp_path), str(clip), MeshFlowConfig(), 0)
    b = ckpt.cache_path(
        str(tmp_path), str(clip), MeshFlowConfig(track_planes="gray"), 0
    )
    assert a != b


@pytest.mark.slow
def test_gray_streamed_matches_in_memory(tmp_path, rng, monkeypatch):
    """Under track_planes='gray', streaming and in-memory paths stay
    bit-identical to each other (same invariant the bgr modes carry), and
    the result is sane relative to the bgr run on an easy rigid clip."""
    from tests.test_api_e2e import _write_clip
    from meshflow import MeshFlowStabilizer
    from meshflow.render import host as host_render

    if not host_render.available():
        pytest.skip("native streaming renderer not built")
    clip = tmp_path / "in.avi"
    _write_clip(clip, rng, num_frames=24, h=120, w=160)
    config = MeshFlowConfig(
        max_features_per_subframe=64,
        ransac_iterations=64,
        lk_max_iterations=10,
        optimization_num_iterations=20,
        track_planes="gray",
    )

    results, outs = {}, {}
    for mode in ("0", "1"):
        monkeypatch.setenv("MESHFLOW_STREAM", mode)
        monkeypatch.setenv("MESHFLOW_RENDER", "host")
        m = MeshFlowStabilizer(config=config)
        m.CHUNK = 16
        out = tmp_path / f"out_{mode}.avi"
        results[mode] = m.stabilize(str(clip), str(out), 0)
        cap = cv2.VideoCapture(str(out))
        frames = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f)
        cap.release()
        outs[mode] = np.stack(frames)

    assert results["0"] == results["1"]
    np.testing.assert_array_equal(outs["0"], outs["1"])
    assert outs["1"].shape == (24, 120, 160, 3)
    ratio, distortion, stability = results["1"]
    assert np.isfinite([ratio, distortion, stability]).all()
    assert 0.2 < ratio <= 1.5 and 0.0 < distortion <= 1.01
