"""Track geometry (motion/trackscale.py): motion estimation on box-
downscaled frames for >= 1 MP inputs.

The reference's parity contract lives at its demo resolution (all clips in
/root/reference/videos are 640x360); its per-pixel motion stages
(meshflowstabilizer.py:613, :618-620, :1195-1197) scale with pixels while
the mesh stays 16x16.  These tests pin the invariants that make the
downscaled geometry sound:

* the host (NumPy) and device (JAX) integer box means are bit-identical
  to each other and to cv2 INTER_AREA for every factor the auto policy
  can pick,
* the homography conjugation H_full = S H_track S^-1 leaves the adaptive
  weights and both metric formulas invariant,
* the auto policy engages only above the demo-resolution budget,
* streaming and in-memory pipelines stay bit-identical to each other under
  track_downscale > 1, and the stabilized output stays close to the
  full-geometry run on an easy rigid clip.
"""

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from meshflow import MeshFlowConfig
from meshflow.motion import trackscale


def test_box_downscale_dev_matches_host(rng):
    # 97x131: non-divisible by every factor, so the alignment crop is
    # exercised too.  d=2 (720p), 3 (1080p), 5 (4K) are what auto picks;
    # 4 and 6 cover the even >= 4 tie rule.
    frames = rng.integers(0, 256, (2, 97, 131, 3), dtype=np.uint8)
    for d in (1, 2, 3, 4, 5, 6):
        host = trackscale.box_downscale_host(frames, d)
        dev = np.asarray(trackscale.box_downscale_dev(jnp.asarray(frames), d))
        np.testing.assert_array_equal(host, dev, err_msg=f"d={d}")
        assert host.shape == (2, 97 // d, 131 // d, 3)
    # constructed tie cases: all-same values make sum/d^2 exact; a 2x2
    # block of {0,1} averaging to 0.5 hits the tie rule head-on
    tie = np.array([[[0, 1], [1, 0]]], np.uint8).reshape(1, 2, 2, 1)
    host = trackscale.box_downscale_host(tie, 2)
    dev = np.asarray(trackscale.box_downscale_dev(jnp.asarray(tie), 2))
    np.testing.assert_array_equal(host, dev)


def test_box_downscale_host_matches_cv2(rng):
    """The NumPy host downscale equals cv2.resize(INTER_AREA) on the
    aligned crop, for every factor the auto policy picks and the even
    >= 4 tie rule, on noise and on a tie-heavy two-level image."""
    noise = rng.integers(0, 256, (2, 97, 131, 3), dtype=np.uint8)
    ties = (rng.integers(0, 2, (2, 97, 131, 3)) * 3 + 100).astype(np.uint8)
    for frames in (noise, ties):
        for d in (2, 3, 4, 5, 6):
            th, tw = 97 // d, 131 // d
            ref = np.stack([
                cv2.resize(f[: th * d, : tw * d], (tw, th), interpolation=cv2.INTER_AREA)
                for f in frames
            ])
            np.testing.assert_array_equal(
                trackscale.box_downscale_host(frames, d), ref, err_msg=f"d={d}"
            )


def test_auto_policy_resolution():
    config = MeshFlowConfig()
    assert config.resolve_track_downscale(360, 640) == 1  # demo suite
    assert config.resolve_track_downscale(480, 854) == 1
    assert config.resolve_track_downscale(720, 1280) == 2
    assert config.resolve_track_downscale(1080, 1920) == 3  # -> 640x360
    assert config.resolve_track_downscale(2160, 3840) == 5  # -> 768x432
    assert config.track_shape(1080, 1920) == (360, 640)
    # explicit values override auto
    assert MeshFlowConfig(track_downscale=1).resolve_track_downscale(
        2160, 3840
    ) == 1
    assert MeshFlowConfig(track_downscale=2).resolve_track_downscale(
        360, 640
    ) == 2


def test_conjugation_preserves_weights_and_metrics(rng):
    """Adaptive weights (meshflowstabilizer.py:819-835) and the metric
    formulas (:1203, :1206-1210) are invariant under the track-geometry
    conjugation: lambda(H_track; tw, th) == lambda(H_full; w, h)."""
    from meshflow.kernels.eig3 import affine_eigen_ratio
    from meshflow.solver.weights import adaptive_weights

    h, w, d = 1080, 1920, 3
    th, tw = h // d, w // d
    sx, sy = w / tw, h / th
    # plausible near-identity inter-frame homographies at track scale
    f = 8
    hs = np.tile(np.eye(3, dtype=np.float32), (f, 1, 1))
    hs[:, :2, :] += rng.normal(0, 3e-3, (f, 2, 3)).astype(np.float32)
    hs[:, :2, 2] += rng.normal(0, 2.0, (f, 2)).astype(np.float32)
    hs[:, 2, :2] = rng.normal(0, 1e-5, (f, 2)).astype(np.float32)
    hs_full = np.asarray(
        trackscale.conjugate_homographies(jnp.asarray(hs), sx, sy)
    )
    for variant in range(4):
        lam_track = np.asarray(
            adaptive_weights(jnp.asarray(hs), tw, th, variant)
        )
        lam_full = np.asarray(
            adaptive_weights(jnp.asarray(hs_full), w, h, variant)
        )
        np.testing.assert_allclose(lam_track, lam_full, rtol=2e-4, atol=2e-5)
    # metric formulas on the same homographies
    for i in range(f):
        r_t = 1.0 / (hs[i, 0, 0] * hs[i, 1, 1])
        r_f = 1.0 / (hs_full[i, 0, 0] * hs_full[i, 1, 1])
        np.testing.assert_allclose(r_t, r_f, rtol=1e-5)
        d_t = float(affine_eigen_ratio(jnp.asarray(hs[i])))
        d_f = float(affine_eigen_ratio(jnp.asarray(hs_full[i])))
        np.testing.assert_allclose(d_t, d_f, rtol=2e-4, atol=2e-5)


def test_scale_velocities_and_checkpoint_key(tmp_path, rng):
    v = rng.normal(0, 2, (5, 17, 17, 2)).astype(np.float32)
    out = np.asarray(trackscale.scale_velocities(jnp.asarray(v), 3.0, 2.0))
    np.testing.assert_allclose(out[..., 0], v[..., 0] * 3.0, rtol=1e-6)
    np.testing.assert_allclose(out[..., 1], v[..., 1] * 2.0, rtol=1e-6)

    from meshflow import checkpoint as ckpt

    clip = tmp_path / "c.mp4"
    clip.write_bytes(b"x")
    a = ckpt.cache_path(str(tmp_path), str(clip), MeshFlowConfig(), 0)
    b = ckpt.cache_path(
        str(tmp_path), str(clip), MeshFlowConfig(track_downscale=2), 0
    )
    assert a != b


def test_checkpoint_key_names_lk_precision(tmp_path, monkeypatch):
    """A motion checkpoint written while the LK selection matmuls ran at
    another precision (another platform) misses instead of being reused."""
    from meshflow import checkpoint as ckpt
    from meshflow.kernels import lk

    clip = tmp_path / "c.npy"
    clip.write_bytes(b"x")
    keys = set()
    for precision in (None, jax.lax.Precision.HIGH, jax.lax.Precision.HIGHEST):
        monkeypatch.setattr(lk, "_selection_precision", lambda p=precision: p)
        assert str(precision) in ckpt._tracker_key()
        keys.add(ckpt.cache_path(str(tmp_path), str(clip), MeshFlowConfig(), 0))
    assert len(keys) == 3


@pytest.mark.slow
def test_trackscale_streamed_matches_in_memory(tmp_path, rng, monkeypatch):
    """Under track_downscale=2, streaming and in-memory paths stay
    bit-identical to each other, and the result stays close to the
    full-geometry run on an easy rigid clip."""
    from tests.test_api_e2e import _write_clip
    from meshflow import MeshFlowStabilizer
    from meshflow.render import host as host_render

    if not host_render.available():
        pytest.skip("native streaming renderer not built")
    clip = tmp_path / "in.avi"
    _write_clip(clip, rng, num_frames=24, h=180, w=320, max_shift=10)
    base = dict(
        max_features_per_subframe=64,
        ransac_iterations=64,
        lk_max_iterations=10,
        optimization_num_iterations=20,
    )

    results, outs = {}, {}
    for mode in ("0", "1"):
        monkeypatch.setenv("MESHFLOW_STREAM", mode)
        monkeypatch.setenv("MESHFLOW_RENDER", "host")
        m = MeshFlowStabilizer(
            config=MeshFlowConfig(track_downscale=2, **base)
        )
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
    assert outs["1"].shape == (24, 180, 320, 3)
    ratio, distortion, stability = results["1"]
    assert np.isfinite([ratio, distortion, stability]).all()
    assert 0.2 < ratio <= 1.5 and 0.0 < distortion <= 1.01

    # Full-geometry run on the same clip: the downscaled estimator should
    # land near it (rigid integer-shift motion is easy at either scale).
    monkeypatch.setenv("MESHFLOW_STREAM", "0")
    m1 = MeshFlowStabilizer(config=MeshFlowConfig(track_downscale=1, **base))
    m1.CHUNK = 16
    r1 = m1.stabilize(str(clip), str(tmp_path / "out_full.avi"), 0)
    assert abs(r1[0] - ratio) < 0.08, (r1, results["1"])  # cropping ratio
    assert abs(r1[2] - stability) < 0.08, (r1, results["1"])  # stability
