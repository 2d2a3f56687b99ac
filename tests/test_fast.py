"""Oracle tests: FAST detector and gray conversion vs OpenCV."""

import cv2
import numpy as np
import jax.numpy as jnp

from meshflow.config import MeshFlowConfig
from meshflow.kernels.color import bgr_to_gray
from meshflow.kernels.fast import detect_keypoints
from meshflow.synth import synthetic_clip
from meshflow.utils.grid import subframe_offsets


def test_bgr_to_gray_exact(rng):
    img = rng.integers(0, 256, size=(64, 96, 3), dtype=np.uint8)
    ours = np.asarray(bgr_to_gray(jnp.asarray(img)))
    ref = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    np.testing.assert_array_equal(ours, ref)


def _opencv_subframe_keypoints(gray, config):
    """Run OpenCV FAST per subframe like the reference does
    (/root/reference/meshflowstabilizer.py:503-516, :613)."""
    det = cv2.FastFeatureDetector_create()
    h, w = gray.shape
    out = set()
    for off_x, off_y in subframe_offsets(config, h, w):
        sub = gray[off_y : off_y + config.subframe_shape(h, w)[0],
                   off_x : off_x + config.subframe_shape(h, w)[1]]
        for kp in det.detect(sub):
            out.add((kp.pt[0] + off_x, kp.pt[1] + off_y, kp.response))
    return out


def _our_keypoints(gray, config):
    h, w = gray.shape
    kps = detect_keypoints(jnp.asarray(gray), config, h, w)
    pos = np.asarray(kps.positions)
    sc = np.asarray(kps.scores)
    val = np.asarray(kps.valid)
    out = set()
    for s in range(pos.shape[0]):
        for i in range(pos.shape[1]):
            if val[s, i]:
                out.add((float(pos[s, i, 0]), float(pos[s, i, 1]), float(sc[s, i])))
    return out


def _structured_image(rng, h, w):
    """Blurred random blobs: realistic corner density (not NMS-degenerate
    like raw noise, where OpenCV's equal-score suppression quirks explode)."""
    img = rng.integers(0, 256, size=(h // 8, w // 8), dtype=np.uint8)
    img = cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)
    img = cv2.GaussianBlur(img, (3, 3), 0.8)
    return img


def test_fast_matches_opencv_structured(rng):
    config = MeshFlowConfig(max_features_per_subframe=2048)
    gray = _structured_image(rng, 120, 160)
    ref = _opencv_subframe_keypoints(gray, config)
    ours = _our_keypoints(gray, config)
    assert ours == ref


def test_fast_matches_opencv_real_frame():
    """A full 640x360 frame of the seeded synthetic clip (the demo
    suite's geometry)."""
    config = MeshFlowConfig(max_features_per_subframe=4096)
    frame = synthetic_clip(1, 360, 640, seed=3)[0]
    gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
    ref = _opencv_subframe_keypoints(gray, config)
    ours = _our_keypoints(gray, config)
    assert ours == ref
    assert len(ref) > 100  # sanity: the clip has texture


def test_fast_topk_keeps_strongest(rng):
    config = MeshFlowConfig(max_features_per_subframe=8)
    gray = _structured_image(rng, 120, 160)
    full = _opencv_subframe_keypoints(gray, MeshFlowConfig(max_features_per_subframe=8))
    ours = _our_keypoints(gray, config)
    # Every kept keypoint is a true OpenCV keypoint.
    ref_all = _opencv_subframe_keypoints(gray, config)
    assert ours.issubset(ref_all)
    # And per subframe we keep the strongest-scoring ones.
    h, w = gray.shape
    kps = detect_keypoints(jnp.asarray(gray), config, h, w)
    sc = np.asarray(kps.scores)
    val = np.asarray(kps.valid)
    for s in range(sc.shape[0]):
        kept = sc[s][val[s]]
        assert (np.diff(kept) <= 0).all()  # sorted descending


def test_fast_batched_over_frames(rng):
    config = MeshFlowConfig(max_features_per_subframe=64)
    frames = np.stack([_structured_image(rng, 120, 160) for _ in range(3)])
    batched = detect_keypoints(jnp.asarray(frames), config, 120, 160)
    for i in range(3):
        single = detect_keypoints(jnp.asarray(frames[i]), config, 120, 160)
        np.testing.assert_array_equal(
            np.asarray(batched.positions[i]), np.asarray(single.positions)
        )
        np.testing.assert_array_equal(
            np.asarray(batched.valid[i]), np.asarray(single.valid)
        )
