"""Native libav video IO runtime tests (skipped where libav is missing).

Clips are the seeded synthetic generator's, encoded with cv2 inside the
test."""

import numpy as np
import cv2
import pytest

from meshflow.io import native as native_io
from meshflow.io import video as video_io
from meshflow.synth import synthetic_clip


@pytest.fixture(autouse=True)
def native():
    if not native_io.available():
        pytest.skip(f"native video IO not available: {native_io.unavailable_reason()}")


def _encode(path, frames, fps=30.0):
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    assert writer.isOpened()
    for frame in frames:
        writer.write(frame)
    writer.release()


def test_native_decode_matches_cv2(tmp_path):
    clip = tmp_path / "clip.mp4"
    _encode(clip, synthetic_clip(8, 360, 640, seed=5))
    reader = native_io.NativeReader(str(clip))
    assert (reader.width, reader.height) == (640, 360)
    assert abs(reader.fps - 30.0) < 0.5
    batch = reader.read(5)
    reader.close()
    cap = cv2.VideoCapture(str(clip))
    for i in range(5):
        ok, ref = cap.read()
        assert ok
        np.testing.assert_array_equal(batch[i], ref)
    cap.release()


def test_native_roundtrip(tmp_path, rng):
    frames = rng.integers(0, 256, size=(12, 96, 128, 3), dtype=np.uint8)
    # smooth so lossy encode stays close
    frames = np.stack([cv2.GaussianBlur(f, (7, 7), 3.0) for f in frames])
    path = str(tmp_path / "out.mp4")
    video_io.write_video(path, frames, 30.0, 0)
    back, info = video_io.read_video(path)
    assert info.num_frames == 12
    assert back.shape == frames.shape
    assert np.abs(back.astype(int) - frames.astype(int)).mean() < 8.0


def test_native_missing_file():
    with pytest.raises(IOError):
        native_io.NativeReader("/nonexistent-clip.mp4")


def test_read_video_uses_native_and_matches_reference_count(tmp_path):
    clip = tmp_path / "clip.mp4"
    _encode(clip, synthetic_clip(37, 360, 640, seed=6))
    frames, info = video_io.read_video(str(clip))
    assert frames.shape == (37, 360, 640, 3)
    assert info.num_frames == 37
    assert info.fourcc != 0
