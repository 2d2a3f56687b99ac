"""The raw .npy container, and the main path on a host without OpenCV."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from meshflow.io import video as video_io
from meshflow.streaming import ChunkReader, StreamWriter
from meshflow.synth import synthetic_clip

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_raw_roundtrip(tmp_path):
    frames = synthetic_clip(7, 36, 64, seed=1)
    path = str(tmp_path / "clip.npy")
    video_io.write_video(path, frames, 24.0, 0)
    back, info = video_io.read_video(path)
    np.testing.assert_array_equal(back, frames)
    assert (info.num_frames, info.height, info.width) == (7, 36, 64)
    assert info.fps == video_io.RAW_FPS and info.fourcc == 0
    probed = video_io.probe_video(path)
    assert (probed.num_frames, probed.height, probed.width) == (7, 36, 64)
    np.save(str(tmp_path / "bad.npy"), np.zeros((2, 4, 4), np.float32))
    with pytest.raises(IOError, match="not a raw clip"):
        video_io.read_video(str(tmp_path / "bad.npy"))
    with pytest.raises(IOError):
        video_io.probe_video(str(tmp_path / "missing.npy"))


def test_raw_chunked_read_and_stream_write(tmp_path):
    frames = synthetic_clip(12, 36, 64, seed=2)
    src = str(tmp_path / "in.npy")
    np.save(src, frames)
    reader = ChunkReader(src)
    assert reader.num_frames == 12
    chunks = [reader.read(5) for _ in range(4)]
    reader.close(check=True)
    assert [len(c) for c in chunks] == [5, 5, 2, 0]
    np.testing.assert_array_equal(np.concatenate(chunks[:3]), frames)

    dst = str(tmp_path / "out.npy")
    writer = StreamWriter(dst, 64, 36, 30.0, 0, num_frames=12)
    for start in range(0, 12, 5):
        writer.write(frames[start : start + 5])
    writer.close()
    np.testing.assert_array_equal(np.load(dst), frames)

    short = StreamWriter(str(tmp_path / "short.npy"), 64, 36, 30.0, 0, num_frames=12)
    short.write(frames[:5])
    with pytest.raises(IOError, match="5 of 12"):
        short.close()


def test_main_path_runs_without_cv2(tmp_path):
    """`from meshflow import MeshFlowStabilizer` and a stabilize run with
    cv2 blocked from import, raw container in and out, on the CPU."""
    src, dst = str(tmp_path / "in.npy"), str(tmp_path / "out.npy")
    np.save(src, synthetic_clip(6, 48, 64, seed=3))
    code = textwrap.dedent(
        f"""
        import sys
        sys.modules["cv2"] = None  # import cv2 -> ImportError
        import numpy as np
        from meshflow import MeshFlowConfig, MeshFlowStabilizer
        from meshflow.utils.compile_cache import configure_compile_cache

        configure_compile_cache()
        config = MeshFlowConfig(
            max_features_per_subframe=64, ransac_iterations=64,
            lk_max_iterations=10, optimization_num_iterations=20,
        )
        scores = MeshFlowStabilizer(config=config).stabilize({src!r}, {dst!r})
        out = np.load({dst!r})
        assert out.shape == (6, 48, 64, 3), out.shape
        assert np.isfinite(scores).all(), scores
        try:
            import cv2
        except ImportError:
            print("cv2 blocked; scores", scores)
        """
    )
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "cv2 blocked" in proc.stdout
