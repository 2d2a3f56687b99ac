"""Host-side video decode/encode.

Mirrors the reference's container handling
(/root/reference/meshflowstabilizer.py:172-233, :1290-1322): frame count,
fps, and fourcc are read from the container and passed through to the
writer; a short read raises IOError with the reference's message shape.

Backends, by file extension:

* ``.npy`` — the raw container: one (F, H, W, 3) uint8 BGR array in NumPy's
  own format, lossless, read in chunks through a memory map.  It carries no
  timing: a raw clip plays at RAW_FPS and has fourcc 0, and writing one
  ignores the fps and fourcc it is given.  It needs nothing beyond NumPy,
  so the pipeline runs end to end on a host with neither libav nor OpenCV.
* anything else is a codec container: the native libav runtime
  (io/native.py) when it builds on this host, else OpenCV.  With neither,
  opening one raises an IOError that names what is missing.

Everything downstream of these functions lives on device.  Streaming
decode/encode for the two-pass pipeline lives in streaming.py
(ChunkReader / StreamWriter), on the same backends.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from meshflow.io import native as native_io

RAW_EXTENSION = ".npy"
RAW_FPS = 30.0


class VideoInfo:
    def __init__(self, num_frames: int, fps: float, fourcc: int, height: int, width: int):
        self.num_frames = num_frames
        self.fps = fps
        self.fourcc = fourcc
        self.height = height
        self.width = width


def is_raw(path: str) -> bool:
    return str(path).lower().endswith(RAW_EXTENSION)


def open_raw(path: str) -> np.ndarray:
    """Memory-map a raw clip: (F, H, W, 3) uint8 BGR, read lazily."""
    try:
        clip = np.load(path, mmap_mode="r")
    except (OSError, ValueError) as e:
        raise IOError(f"Could not open video at <{path}>.") from e
    if clip.dtype != np.uint8 or clip.ndim != 4 or clip.shape[-1] != 3:
        raise IOError(
            f"<{path}> is not a raw clip: expected (F, H, W, 3) uint8 BGR, "
            f"got {clip.dtype} {clip.shape}."
        )
    return clip


def raw_writer(path: str, num_frames: int, height: int, width: int) -> np.ndarray:
    """A writable memory map for a raw clip of known size."""
    return np.lib.format.open_memmap(
        path, mode="w+", dtype=np.uint8, shape=(num_frames, height, width, 3)
    )


def opencv(path: str):
    """The cv2 module for a codec container, or an IOError naming what
    this host lacks."""
    try:
        import cv2
    except ImportError as e:
        raise IOError(
            f"<{path}> needs a video codec backend: the native libav "
            "library is not available on this host "
            f"({native_io.unavailable_reason()}) and OpenCV (cv2) is not "
            f"installed.  The raw {RAW_EXTENSION} container needs neither."
        ) from e
    return cv2


def probe_video(input_path: str) -> VideoInfo:
    if is_raw(input_path):
        f, h, w, _ = open_raw(input_path).shape
        return VideoInfo(num_frames=f, fps=RAW_FPS, fourcc=0, height=h, width=w)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None and native_io.available():
        with native_io.NativeReader(input_path) as reader:
            return VideoInfo(
                num_frames=reader.num_frames,
                fps=reader.fps,
                fourcc=reader.fourcc,
                height=reader.height,
                width=reader.width,
            )
    cv2 = opencv(input_path)
    video = cv2.VideoCapture(input_path)
    if not video.isOpened():
        video.release()
        raise IOError(f"Could not open video at <{input_path}>.")
    info = VideoInfo(
        num_frames=int(video.get(cv2.CAP_PROP_FRAME_COUNT)),
        fps=video.get(cv2.CAP_PROP_FPS),
        fourcc=int(video.get(cv2.CAP_PROP_FOURCC)),
        height=int(video.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        width=int(video.get(cv2.CAP_PROP_FRAME_WIDTH)),
    )
    video.release()
    return info


def read_video(input_path: str) -> Tuple[np.ndarray, VideoInfo]:
    """Decode the whole clip -> ((F, H, W, 3) uint8 BGR, VideoInfo).

    Raw clips are read straight from the file; codec containers go through
    the native libav runtime (prefetching decoder thread) when built, else
    cv2.
    """
    if is_raw(input_path):
        frames = np.ascontiguousarray(open_raw(input_path))
        f, h, w, _ = frames.shape
        return frames, VideoInfo(f, RAW_FPS, 0, h, w)

    if native_io.available():
        reader = native_io.NativeReader(input_path)
        batches = []
        while True:
            batch = reader.read(128)
            if len(batch) == 0:
                break
            batches.append(batch)
        reader.close()
        total = sum(len(b) for b in batches)
        if reader.num_frames and total < reader.num_frames:
            raise IOError(
                f"Video at <{input_path}> did not have frame {total} of "
                f"{reader.num_frames} (indexed from 0)."
            )
        stacked = (
            np.concatenate(batches)
            if batches
            else np.zeros((0, 0, 0, 3), np.uint8)
        )
        info = VideoInfo(
            num_frames=total,
            fps=reader.fps,
            fourcc=reader.fourcc,
            height=reader.height,
            width=reader.width,
        )
        return stacked, info

    cv2 = opencv(input_path)
    video = cv2.VideoCapture(input_path)
    if not video.isOpened():
        video.release()
        raise IOError(f"Could not open video at <{input_path}>.")
    num_frames = int(video.get(cv2.CAP_PROP_FRAME_COUNT))
    fps = video.get(cv2.CAP_PROP_FPS)
    fourcc = int(video.get(cv2.CAP_PROP_FOURCC))
    frames = []
    for frame_index in range(num_frames):
        ok, frame = video.read()
        if not ok:
            video.release()
            raise IOError(
                f"Video at <{input_path}> did not have frame {frame_index} of "
                f"{num_frames} (indexed from 0)."
            )
        frames.append(frame)
    video.release()
    stacked = np.stack(frames) if frames else np.zeros((0, 0, 0, 3), np.uint8)
    info = VideoInfo(
        num_frames=num_frames,
        fps=fps,
        fourcc=fourcc,
        height=stacked.shape[1] if num_frames else 0,
        width=stacked.shape[2] if num_frames else 0,
    )
    return stacked, info


def write_video(
    output_path: str, frames: np.ndarray, fps: float, fourcc: int
) -> None:
    """Encode (F, H, W, 3) uint8 BGR with the input's fourcc and fps.

    The reference passes the input fourcc straight through
    (/root/reference/meshflowstabilizer.py:1310-1315) and silently writes
    nothing when that encoder is unavailable (cv2.VideoWriter does not
    raise).  Defined behavior here: a raw path gets the frames verbatim;
    otherwise the native libav encoder handles the requested codec
    (falling back to mpeg4); without the native library, cv2 with an mp4v
    fallback, raising if even that fails or if cv2 is missing too.
    """
    if is_raw(output_path):
        with open(output_path, "wb") as f:
            np.save(f, np.ascontiguousarray(frames, np.uint8))
        return
    height, width = frames.shape[1:3]
    if native_io.available():
        try:
            writer = native_io.NativeWriter(output_path, width, height, fps, fourcc)
        except IOError:
            writer = None  # codec/container outside libav runtime -> cv2 below
        if writer is not None:
            try:
                written = writer.write(frames)
            finally:
                rc = writer.close()
            if written != len(frames) or rc != 0:
                raise IOError(f"Native encoder failed for <{output_path}>.")
            return
    cv2 = opencv(output_path)
    writer = cv2.VideoWriter(output_path, fourcc, fps, (width, height))
    if not writer.isOpened():
        writer.release()
        writer = cv2.VideoWriter(
            output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height)
        )
    if not writer.isOpened():
        writer.release()
        raise IOError(f"Could not open a video encoder for <{output_path}>.")
    for frame in frames:
        writer.write(np.ascontiguousarray(frame))
    writer.release()
