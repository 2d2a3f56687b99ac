"""Two-pass streaming pipeline: O(chunk) frame residency at any clip length.

The reference materializes every frame of the clip up front
(/root/reference/meshflowstabilizer.py:201-209) and again for each later
stage, which caps clip length by host RAM.  Here only displacement fields,
homographies, and keypoints — O(F) small tensors — persist across the clip;
pixels flow through in fixed-size chunks twice.  (One opportunistic
exception: when the whole clip fits a RAM-capped budget, pass 1's decoded
batches are retained so pass 2 skips the second decode — see host_cache
below.  Clips beyond the budget keep strict O(chunk) residency.)  The
stages:

pass 1 (decode -> device):  stride-(CHUNK-1) frame windows with a one-frame
    halo feed detection + the pair LK/RANSAC/propagation scan.  Velocities
    integrate into the same displacements as the in-memory path
    (identical windows, identical RANSAC seeds).
solve (device):             adaptive weights + banded Jacobi over the full
    (F, V, 2) state — tiny regardless of resolution.
crop (host):                mf_crop_edges derives the global crop rectangle
    from the displacement fields alone (same arithmetic as the rendering
    pass), so rendering can stream against a known crop.
pass 2 (decode -> host warp -> encode + device metrics):  each chunk is
    re-decoded, warped+cropped+stretched in one fused native call
    (byte-identical to the two-stage path), appended to the encoder, and
    pushed to the device for the metric tracker.

Decode runs on the native prefetch thread; device work is dispatched
asynchronously, so upload/compute/CPU warp overlap.  Results are identical
to MeshFlowStabilizer._stabilize_frames on the host-render path.
"""

from __future__ import annotations

import time

import numpy as np
import jax
import jax.numpy as jnp

from meshflow.config import MeshFlowConfig
from meshflow.io import native as native_io
from meshflow.io import video as video_io
from meshflow.metrics.quality import (
    cropping_and_distortion_scanned,
    stability_score,
)
from meshflow.kernels.color import bgr_to_gray
from meshflow.motion import trackscale
from meshflow.motion.pipeline import (
    MotionEstimate,
    integrate_velocities,
    pair_velocity_scan,
    prepare_frames,
)
from meshflow.render import host as host_render
from meshflow.solver.jacobi import jacobi_smooth
from meshflow.solver.weights import adaptive_weights

# Share of the device's memory limit that pass 1 may fill with decoded
# frames kept for the metric pass; the rest is the passes' working sets
# (pyramids, tracker windows, render chunks).  The CPU backend reports no
# limit and keeps a constant budget.
_FRAME_BUDGET_SHARE = 0.25
_CPU_FRAME_BUDGET = 4 << 30


def frame_budget_bytes() -> int:
    """Bytes of decoded frames pass 1 keeps resident on the default device."""
    device = jax.devices()[0]
    if device.platform == "cpu":
        return _CPU_FRAME_BUDGET
    stats = device.memory_stats()
    if not stats or "bytes_limit" not in stats:
        raise RuntimeError(
            f"{device.device_kind} reports no memory limit "
            "(memory_stats()['bytes_limit']); cannot size frame residency"
        )
    return int(stats["bytes_limit"] * _FRAME_BUDGET_SHARE)


def to_track_planes(batch_bgr: np.ndarray, config: MeshFlowConfig) -> np.ndarray:
    """Host-side plane prep for upload: (F, H, W, 3) BGR -> the planes the
    device trackers consume.  track_planes="gray" converts on the host with
    the device's own kernels.color.bgr_to_gray (bit-identical to cv2's
    BGR2GRAY) and ships (F, H, W, 1) — 3x less host->device transfer and
    device pyramid work.
    """
    if config.track_planes != "gray":
        return batch_bgr
    return np.asarray(bgr_to_gray(batch_bgr))[..., None]


class ChunkReader:
    """Sequential frame reader: raw container (memory map), native libav
    (prefetch thread), or cv2.

    Raises the reference's IOError shape on a short clip
    (meshflowstabilizer.py:204-208) when close(check=True) is called.
    """

    def __init__(self, path: str):
        self.path = path
        self._raw = None
        self._native = None
        self._cv = None
        if video_io.is_raw(path):
            self._raw = video_io.open_raw(path)
            self.num_frames = self._raw.shape[0]
        elif native_io.available():
            self._native = native_io.NativeReader(path)
            self.num_frames = self._native.num_frames
        else:
            cv2 = video_io.opencv(path)

            self._cv = cv2.VideoCapture(path)
            if not self._cv.isOpened():
                self._cv.release()
                raise IOError(f"Could not open video at <{path}>.")
            self.num_frames = int(self._cv.get(cv2.CAP_PROP_FRAME_COUNT))
        self._read = 0

    def read(self, n: int) -> np.ndarray:
        if self._raw is not None:
            batch = np.array(self._raw[self._read : self._read + n])
            self._read += len(batch)
            return batch
        if self._native is not None:
            batch = self._native.read(n)
            self._read += len(batch)
            return batch
        frames = []
        while len(frames) < n:
            ok, frame = self._cv.read()
            if not ok:
                break
            frames.append(frame)
        self._read += len(frames)
        return (
            np.stack(frames)
            if frames
            else np.zeros((0, 0, 0, 3), np.uint8)
        )

    def close(self, check: bool = False):
        self._raw = None
        if self._native is not None:
            self._native.close()
        if self._cv is not None:
            self._cv.release()
        if check and self.num_frames and self._read < self.num_frames:
            raise IOError(
                f"Video at <{self.path}> did not have frame {self._read} of "
                f"{self.num_frames} (indexed from 0)."
            )


class StreamWriter:
    """Incremental encoder with write_video's backends and codec-fallback
    semantics.  A raw path needs the clip's frame count up front."""

    def __init__(
        self,
        path: str,
        width: int,
        height: int,
        fps: float,
        fourcc: int,
        num_frames: int,
    ):
        self._raw = None
        self._native = None
        self._cv = None
        self.path = path
        self._written = 0
        if video_io.is_raw(path):
            self._raw = video_io.raw_writer(path, num_frames, height, width)
            return
        if native_io.available():
            try:
                self._native = native_io.NativeWriter(
                    path, width, height, fps, fourcc
                )
            except IOError:
                self._native = None
        if self._native is None:
            cv2 = video_io.opencv(path)
            writer = cv2.VideoWriter(path, fourcc, fps, (width, height))
            if not writer.isOpened():
                writer.release()
                writer = cv2.VideoWriter(
                    path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height)
                )
            if not writer.isOpened():
                writer.release()
                raise IOError(f"Could not open a video encoder for <{path}>.")
            self._cv = writer

    def write(self, frames: np.ndarray):
        if self._raw is not None:
            n = len(frames)
            if self._written + n > self._raw.shape[0]:
                raise IOError(f"More frames than declared for <{self.path}>.")
            self._raw[self._written : self._written + n] = frames
            self._written += n
            return
        if self._native is not None:
            written = self._native.write(frames)
            if written != len(frames):
                raise IOError(f"Native encoder failed for <{self.path}>.")
            return
        for frame in frames:
            self._cv.write(np.ascontiguousarray(frame))

    def close(self):
        if self._raw is not None:
            raw, self._raw = self._raw, None
            raw.flush()
            if self._written != raw.shape[0]:
                raise IOError(
                    f"<{self.path}> got {self._written} of "
                    f"{raw.shape[0]} frames."
                )
        if self._native is not None:
            rc = self._native.close()
            self._native = None
            if rc != 0:
                raise IOError(f"Native encoder failed for <{self.path}>.")
        if self._cv is not None:
            self._cv.release()
            self._cv = None


def _pad_frames(a: np.ndarray, n: int) -> np.ndarray:
    """Edge-pad a numpy frame batch along axis 0 to length n."""
    if a.shape[0] == n:
        return a
    reps = np.repeat(a[-1:], n - a.shape[0], axis=0)
    return np.concatenate([a, reps], axis=0)


def _pad_dev(a: jnp.ndarray, n: int) -> jnp.ndarray:
    if a.shape[0] == n:
        return a
    padding = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return jnp.pad(a, padding, mode="edge")


def resident_end(parts) -> int:
    """Frames [0, end) covered by a contiguous (start, array) part list."""
    if not parts:
        return 0
    start, arr = parts[-1]
    return start + arr.shape[0]


def resident_slice(parts, start: int, n: int) -> jnp.ndarray:
    """Gather frames [start, start+n) from a contiguous device part list
    without ever concatenating the full clip (which would double peak
    device memory); at most two parts overlap a chunk-sized request."""
    out = []
    for p0, arr in parts:
        p1 = p0 + arr.shape[0]
        if p1 <= start or p0 >= start + n:
            continue
        out.append(arr[max(start, p0) - p0 : min(start + n, p1) - p0])
    return out[0] if len(out) == 1 else jnp.concatenate(out, axis=0)


class _Acc:
    """Accumulating wall-clock buckets reported as pipeline stages."""

    def __init__(self, timer):
        self.timer = timer
        self.buckets: dict = {}

    def add(self, name: str, seconds: float):
        self.buckets[name] = self.buckets.get(name, 0.0) + seconds

    def flush(self, order):
        for name in order:
            if name in self.buckets:
                self.timer.stages.append((name, self.buckets[name]))


def stabilize_streamed(
    input_path: str,
    output_path: str,
    adaptive_weights_definition: int,
    config: MeshFlowConfig,
    key: jax.Array,
    timer,
    chunk: int = 64,
    checkpoint_dir: str | None = None,
):
    """Streaming stabilize: returns (cropping_ratio, distortion, stability).

    Requires the native fused renderer (host_render.available()).

    checkpoint_dir persists pass-1 motion state (checkpoint.py): a rerun
    of the same clip/config — including under a different variant, which
    only changes the solver — resumes at the solve.
    """
    from meshflow import checkpoint as ckpt_mod
    from meshflow.kernels.fast import Keypoints

    info = video_io.probe_video(input_path)
    h, w = info.height, info.width
    num_frames = info.num_frames
    chunk = min(chunk, max(num_frames, 2))
    acc = _Acc(timer)

    # Track geometry (motion/trackscale.py): all tracking stages run at
    # (th, tw); results scale back to (h, w) right after the pair scan.
    d_track = config.resolve_track_downscale(h, w)
    th, tw = config.track_shape(h, w)
    sx, sy = w / tw, h / th

    ckpt_path = None
    loaded = None
    if checkpoint_dir:
        seed_key = int(np.asarray(jax.random.key_data(key)).ravel()[-1])
        ckpt_path = ckpt_mod.cache_path(
            checkpoint_dir, input_path, config, seed_key
        )
        loaded = ckpt_mod.load_motion(ckpt_path)
        if loaded is not None and loaded.displacements.shape[0] != num_frames:
            loaded = None

    # Keep decoded frames resident in device memory across passes (up to
    # frame_budget_bytes), so the metric pass reads device memory instead
    # of re-crossing the host->device link with the whole clip a second
    # time.  Residency is a prefix of the clip: frames past the budget are
    # re-uploaded in pass 2 (graceful degradation on long/high-res clips
    # instead of an all-or-nothing switch).
    frame_budget = frame_budget_bytes()
    keep_frames = loaded is None

    # Keep pass-1's decoded batches in host RAM so pass 2 skips the second
    # decode of the whole clip.  All-or-nothing on the clip's full size: a prefix cache would
    # still force a sequential re-decode to reach the tail.  The reader
    # allocates a fresh array per read, so retaining the batches is
    # zero-copy.  Resumed runs (loaded motion) have no pass 1 to piggyback
    # on; they decode in pass 2 as before.  The default budget is capped
    # at a quarter of physical RAM so the cache never turns the O(chunk)
    # pipeline into an OOM on small hosts (explicit
    # MESHFLOW_HOST_FRAME_CACHE_GB overrides the cap; 0 disables).
    _os_mod = __import__("os")
    env_cache = _os_mod.environ.get("MESHFLOW_HOST_FRAME_CACHE_GB")
    if env_cache is not None:
        cache_budget = int(float(env_cache) * (1 << 30))
    else:
        cache_budget = 8 << 30
        try:
            ram = (
                _os_mod.sysconf("SC_PHYS_PAGES")
                * _os_mod.sysconf("SC_PAGE_SIZE")
            )
            cache_budget = min(cache_budget, ram // 4)
        except (ValueError, OSError, AttributeError):
            pass
    host_cache: "list[np.ndarray] | None" = (
        []
        if loaded is None
        and 0 < num_frames * h * w * 3 <= cache_budget
        else None
    )

    if loaded is not None:
        motion = MotionEstimate(
            displacements=jnp.asarray(loaded.displacements),
            homographies=jnp.asarray(loaded.homographies),
            pair_ok=jnp.asarray(loaded.pair_ok),
        )
        keypoints = Keypoints(
            positions=jnp.asarray(loaded.kp_positions),
            scores=jnp.asarray(loaded.kp_scores),
            valid=jnp.asarray(loaded.kp_valid),
        )
        frame_parts = []
        return _solve_and_render(
            input_path, output_path, adaptive_weights_definition, config,
            key, timer, chunk, acc, info, motion, keypoints, frame_parts,
            keep_frames, None,
        )

    # ---- pass 1: windows of `chunk` frames, stride chunk-1 (1-frame halo)
    import collections

    reader = ChunkReader(input_path)
    halo_np = None
    kps_parts = []  # device keypoint pytrees, one per window (new frames only)
    frame_parts = []  # (global_start, device frames) prefix kept on device
    kept_bytes = 0
    next_keep = 0  # parts are contiguous from frame 0
    vel_parts, homo_parts, ok_parts = [], [], []
    pair_base = 0
    key_motion = jax.random.fold_in(key, 1)
    # Bound async dispatch depth: each in-flight window pins its frames +
    # pyramid planes in device memory (hundreds of MB at high
    # resolutions), so only
    # a couple of windows may be queued at once.  MESHFLOW_INFLIGHT=1
    # halves the planes working set for memory-tight high-res runs.
    max_inflight = int(
        __import__("os").environ.get("MESHFLOW_INFLIGHT", "2")
    )
    inflight: "collections.deque" = collections.deque()
    while True:
        t0 = time.perf_counter()
        want = chunk if halo_np is None else chunk - 1
        batch = reader.read(want)
        acc.add("decode", time.perf_counter() - t0)
        if batch.shape[0] == 0:
            break
        if host_cache is not None:
            host_cache.append(batch)
        t0 = time.perf_counter()
        batch = to_track_planes(trackscale.box_downscale_host(batch, d_track), config)
        window_np = (
            batch
            if halo_np is None
            else np.concatenate([halo_np, batch], axis=0)
        )
        n_win = window_np.shape[0]
        halo_np = window_np[-1:]
        frames_c = jnp.asarray(_pad_frames(window_np, chunk))
        acc.add("host->device", time.perf_counter() - t0)

        t0 = time.perf_counter()
        kps_c, _ = prepare_frames(frames_c, config)
        new0 = n_win - batch.shape[0]
        kps_parts.append(
            (jax.tree.map(lambda a: a[new0:n_win], kps_c), batch.shape[0])
        )
        if keep_frames and kept_bytes < frame_budget:
            part = frames_c[new0:n_win]
            frame_parts.append((next_keep, part))
            kept_bytes += part.size
            next_keep += part.shape[0]
        vel, homo, ok = pair_velocity_scan(
            kps_c, frames_c, key_motion,
            jnp.asarray(pair_base, jnp.int32), config, th, tw,
        )
        real_pairs = min(chunk - 1, max(num_frames - 1 - pair_base, 0))
        real_pairs = min(real_pairs, n_win - 1)
        vel_parts.append(vel[:real_pairs])
        homo_parts.append(homo[:real_pairs])
        ok_parts.append(ok[:real_pairs])
        pair_base += real_pairs
        inflight.append(vel)
        if len(inflight) > max_inflight:
            jax.block_until_ready(inflight.popleft())
        acc.add("detect+motion (dispatch)", time.perf_counter() - t0)
    reader.close(check=True)

    t0 = time.perf_counter()
    velocities = jnp.concatenate(vel_parts, axis=0)
    homographies = jnp.concatenate(homo_parts, axis=0)
    pair_ok = jnp.concatenate(ok_parts, axis=0)
    motion = integrate_velocities(velocities, homographies, pair_ok)
    if d_track > 1:
        # Scale AFTER integration (bit-identical to the in-memory path,
        # which scales the integrated displacements).
        motion = motion._replace(
            displacements=trackscale.scale_velocities(
                motion.displacements, sx, sy
            ),
            homographies=trackscale.conjugate_homographies(
                motion.homographies, sx, sy
            ),
        )
    keypoints = jax.tree.map(
        lambda *parts: jnp.concatenate(parts, axis=0),
        *[p for p, _ in kps_parts],
    )
    jax.block_until_ready(motion.displacements)
    acc.add("motion (sync)", time.perf_counter() - t0)

    if ckpt_path:
        from meshflow import checkpoint as ckpt_mod

        ckpt_mod.save_motion(
            ckpt_path,
            ckpt_mod.MotionCheckpoint(
                displacements=np.asarray(motion.displacements),
                homographies=np.asarray(motion.homographies),
                pair_ok=np.asarray(motion.pair_ok),
                kp_positions=np.asarray(keypoints.positions),
                kp_scores=np.asarray(keypoints.scores),
                kp_valid=np.asarray(keypoints.valid),
            ),
        )

    return _solve_and_render(
        input_path, output_path, adaptive_weights_definition, config,
        key, timer, chunk, acc, info, motion, keypoints, frame_parts,
        keep_frames, host_cache,
    )


def _solve_and_render(
    input_path,
    output_path,
    adaptive_weights_definition,
    config,
    key,
    timer,
    chunk,
    acc,
    info,
    motion,
    keypoints,
    frame_parts,
    keep_frames,
    host_cache,
):
    """Solver + crop + pass 2 (shared by the fresh and resumed paths)."""
    h, w = info.height, info.width
    d_track = config.resolve_track_downscale(h, w)
    th, tw = config.track_shape(h, w)

    # ---- solve
    t0 = time.perf_counter()
    lambdas = adaptive_weights(
        motion.homographies, w, h, adaptive_weights_definition
    )
    stab_disp = jacobi_smooth(
        motion.displacements,
        lambdas,
        config.temporal_smoothing_radius,
        config.optimization_num_iterations,
    )
    du_np = np.asarray(motion.displacements)
    ds_np = np.asarray(stab_disp)
    acc.add("solver", time.perf_counter() - t0)

    # ---- global crop from displacement fields alone
    t0 = time.perf_counter()
    crop = host_render.crop_edges_host(du_np, ds_np, h, w, config)
    crop_dev = jnp.asarray(crop, jnp.int32)
    acc.add("crop scan (host)", time.perf_counter() - t0)

    # ---- pass 2: re-decode -> fused warp+crop -> encode + metrics.
    # CPU work (decode/warp/encode) runs in a producer thread; the main
    # thread drives uploads + the device metric tracker, so host warp of
    # chunk k overlaps device metrics of chunk k-1.
    res_end = resident_end(frame_parts) if keep_frames else 0
    # Metric-pass frame source (see api.py): "device" derives the cropped
    # frames on device from the unstab frames + displacement fields (no
    # cropped-clip upload; <=1 LSB from the encoded pixels), "upload"
    # ships the host-rendered pixels (r2 behavior).
    import os as _os

    metric_src = _os.environ.get("MESHFLOW_METRIC_SRC", "device")
    if d_track > 1:
        # Track geometry: the metric pass compares the d-downscaled
        # original against the d-downscaled output video, so the producer
        # ships tiny track planes of each cropped chunk (~1/(d*d) of the
        # pixel volume) instead of deriving full-resolution cropped frames
        # on device.  This measures the real encoded pixels, like the
        # reference (meshflowstabilizer.py:1195-1197).
        metric_src = "track"
    # Serving mode (config.compute_metrics = False): pass 2 still warps,
    # crops, and encodes every frame (bit-identical output), but no
    # metric items are built or dispatched — the consumer drains the
    # queue so the host pipeline's flow control is unchanged.
    do_metrics = config.compute_metrics
    unstab_grid = None
    if do_metrics and metric_src == "device":
        from meshflow.render.stabilize import (
            crop_frames as _crop_frames_dev,
            render_stabilized as _render_stabilized_dev,
        )
        from meshflow.utils import grid as _grid

        unstab_grid = jnp.asarray(_grid.vertex_grid(config, h, w))
        stab_disp_dev = stab_disp
        du_dev = motion.displacements
    writer = StreamWriter(
        output_path, w, h, info.fps, info.fourcc, info.num_frames
    )
    key_metrics = jax.random.fold_in(key, 2)
    ratio_parts, dist_parts = [], []

    import collections
    import queue as _queue
    import threading

    inflight: "collections.deque" = collections.deque()

    work: "_queue.Queue" = _queue.Queue(maxsize=2)
    producer_error = []
    cancel = threading.Event()  # consumer died: unblock + stop the producer

    def _qput(q, item) -> bool:
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.25)
                return True
            except _queue.Full:
                continue
        return False

    def _put(item) -> bool:
        return _qput(work, item)

    def _sentinel(q):
        """Deliver the end-of-stream None even mid-abort.

        A stage's error path sets cancel (to unblock the other stages'
        _qput waits), which would also swallow its own finally-sentinel
        and leave the downstream get() blocked forever.  The sentinel is
        therefore cancel-exempt; if the queue is full AFTER cancel the
        downstream stage has stopped draining, so stale items are
        evicted to make room (the normal path never evicts: without
        cancel this is a plain blocking put).
        """
        while True:
            try:
                q.put(None, timeout=0.25)
                return
            except _queue.Full:
                if cancel.is_set():
                    try:
                        q.get_nowait()
                    except _queue.Empty:
                        pass

    # Host CPU pipelining: decode, warp+crop and encode each hold the CPU
    # for a large share of a 1080p frame's budget, so serially they cap
    # the host's fps whatever the device's speed.  With >= 2 cores the
    # three stages run in their own threads (each releases the GIL inside
    # libav/C++/cv2), bounded by the slowest stage instead of the sum.
    # On a 1-core host threading only adds contention, so the serial
    # producer is kept.  MESHFLOW_HOST_PIPELINE=serial|threaded
    # overrides the core-count auto.
    pipe_mode = _os.environ.get("MESHFLOW_HOST_PIPELINE", "auto")
    threaded = pipe_mode == "threaded" or (
        pipe_mode == "auto" and (_os.cpu_count() or 1) >= 2
    )

    def produce():
        # Frame source: pass-1's retained decoded batches when the whole
        # clip fit the host cache budget, else a second decode.
        reader2 = None if host_cache is not None else ChunkReader(input_path)
        cache_iter = iter(host_cache) if host_cache is not None else None
        start = 0
        # With device-derived metric frames the rendered pixels are consumed
        # synchronously by writer.write below, so one persistent buffer can
        # host every chunk's output (fresh chunk-scale allocations pay page
        # faults — see render.host._scratch).  With
        # uploaded metric frames the array is retained via the queue, so
        # each chunk must own its allocation.
        out_buf = None
        try:
            while not cancel.is_set():
                t0 = time.perf_counter()
                if cache_iter is not None:
                    batch = next(cache_iter, None)
                    if batch is None:
                        break
                else:
                    batch = reader2.read(chunk)
                acc.add("decode", time.perf_counter() - t0)
                n = batch.shape[0]
                if n == 0:
                    break
                t0 = time.perf_counter()
                out_view = None
                if metric_src in ("device", "track"):
                    # cropped pixels are consumed synchronously below (the
                    # queue retains at most a small downscaled copy), so one
                    # persistent buffer can host every chunk's output.
                    if out_buf is None or out_buf.shape[0] < n:
                        out_buf = np.empty_like(batch)
                    out_view = out_buf[:n]
                cropped_np = host_render.render_cropped_host(
                    batch,
                    du_np[start : start + n],
                    ds_np[start : start + n],
                    crop,
                    config,
                    out=out_view,
                )
                if not do_metrics:
                    cropped_item = None
                elif metric_src == "track":
                    cropped_item = to_track_planes(
                        trackscale.box_downscale_host(cropped_np, d_track),
                        config,
                    )
                elif metric_src == "device":
                    cropped_item = None
                else:
                    cropped_item = cropped_np
                acc.add("warp+crop (host)", time.perf_counter() - t0)
                t0 = time.perf_counter()
                writer.write(cropped_np)
                acc.add("encode", time.perf_counter() - t0)
                if not _put(
                    (
                        start,
                        None
                        if (not do_metrics or start + n <= res_end)
                        else to_track_planes(
                            trackscale.box_downscale_host(batch, d_track),
                            config,
                        ),
                        cropped_item,
                        n,
                    )
                ):
                    return
                start += n
        except BaseException as e:  # surfaced in the main thread
            producer_error.append(e)
        finally:
            if reader2 is not None:
                reader2.close()
            _sentinel(work)

    # ---- threaded 3-stage producer (decode | warp+crop | encode) ----
    q_dec: "_queue.Queue" = _queue.Queue(maxsize=2)
    q_enc: "_queue.Queue" = _queue.Queue(maxsize=2)
    buf_pool: "_queue.Queue" = _queue.Queue()

    def decode_stage():
        reader2 = None if host_cache is not None else ChunkReader(input_path)
        cache_iter = iter(host_cache) if host_cache is not None else None
        start = 0
        try:
            while not cancel.is_set():
                t0 = time.perf_counter()
                if cache_iter is not None:
                    batch = next(cache_iter, None)
                    if batch is None:
                        break
                else:
                    batch = reader2.read(chunk)
                acc.add("decode", time.perf_counter() - t0)
                if batch.shape[0] == 0:
                    break
                if not _qput(q_dec, (start, batch)):
                    return
                start += batch.shape[0]
        except BaseException as e:
            producer_error.append(e)
            cancel.set()
        finally:
            if reader2 is not None:
                reader2.close()
            _sentinel(q_dec)

    def warp_stage():
        try:
            while not cancel.is_set():
                item = q_dec.get()
                if item is None:
                    break
                start, batch = item
                n = batch.shape[0]
                t0 = time.perf_counter()
                out_view = None
                buf = None
                if metric_src in ("device", "track"):
                    # Rotating buffer ring: encode recycles buffers after
                    # the writer consumes them, so warp of chunk k+1 never
                    # overwrites pixels encode is still reading of chunk k.
                    try:
                        buf = buf_pool.get_nowait()
                    except _queue.Empty:
                        buf = np.empty(
                            (chunk,) + batch.shape[1:], batch.dtype
                        )
                    out_view = buf[:n]
                cropped_np = host_render.render_cropped_host(
                    batch,
                    du_np[start : start + n],
                    ds_np[start : start + n],
                    crop,
                    config,
                    out=out_view,
                )
                planes = (
                    None
                    if (not do_metrics or start + n <= res_end)
                    else to_track_planes(
                        trackscale.box_downscale_host(batch, d_track), config
                    )
                )
                acc.add("warp+crop (host)", time.perf_counter() - t0)
                if not _qput(q_enc, (start, planes, cropped_np, n, buf)):
                    return
        except BaseException as e:
            producer_error.append(e)
            cancel.set()
        finally:
            _sentinel(q_enc)

    def encode_stage():
        try:
            while not cancel.is_set():
                item = q_enc.get()
                if item is None:
                    break
                start, planes, cropped_np, n, buf = item
                t0 = time.perf_counter()
                writer.write(cropped_np)
                if not do_metrics:
                    cropped_item = None
                elif metric_src == "track":
                    # Downscale before recycling the buffer: the queue
                    # retains only this small copy of the cropped pixels.
                    cropped_item = to_track_planes(
                        trackscale.box_downscale_host(cropped_np, d_track),
                        config,
                    )
                elif metric_src == "device":
                    cropped_item = None
                else:
                    cropped_item = cropped_np
                acc.add("encode", time.perf_counter() - t0)
                if buf is not None:
                    # Pixels are in the encoder now; recycle the buffer.
                    buf_pool.put(buf)
                if not _put((start, planes, cropped_item, n)):
                    return
        except BaseException as e:
            producer_error.append(e)
            cancel.set()
        finally:
            _sentinel(work)

    if threaded:
        threads = [
            threading.Thread(target=fn, daemon=True)
            for fn in (decode_stage, warp_stage, encode_stage)
        ]
        for t in threads:
            t.start()
    else:
        threads = [threading.Thread(target=produce, daemon=True)]
        threads[0].start()
    try:
        while True:
            item = work.get()
            if item is None:
                break
            start, batch, cropped_np, n = item
            if not do_metrics:
                continue  # serving mode: drain for flow control only
            t0 = time.perf_counter()
            if batch is None:
                unstab_c = _pad_dev(
                    resident_slice(frame_parts, start, n), chunk
                )
            else:
                unstab_c = _pad_dev(jnp.asarray(batch), chunk)
            if metric_src == "device":
                stab_c, _ = _render_stabilized_dev(
                    unstab_c,
                    _pad_dev(du_dev[start : start + n], chunk),
                    _pad_dev(stab_disp_dev[start : start + n], chunk),
                    unstab_grid,
                    config,
                    h,
                    w,
                )
                cropped_c = _crop_frames_dev(stab_c, crop_dev, h, w)
            elif metric_src == "track":
                # already track planes (downscaled in the producer)
                cropped_c = _pad_dev(jnp.asarray(cropped_np), chunk)
            else:
                cropped_c = _pad_dev(
                    jnp.asarray(to_track_planes(cropped_np, config)), chunk
                )
            kps_c = jax.tree.map(
                lambda a: _pad_dev(
                    jax.lax.dynamic_slice_in_dim(a, start, n, axis=0), chunk
                ),
                keypoints,
            )
            r, d = cropping_and_distortion_scanned(
                kps_c, unstab_c, cropped_c, key_metrics,
                jnp.asarray(start, jnp.int32), config, th, tw,
            )
            ratio_parts.append(r[:n])
            dist_parts.append(d[:n])
            inflight.append(r)
            if len(inflight) > 2:
                jax.block_until_ready(inflight.popleft())
            acc.add("metrics (dispatch)", time.perf_counter() - t0)
    except BaseException:
        # Unblock the producer stages (they may be waiting on full
        # queues), then release the encoder/reader before propagating.
        cancel.set()
        for q in (work, q_dec, q_enc):
            while True:
                try:
                    q.get_nowait()
                except _queue.Empty:
                    break
        for t in threads:
            t.join(timeout=10.0)
        try:
            writer.close()
        except IOError:
            pass  # the original error is the one to surface
        raise
    for t in threads:
        t.join()
    if producer_error:
        raise producer_error[0]
    t0 = time.perf_counter()
    writer.close()
    acc.add("encode", time.perf_counter() - t0)

    t0 = time.perf_counter()
    if do_metrics:
        cropping_ratio = jnp.mean(jnp.concatenate(ratio_parts))
        distortion_score = jnp.min(jnp.concatenate(dist_parts))
    else:
        cropping_ratio = jnp.asarray(float("nan"), jnp.float32)
        distortion_score = jnp.asarray(float("nan"), jnp.float32)
    stability = stability_score(stab_disp)
    jax.block_until_ready((cropping_ratio, distortion_score, stability))
    acc.add("metrics (sync)", time.perf_counter() - t0)

    acc.flush(
        [
            "decode",
            "host->device",
            "detect+motion (dispatch)",
            "motion (sync)",
            "solver",
            "crop scan (host)",
            "warp+crop (host)",
            "encode",
            "metrics (dispatch)",
            "metrics (sync)",
        ]
    )
    return (
        float(cropping_ratio),
        float(distortion_score),
        float(stability),
    )
