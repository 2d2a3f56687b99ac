"""Public API: the reference's MeshFlowStabilizer, accelerator-native inside.

Signature, constants, return tuple, and exception behavior match
/root/reference/meshflowstabilizer.py:43-169; the implementation runs the
eight-stage pipeline as batched device compute:

1. host decode (io.video)                      — :148 / :172-213
2. motion estimation scan (motion.pipeline)    — :149 / :236-284
3. adaptive weights + banded Jacobi (solver)   — :150-153 / :632-878
4. one-pass mesh warp + crop detect (render)   — :154-158 / :909-1108
5. crop + stretch (render)                     — :159 / :1111-1157
6. cropping ratio + distortion (metrics)       — :161 / :1160-1212
7. stability score (metrics)                   — :162 / :1216-1259
8. host encode (io.video)                      — :164 / :1290-1322
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from meshflow import config as cfg
from meshflow.config import MeshFlowConfig, validate_adaptive_weights_definition
from meshflow.io import video as video_io
from meshflow.metrics.quality import (
    cropping_and_distortion_scanned,
    stability_score,
)
from meshflow.motion.pipeline import estimate_motion_chunked, prepare_frames
from meshflow.render.stabilize import crop_frames, render_stabilized
from meshflow.solver.jacobi import jacobi_smooth
from meshflow.solver.weights import adaptive_weights
from meshflow.utils import grid
from meshflow.utils.profiling import StageTimer


def _use_host_render(config: MeshFlowConfig) -> bool:
    """Render routing: native C++ host warp vs on-device warp (see the
    comment in _stabilize_frames; MESHFLOW_RENDER=auto|host|device)."""
    import os as _os

    from meshflow.render import host as host_render

    mode = _os.environ.get("MESHFLOW_RENDER", "auto")
    return host_render.available() if mode == "auto" else mode == "host"


class MeshFlowStabilizer:
    """Drop-in replacement for the reference class (same constructor
    keywords, defaults, constants, and stabilize() contract)."""

    ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL = cfg.ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL
    ADAPTIVE_WEIGHTS_DEFINITION_FLIPPED = cfg.ADAPTIVE_WEIGHTS_DEFINITION_FLIPPED
    ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH = (
        cfg.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH
    )
    ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW = (
        cfg.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW
    )
    ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH_VALUE = (
        cfg.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH_VALUE
    )
    ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW_VALUE = (
        cfg.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW_VALUE
    )

    def __init__(
        self,
        mesh_row_count=16,
        mesh_col_count=16,
        mesh_outlier_subframe_row_count=4,
        mesh_outlier_subframe_col_count=4,
        feature_ellipse_row_count=10,
        feature_ellipse_col_count=10,
        homography_min_number_corresponding_features=4,
        temporal_smoothing_radius=10,
        optimization_num_iterations=100,
        color_outside_image_area_bgr=(0, 0, 255),
        visualize=False,
        config: MeshFlowConfig | None = None,
        seed: int = 0,
        checkpoint_dir: str | None = None,
        track_planes: str | None = None,
        compute_metrics: bool | None = None,
    ):
        if config is None:
            config = MeshFlowConfig(
                mesh_row_count=mesh_row_count,
                mesh_col_count=mesh_col_count,
                mesh_outlier_subframe_row_count=mesh_outlier_subframe_row_count,
                mesh_outlier_subframe_col_count=mesh_outlier_subframe_col_count,
                feature_ellipse_row_count=feature_ellipse_row_count,
                feature_ellipse_col_count=feature_ellipse_col_count,
                homography_min_number_corresponding_features=(
                    homography_min_number_corresponding_features
                ),
                temporal_smoothing_radius=temporal_smoothing_radius,
                optimization_num_iterations=optimization_num_iterations,
                color_outside_image_area_bgr=tuple(color_outside_image_area_bgr),
                visualize=visualize,
            )
        # Tracking-plane transport ("bgr" reference-parity default /
        # "gray" 3x-lighter).  Priority: explicit constructor argument >
        # MESHFLOW_TRACK_PLANES env (benchmarks / CLI-less callers) >
        # the config's own field.
        import os as _env_os

        if track_planes is None:
            track_planes = _env_os.environ.get("MESHFLOW_TRACK_PLANES")
        if track_planes and track_planes != config.track_planes:
            import dataclasses as _dc

            config = _dc.replace(config, track_planes=track_planes)
        # Serving mode (skip the cropping/distortion evaluation pass —
        # see the config field's docstring).  Priority: constructor
        # argument > MESHFLOW_COMPUTE_METRICS env (0 disables) > config.
        if compute_metrics is None:
            env_cm = _env_os.environ.get("MESHFLOW_COMPUTE_METRICS")
            if env_cm is not None:
                compute_metrics = env_cm not in ("0", "false", "no")
        if compute_metrics is not None and (
            compute_metrics != config.compute_metrics
        ):
            import dataclasses as _dc

            config = _dc.replace(config, compute_metrics=compute_metrics)
        self.config = config
        self.visualize = config.visualize
        self._key = jax.random.PRNGKey(seed)
        # Checkpoint/resume (streaming path): persists pass-1 motion state
        # so reruns — including other variants of the same clip — resume
        # at the solver.  Constructor arg wins over the env var.
        import os as _os

        self.checkpoint_dir = (
            checkpoint_dir
            if checkpoint_dir is not None
            else _os.environ.get("MESHFLOW_CHECKPOINT_DIR") or None
        )

    # ------------------------------------------------------------------
    def stabilize(
        self,
        input_path: str,
        output_path: str,
        adaptive_weights_definition: int = cfg.ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL,
    ):
        """Stabilize input_path -> output_path; returns
        (cropping_ratio, distortion_score, stability_score)."""
        validate_adaptive_weights_definition(adaptive_weights_definition)
        config = self.config
        timer = StageTimer()
        # Exposed for benchmarks: per-stage wall clock of the last run.
        self.last_timer = timer

        # Streaming two-pass pipeline: O(chunk) pixel residency, decode
        # overlapped with device compute (SURVEY §7 host<->device
        # streaming; the reference materializes everything,
        # meshflowstabilizer.py:201-209).  Results are identical to the
        # in-memory host-render path.  Visualize needs all frames in RAM,
        # so it takes the in-memory path.
        import os as _os

        from meshflow.render import host as _host_render

        stream_mode = _os.environ.get("MESHFLOW_STREAM", "auto")
        if stream_mode == "auto":
            use_stream = (
                _host_render.available() and not self.visualize
            )
        elif stream_mode == "1":
            # Forced streaming still needs its preconditions: the fused
            # native renderer, and no visualize (streaming never holds the
            # whole clip the display loop needs).
            if not _host_render.available():
                raise RuntimeError(
                    "MESHFLOW_STREAM=1 requires the native renderer "
                    "(scripts/build_native.sh); it is not available."
                )
            if self.visualize:
                raise RuntimeError(
                    "MESHFLOW_STREAM=1 is incompatible with visualize=True "
                    "(the streaming pipeline does not retain frames); "
                    "unset one of them."
                )
            use_stream = True
        else:
            use_stream = False
        if use_stream:
            from meshflow import streaming

            result = streaming.stabilize_streamed(
                input_path,
                output_path,
                adaptive_weights_definition,
                config,
                self._key,
                timer,
                chunk=self.CHUNK,
                checkpoint_dir=self.checkpoint_dir,
            )
            timer.report()
            return result

        # Gray transport ships single-plane frames to the device; the
        # output video still needs BGR pixels, which then must come from
        # the native host renderer.  Config-only precondition: fail here,
        # before any decode/upload/compute is spent.
        if config.track_planes == "gray" and (
            not _host_render.available()
            or _os.environ.get("MESHFLOW_RENDER", "auto") == "device"
        ):
            raise RuntimeError(
                "track_planes='gray' requires the native host renderer "
                "(scripts/build_native.sh, and not MESHFLOW_RENDER=device)."
            )
        with timer.stage("decode"):
            frames_np, info = video_io.read_video(input_path)
        num_frames, h, w = frames_np.shape[:3]
        with timer.stage("host->device"):
            from meshflow import streaming as _streaming
            from meshflow.motion import trackscale as _trackscale

            # Track geometry (motion/trackscale.py): when the host renderer
            # will produce the output pixels, only the d-downscaled track
            # planes ever cross the wire; the device-render route uploads
            # full frames (it needs them for the warp) and derives the
            # track planes on device.
            d_track = config.resolve_track_downscale(h, w)
            if d_track > 1 and _use_host_render(config):
                upload_np = _trackscale.box_downscale_host(frames_np, d_track)
            else:
                upload_np = frames_np
            frames = jnp.asarray(
                _streaming.to_track_planes(upload_np, config)
            )
            jax.block_until_ready(frames)

        # Host-render path reuses the decoded numpy frames rather than
        # pulling pixels back off the device.
        self._frames_np_cache = frames_np
        try:
            result = self._stabilize_frames(
                frames, adaptive_weights_definition, h, w, timer
            )
        finally:
            self._frames_np_cache = None
        cropped, cropping_ratio, distortion_score, stability = result

        with timer.stage("device->host"):
            cropped_np = (
                cropped
                if isinstance(cropped, np.ndarray)
                else np.asarray(cropped)
            )
        with timer.stage("encode"):
            video_io.write_video(output_path, cropped_np, info.fps, info.fourcc)
        timer.report()

        if self.visualize:
            self._display_loop(frames_np, cropped_np, info.fps)

        return (
            float(cropping_ratio),
            float(distortion_score),
            float(stability),
        )

    # ------------------------------------------------------------------
    # Frame-axis chunk size: one compiled scan per (H, W, config) serves any
    # clip length, and the device working set (pyramids, tracker windows,
    # render buffers) is bounded by a chunk at any clip length and
    # resolution.
    CHUNK = 64

    def _stabilize_frames(
        self, frames, adaptive_weights_definition, h, w, timer=None
    ):
        """Device pipeline: (F, H, W, 3) uint8 -> (cropped frames, metrics)."""
        config = self.config
        timer = timer or StageTimer(enabled=False)
        num_frames = frames.shape[0]
        # Short clips use one exact-size chunk (no padding waste); long
        # clips amortize a single CHUNK-size compilation.
        chunk = min(self.CHUNK, num_frames)
        unstab_grid = jnp.asarray(grid.vertex_grid(config, h, w))

        # Track geometry (motion/trackscale.py): tracking stages run at
        # (th, tw).  `frames` arrives either already downscaled (host-render
        # route: only track planes were uploaded) or at full resolution
        # (device-render route), detected by shape.
        from meshflow.motion import trackscale

        d_track = config.resolve_track_downscale(h, w)
        th, tw = config.track_shape(h, w)
        frames_full = None
        if frames.shape[1] == h and frames.shape[2] == w:
            frames_full = frames
            frames_track = (
                trackscale.to_track_planes_dev(frames, config)
                if d_track > 1
                else frames
            )
        else:
            frames_track = frames
        sx, sy = w / tw, h / th

        with timer.stage("detect"):
            keypoints, _ = prepare_frames(frames_track, config)
            jax.block_until_ready(keypoints.valid)
        with timer.stage("motion"):
            motion = estimate_motion_chunked(
                keypoints, frames_track, jax.random.fold_in(self._key, 1),
                config, th, tw,
                chunk_pairs=max(chunk - 1, 1),
            )
            if d_track > 1:
                motion = motion._replace(
                    displacements=trackscale.scale_velocities(
                        motion.displacements, sx, sy
                    ),
                    homographies=trackscale.conjugate_homographies(
                        motion.homographies, sx, sy
                    ),
                )
            jax.block_until_ready(motion.displacements)

        with timer.stage("solver"):
            lambdas = adaptive_weights(
                motion.homographies, w, h, adaptive_weights_definition
            )
            stab_disp = jacobi_smooth(
                motion.displacements,
                lambdas,
                config.temporal_smoothing_radius,
                config.optimization_num_iterations,
            )
            jax.block_until_ready(stab_disp)

        # Render routing.  "device": warp/crop on the accelerator (pixels
        # stay on device until the final copy for the encoder).  "host":
        # fetch only the tiny displacement fields and run the native C++
        # warp next to the encoder; the metric pass re-derives or uploads
        # what it needs.  "auto": host when the native warp library builds
        # on this host.  Which route should win where is open (ROADMAP
        # speed item 3); the rule stays until the benchmark decides it.
        import os as _os

        from meshflow.render import host as host_render

        use_host = _use_host_render(config)
        if config.track_planes == "gray" and not (
            use_host and host_render.available()
        ):
            raise RuntimeError(
                "track_planes='gray' keeps only single-plane frames on "
                "device; rendering needs the native host renderer "
                "(MESHFLOW_RENDER=host + scripts/build_native.sh)."
            )
        if use_host and host_render.available():
            with timer.stage("warp+crop (host)"):
                du_np = np.asarray(motion.displacements)
                ds_np = np.asarray(stab_disp)
                frames_np = getattr(self, "_frames_np_cache", None)
                # Compare the frame count only: under track_planes="gray"
                # and/or track geometry the device frames are single-plane
                # and/or downscaled while the host cache keeps the full
                # BGR pixels the renderer needs.
                if frames_np is None or frames_np.shape[0] != num_frames:
                    if config.track_planes == "gray" or d_track > 1:
                        raise RuntimeError(
                            "track_planes='gray' / track_downscale > 1 "
                            "require the decoded BGR frames on host (no "
                            "full-resolution device copy exists)."
                        )
                    frames_np = np.asarray(frames)
                stabilized_np, crop_np = host_render.render_stabilized_host(
                    frames_np, du_np, ds_np, config
                )
                cropped_np = host_render.crop_frames_host(stabilized_np, crop_np)

            if not config.compute_metrics:
                # Serving mode (config.compute_metrics): skip the
                # cropping/distortion pass; stability is ~free.
                stability = stability_score(stab_disp)
                jax.block_until_ready(stability)
                nan = jnp.asarray(float("nan"), jnp.float32)
                return cropped_np, nan, nan, stability

            # Metric-pass frame source.  "device" (default) re-derives the
            # cropped frames on device from the already-resident unstab
            # frames + displacement fields — the host-rendered twin differs
            # by <=1 LSB on <0.5% of pixels (bilinear rounding,
            # tests/test_host_render.py), while the upload of a full clip
            # volume disappears.  "upload" ships the exact encoded pixels
            # (r2 behavior).
            metric_src = _os.environ.get("MESHFLOW_METRIC_SRC", "device")
            if d_track > 1:
                # Track geometry: ship the downscaled cropped planes (tiny)
                # and compare downscaled-original vs downscaled-output, the
                # conjugate of the full-resolution metric homography.
                metric_src = "track"
            crop_dev = jnp.asarray(crop_np, jnp.int32)
            if metric_src == "track":
                from meshflow.streaming import to_track_planes

                with timer.stage("host->device (cropped)"):
                    cropped_dev = jnp.asarray(
                        to_track_planes(
                            trackscale.box_downscale_host(
                                cropped_np, d_track
                            ),
                            config,
                        )
                    )
            elif metric_src != "device":
                from meshflow.streaming import to_track_planes

                with timer.stage("host->device (cropped)"):
                    # Same plane layout as the unstab frames (gray mode
                    # tracks single-plane on both sides of the pair).
                    cropped_dev = jnp.asarray(
                        to_track_planes(cropped_np, config)
                    )

            timer_metrics = timer.stage("metrics")
            timer_metrics.__enter__()
            ratios = []
            distortions = []

            def pad_to(a, n):
                padding = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
                return jnp.pad(a, padding, mode="edge")

            for start in range(0, num_frames, chunk):
                stop = min(start + chunk, num_frames)
                kps_c = jax.tree.map(
                    lambda a: pad_to(a[start:stop], chunk), keypoints
                )
                unstab_c = pad_to(frames_track[start:stop], chunk)
                if metric_src == "device":
                    stab_c, _ = render_stabilized(
                        unstab_c,
                        pad_to(motion.displacements[start:stop], chunk),
                        pad_to(stab_disp[start:stop], chunk),
                        unstab_grid,
                        config,
                        h,
                        w,
                    )
                    cropped_c = crop_frames(stab_c, crop_dev, h, w)
                else:
                    cropped_c = pad_to(cropped_dev[start:stop], chunk)
                r, d = cropping_and_distortion_scanned(
                    kps_c,
                    unstab_c,
                    cropped_c,
                    jax.random.fold_in(self._key, 2),
                    jnp.asarray(start, jnp.int32),
                    config,
                    th,
                    tw,
                )
                ratios.append(r[: stop - start])
                distortions.append(d[: stop - start])
            cropping_ratio = jnp.mean(jnp.concatenate(ratios))
            distortion_score = jnp.min(jnp.concatenate(distortions))
            stability = stability_score(stab_disp)
            jax.block_until_ready((cropping_ratio, distortion_score, stability))
            timer_metrics.__exit__(None, None, None)
            return cropped_np, cropping_ratio, distortion_score, stability

        # Warp in fixed-size chunks; the video crop is the intersection of
        # the per-chunk crops (/root/reference/meshflowstabilizer.py:1102-1106).
        def pad_to(a, n):
            padding = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
            return jnp.pad(a, padding, mode="edge")

        if frames_full is None:
            raise RuntimeError(
                "on-device rendering needs full-resolution frames, but only "
                "track planes were uploaded (is MESHFLOW_RENDER=host set "
                "without the native renderer built?)"
            )
        timer_render = timer.stage("warp+crop")
        timer_render.__enter__()
        stabilized_chunks = []  # kept padded so crop_frames compiles once
        crops = []
        for start in range(0, num_frames, chunk):
            stop = min(start + chunk, num_frames)
            fr = pad_to(frames_full[start:stop], chunk)
            du = pad_to(motion.displacements[start:stop], chunk)
            ds = pad_to(stab_disp[start:stop], chunk)
            stab_chunk, crop_chunk = render_stabilized(
                fr, du, ds, unstab_grid, config, h, w
            )
            stabilized_chunks.append((stab_chunk, stop - start))
            # padded frames replicate real ones, so they never tighten the
            # crop beyond a real frame's value
            crops.append(crop_chunk)
        crops = jnp.stack(crops)
        crop = jnp.stack(
            [
                jnp.max(crops[:, 0]),
                jnp.max(crops[:, 1]),
                jnp.min(crops[:, 2]),
                jnp.min(crops[:, 3]),
            ]
        )
        cropped_chunks = [
            crop_frames(chunk_frames, crop, h, w)[:length]
            for chunk_frames, length in stabilized_chunks
        ]
        cropped = jnp.concatenate(cropped_chunks, axis=0)
        jax.block_until_ready(cropped)
        timer_render.__exit__(None, None, None)

        if not config.compute_metrics:
            # Serving mode (config.compute_metrics): skip the
            # cropping/distortion pass; stability is ~free.
            stability = stability_score(stab_disp)
            jax.block_until_ready(stability)
            nan = jnp.asarray(float("nan"), jnp.float32)
            return cropped, nan, nan, stability

        timer_metrics = timer.stage("metrics")
        timer_metrics.__enter__()
        ratios = []
        distortions = []
        for start in range(0, num_frames, chunk):
            stop = min(start + chunk, num_frames)
            kps_c = jax.tree.map(lambda a: pad_to(a[start:stop], chunk), keypoints)
            cropped_c = pad_to(cropped[start:stop], chunk)
            if d_track > 1:
                cropped_c = trackscale.to_track_planes_dev(cropped_c, config)
            r, d = cropping_and_distortion_scanned(
                kps_c,
                pad_to(frames_track[start:stop], chunk),
                cropped_c,
                jax.random.fold_in(self._key, 2),
                jnp.asarray(start, jnp.int32),
                config,
                th,
                tw,
            )
            ratios.append(r[: stop - start])
            distortions.append(d[: stop - start])
        ratios = jnp.concatenate(ratios)
        distortions = jnp.concatenate(distortions)
        cropping_ratio = jnp.mean(ratios)
        distortion_score = jnp.min(distortions)

        stability = stability_score(stab_disp)
        jax.block_until_ready((cropping_ratio, distortion_score, stability))
        timer_metrics.__exit__(None, None, None)
        return cropped, cropping_ratio, distortion_score, stability

    # ------------------------------------------------------------------
    def _display_loop(self, unstabilized, cropped, fps):
        """The reference's visualize loop
        (/root/reference/meshflowstabilizer.py:1262-1287): unstabilized over
        cropped, looping until Q."""
        import cv2

        ms_per_frame = int(1000 / fps) if fps > 0 else 33
        while True:
            for i in range(len(unstabilized)):
                cv2.imshow(
                    "unstabilized and stabilized video",
                    np.vstack((unstabilized[i], cropped[i])),
                )
                if cv2.waitKey(ms_per_frame) & 0xFF == ord("q"):
                    return
