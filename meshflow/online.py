"""Online (streaming) minimum-latency stabilization.

The paper behind the reference — "MeshFlow: Minimum Latency Online Video
Stabilization" — is an ONLINE method, but the reference implementation only
ships the offline whole-clip variant.  This module adds the paper's
sliding-window formulation (BASELINE.json config: "online low-latency
mode"): each incoming frame is stabilized using only the committed past, at
one frame of algorithmic latency.

Per frame t:

1. match/propagate against frame t-1 (same batched L2/L3 stack as the
   offline path) -> velocity -> unstabilized displacement c_t = c_{t-1}+v.
2. solve for p_t over a causal window of the last OMEGA committed
   stabilized displacements: iterate the same Jacobi update the offline
   solver uses, but only for the newest frame with past p_r frozen —
   p_t <- (c_t + 2 lambda_t sum_r w_{t,r} p_r) / (1 + 2 lambda_t sum_r w_{t,r})
   which is the energy's exact coordinate-descent step for p_t.
3. warp frame t by (p_t - c_t) with the one-pass mesh warp and apply a
   fixed crop ratio (an online system cannot know the future global crop;
   the paper pre-reserves a cropping margin).

The whole step is one jitted function over carried state, so steady-state
latency is one device step per frame.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from meshflow.config import MeshFlowConfig
from meshflow.kernels.color import bgr_to_gray
from meshflow.kernels.fast import detect_keypoints
from meshflow.motion.features import match_pair
from meshflow.motion.pipeline import tile_pyramid
from meshflow.motion.propagate import vertex_velocities
from meshflow.render.stabilize import (
    backward_map,
    crop_resize_frame,
    warp_frame,
)
from meshflow.solver.jacobi import gaussian_band
from meshflow.solver.weights import adaptive_weights
from meshflow.utils import grid


class OnlineState(NamedTuple):
    """Carried across steps.  prev_pyr/prev_kps cache the previous frame's
    pyramid and keypoints: each step's detection + pyramid build serves the
    NEXT step's tracking too, so steady-state device work is one frame's
    preparation per frame, not two (the r2 implementation re-detected and
    re-packed the previous frame every step)."""

    prev_pyr: tuple  # PaddedLevel tile pyramid of frame t-1
    prev_kps: object  # Keypoints pytree of frame t-1
    unstab_window: jnp.ndarray  # (OMEGA+1, R+1, C+1, 2) c_{t-OMEGA..t}
    stab_window: jnp.ndarray  # (OMEGA+1, R+1, C+1, 2) p_{t-OMEGA..t}
    step: jnp.ndarray  # () int32 frames processed so far


@functools.partial(
    jax.jit, static_argnames=("config", "frame_height", "frame_width")
)
def online_prepare(
    frame: jnp.ndarray,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
):
    """Per-frame preparation: (H, W, 3) uint8 -> (keypoints, pyramid)."""
    max_level = config.lk_max_level(frame_height, frame_width)
    gray = frame[..., 0] if frame.shape[-1] == 1 else bgr_to_gray(frame)
    kps = detect_keypoints(gray, config, frame_height, frame_width)
    return kps, tile_pyramid(frame, config, max_level)


@functools.partial(
    jax.jit,
    static_argnames=(
        "config",
        "frame_height",
        "frame_width",
        "adaptive_weights_definition",
        "crop_ratio",
    ),
)
def online_motion_solve(
    state: OnlineState,
    frame: jnp.ndarray,
    key: jax.Array,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
    adaptive_weights_definition: int = 0,
    crop_ratio: float = 0.8,
):
    """Motion + causal solve for one frame: (state, frame t) ->
    (new state, c_t, p_t).

    The stabilizing shift p_t - c_t is clamped per vertex to the reserved
    cropping margin, the paper's online-crop policy ("MeshFlow: Minimum
    Latency Online Video Stabilization" pre-reserves a margin and
    restricts the path update so the fixed crop never exposes border):
    a shift of +-margin moves content by exactly the strip the fixed crop
    discards, so any clamped warp keeps the crop window covered (exact
    for translation, conservative per-vertex for general mesh warps).
    """
    omega = config.temporal_smoothing_radius
    unstab_grid = jnp.asarray(grid.vertex_grid(config, frame_height, frame_width))

    # Prepare the CURRENT frame once; tracking consumes the cached previous
    # pyramid/keypoints, and the new ones ride along into the next state.
    cur_kps, cur_pyr = online_prepare(frame, config, frame_height, frame_width)
    kps = state.prev_kps
    match = match_pair(
        kps, state.prev_pyr, cur_pyr, jax.random.fold_in(key, state.step),
        config, frame_height, frame_width,
    )
    velocity = vertex_velocities(
        match, unstab_grid, config, frame_height, frame_width
    )

    c_t = state.unstab_window[-1] + velocity
    unstab_window = jnp.concatenate(
        [state.unstab_window[1:], c_t[None]], axis=0
    )

    lam = adaptive_weights(
        match.homography[None], frame_width, frame_height,
        adaptive_weights_definition,
    )[0]

    # Causal Gaussian weights over the last OMEGA committed frames.
    # Window slot i in past = stab_window[1:] holds p_{t-omega+i}, i.e.
    # distance d = omega - i from the new frame; g(d) = band[omega - d] =
    # band[i] by symmetry.  Slots for frames before the stream start are
    # masked out (frame index t - omega + i >= 0 with t = step + 1).
    band = gaussian_band(omega, jnp.float32)  # 2*omega+1 taps
    past_idx = jnp.arange(omega, dtype=jnp.int32)
    have = past_idx >= jnp.maximum(omega - state.step - 1, 0)
    wgt = jnp.where(have, band[:omega], 0.0)

    denom = 1.0 + 2.0 * lam * jnp.sum(wgt)
    past = state.stab_window[1:]  # p_{t-omega..t-1}
    weighted_past = jnp.sum(wgt[:, None, None, None] * past, axis=0)
    # Exact minimizer of the causal energy in p_t with the past frozen.
    p_t = (c_t + 2.0 * lam * weighted_past) / denom

    # Reserved-margin clamp: keep the stabilizing shift inside the strip
    # the fixed crop discards, so border never enters the crop window.
    margin_x, margin_y = _online_margins(frame_width, frame_height, crop_ratio)
    shift = p_t - c_t
    shift = jnp.clip(
        shift,
        jnp.asarray([-margin_x, -margin_y], jnp.float32),
        jnp.asarray([margin_x, margin_y], jnp.float32),
    )
    p_t = c_t + shift

    stab_window = jnp.concatenate([state.stab_window[1:], p_t[None]], axis=0)
    new_state = OnlineState(
        prev_pyr=cur_pyr,
        prev_kps=cur_kps,
        unstab_window=unstab_window,
        stab_window=stab_window,
        step=state.step + 1,
    )
    return new_state, c_t, p_t


def _online_margins(frame_width: int, frame_height: int, crop_ratio: float):
    return (
        int(round(frame_width * (1.0 - crop_ratio) / 2)),
        int(round(frame_height * (1.0 - crop_ratio) / 2)),
    )


def online_crop_rect(
    frame_width: int, frame_height: int, crop_ratio: float
) -> np.ndarray:
    """The fixed reserved-margin crop [left, top, right, bottom]."""
    margin_x, margin_y = _online_margins(frame_width, frame_height, crop_ratio)
    return np.asarray(
        [
            margin_x,
            margin_y,
            frame_width - 1 - margin_x,
            frame_height - 1 - margin_y,
        ],
        np.int32,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "config",
        "frame_height",
        "frame_width",
        "adaptive_weights_definition",
        "crop_ratio",
    ),
)
def online_step(
    state: OnlineState,
    frame: jnp.ndarray,
    key: jax.Array,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
    adaptive_weights_definition: int = 0,
    crop_ratio: float = 0.8,
):
    """One streaming step: (state, frame t) -> (new state, stabilized frame).

    Device-warp variant (pixels stay on device).  Deployments where
    pulling pixels off the accelerator is expensive should use
    OnlineMeshFlowStabilizer, which pulls only (c_t, p_t) and warps with
    the native host renderer.
    """
    unstab_grid = jnp.asarray(grid.vertex_grid(config, frame_height, frame_width))
    new_state, c_t, p_t = online_motion_solve(
        state, frame, key, config, frame_height, frame_width,
        adaptive_weights_definition, crop_ratio,
    )
    stab_pos = unstab_grid + (p_t - c_t)
    bmap = backward_map(stab_pos, unstab_grid, config, frame_height, frame_width)
    border = jnp.asarray(config.color_outside_image_area_bgr, jnp.float32)
    stabilized = warp_frame(frame, bmap, border)
    crop = jnp.asarray(
        online_crop_rect(frame_width, frame_height, crop_ratio), jnp.int32
    )
    out = crop_resize_frame(stabilized, crop, frame_height, frame_width)
    return new_state, out


class OnlineMeshFlowStabilizer:
    """Streaming stabilizer: feed frames, get stabilized frames back with
    one frame of latency (the first call returns the frame unchanged)."""

    def __init__(
        self,
        config: MeshFlowConfig | None = None,
        adaptive_weights_definition: int = 0,
        crop_ratio: float = 0.8,
        seed: int = 0,
    ):
        self.config = config or MeshFlowConfig()
        self.adaptive_weights_definition = adaptive_weights_definition
        self.crop_ratio = crop_ratio
        self._key = jax.random.PRNGKey(seed)
        self._state: OnlineState | None = None
        self._shape = None

    def process(self, frame: np.ndarray) -> np.ndarray:
        """frame: (H, W, 3) uint8 BGR -> stabilized (H, W, 3) uint8 BGR.

        When the native host renderer is built, only the tiny (c_t, p_t)
        displacement fields come off the device and the warp+crop runs as
        one fused host call — per-frame latency is then solve + a ~4 KB
        pull, not a frame-sized device->host transfer.
        """
        from meshflow.render import host as host_render

        h, w = frame.shape[:2]
        cfg = self.config
        # Gray transport: the device only ever sees tracking planes (the
        # stabilized output is warped from `frame` on the host), so
        # track_planes="gray" uploads a third of the bytes per frame —
        # upload is a large slice of online latency on bandwidth-bound
        # links.  Requires the host renderer, like the offline pipelines.
        if cfg.track_planes == "gray":
            if not host_render.available():
                raise RuntimeError(
                    "track_planes='gray' requires the native host renderer "
                    "(scripts/build_native.sh)."
                )
            from meshflow.streaming import to_track_planes

            device_frame = jnp.asarray(to_track_planes(frame[None], cfg)[0])
        else:
            device_frame = jnp.asarray(frame)
        if self._state is None:
            omega = cfg.temporal_smoothing_radius
            zeros = jnp.zeros(
                (omega + 1, cfg.vertex_rows, cfg.vertex_cols, 2), jnp.float32
            )
            kps0, pyr0 = online_prepare(device_frame, cfg, h, w)
            self._state = OnlineState(
                prev_pyr=pyr0,
                prev_kps=kps0,
                unstab_window=zeros,
                stab_window=zeros,
                step=jnp.asarray(0, jnp.int32),
            )
            self._shape = (h, w)
            return frame
        assert self._shape == (h, w), "frame size changed mid-stream"
        if host_render.available():
            self._state, c_t, p_t = online_motion_solve(
                self._state,
                device_frame,
                self._key,
                cfg,
                h,
                w,
                self.adaptive_weights_definition,
                self.crop_ratio,
            )
            both = np.asarray(jnp.stack([c_t, p_t]))  # one device pull
            du, ds = both[0][None], both[1][None]
            crop = online_crop_rect(w, h, self.crop_ratio)
            return host_render.render_cropped_host(
                frame[None], du, ds, crop, cfg
            )[0]
        self._state, out = online_step(
            self._state,
            device_frame,
            self._key,
            cfg,
            h,
            w,
            self.adaptive_weights_definition,
            self.crop_ratio,
        )
        return np.asarray(out)
