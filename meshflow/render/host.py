"""Host-side native render path (ctypes bindings for native/warp.cpp).

Same algorithm and semantics as render.stabilize, executed on the host:
only the tiny displacement fields come off the device (see
api.MeshFlowStabilizer render routing).  The library is built for this
host at first use (utils/native_build.py).

Two remap backends (MESHFLOW_HOST_REMAP):

* "cv2" (default): C++ rasterizes the per-pixel backward maps (mf_maps,
  the only custom arithmetic), then cv2.remap / cv2.resize execute the
  sampling — the exact ops the reference calls
  (/root/reference/meshflowstabilizer.py:1063,1147), with OpenCV's
  fixed-point SIMD inner loops.  Fastest, and byte-closest to the
  reference's golden outputs.
* "cpp": the self-contained C++ float sampling path (mf_render /
  mf_render_cropped / mf_crop_resize); used automatically if cv2 is
  unavailable.  Differs from cv2 by OpenCV's 1/32-px fixed-point
  coordinate quantization.

Either way the fused streaming call is byte-identical to running the two
stages (full warp, then crop+stretch) separately.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import numpy as np

from meshflow.config import MeshFlowConfig
from meshflow.utils import native_build


def load_library():
    """The native warp library (built for this host at first use), bound,
    or None when it cannot be built here."""
    lib = native_build.load("warp")
    if lib is not None:
        _bind(lib)
    return lib


def available() -> bool:
    return load_library() is not None


def _use_cv2_remap() -> bool:
    mode = os.environ.get("MESHFLOW_HOST_REMAP", "cv2")
    if mode != "cv2" or load_library() is None:
        return False
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def _bind(lib):
    if getattr(lib, "_mf_render_bound", False):
        return
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.mf_render.argtypes = [
        u8p, f32p, f32p,
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_long,
        u8p, u8p, i32p,
    ]
    lib.mf_crop_resize.argtypes = [
        u8p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        u8p,
    ]
    lib.mf_maps.argtypes = [
        f32p, f32p,
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_long,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        f32p,
    ]
    lib.mf_crop_edges.argtypes = [
        f32p, f32p,
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_long,
        i32p,
    ]
    lib.mf_render_cropped.argtypes = [
        u8p, f32p, f32p,
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_long,
        u8p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        u8p,
    ]
    lib._mf_render_bound = True


def crop_edges_host(
    unstab_disp: np.ndarray,
    stab_disp: np.ndarray,
    frame_height: int,
    frame_width: int,
    config: MeshFlowConfig,
) -> np.ndarray:
    """Global crop rect [left, top, right, bottom] from displacement fields
    alone (identical arithmetic to mf_render's per-frame edge scan)."""
    lib = load_library()
    du = np.ascontiguousarray(unstab_disp, np.float32)
    ds = np.ascontiguousarray(stab_disp, np.float32)
    f = du.shape[0]
    edges = np.empty((f, 4), np.int32)
    lib.mf_crop_edges(
        du.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ds.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        f, frame_height, frame_width,
        config.mesh_row_count, config.mesh_col_count,
        edges.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return np.array(
        [edges[:, 0].max(), edges[:, 1].max(), edges[:, 2].min(), edges[:, 3].min()],
        np.int32,
    )


def _maps_host(
    unstab_disp: np.ndarray,
    stab_disp: np.ndarray,
    frame_height: int,
    frame_width: int,
    config: MeshFlowConfig,
    region=None,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """(F, 2, rh, rw) float32 backward maps [map_x, map_y] via mf_maps.

    Pass a reused `out` buffer when calling per frame in a loop: a
    chunk-sized fresh allocation (1 GB for 64 frames at 1080p) pays a page
    fault per 4 KB page on first touch, which can cost more than the
    rasterization itself."""
    lib = load_library()
    du = np.ascontiguousarray(unstab_disp, np.float32)
    ds = np.ascontiguousarray(stab_disp, np.float32)
    f = du.shape[0]
    if region is None:
        region = (0, 0, frame_width - 1, frame_height - 1)
    rx0, ry0, rx1, ry1 = (int(v) for v in region)
    shape = (f, 2, ry1 - ry0 + 1, rx1 - rx0 + 1)
    if out is not None:
        assert out.shape == shape and out.dtype == np.float32, (out.shape, shape)
        maps = out
    else:
        maps = np.empty(shape, np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.mf_maps(
        du.ctypes.data_as(f32p),
        ds.ctypes.data_as(f32p),
        f, frame_height, frame_width,
        config.mesh_row_count, config.mesh_col_count,
        rx0, ry0, rx1, ry1,
        maps.ctypes.data_as(f32p),
    )
    return maps


def _edges_from_maps(map_x: np.ndarray, map_y: np.ndarray, h: int, w: int):
    """Crop edges from one frame's maps — same rules as mf_render's scan
    (reference :1075-1098): a stabilized column/row matches a source edge
    when any map entry is within 1 px of it; defaults are the full frame."""
    def extreme(match, axis, default, take_max):
        idx = np.flatnonzero(match.any(axis=axis))
        if idx.size == 0:
            return default
        return int(idx.max() if take_max else idx.min())

    left = extreme(np.abs(map_x) < 1.0, 0, 0, True)
    right = extreme(np.abs(map_x - (w - 1)) < 1.0, 0, w - 1, False)
    top = extreme(np.abs(map_y) < 1.0, 1, 0, True)
    bottom = extreme(np.abs(map_y - (h - 1)) < 1.0, 1, h - 1, False)
    return left, top, right, bottom


_SCRATCH: dict = {}


def _scratch(key, shape, dtype):
    """Process-lifetime reused buffer (page faults on fresh chunk-scale
    allocations can dominate the actual pixel work; see _maps_host).  The leading axis is grow-only — a shorter request gets a
    contiguous view of the larger buffer, so the final (smaller) chunk of
    a clip doesn't churn the allocation.  Single-threaded use per key:
    the streaming producer is the only caller of the render path in a
    process."""
    buf = _SCRATCH.get(key)
    if (
        buf is None
        or buf.dtype != dtype
        or buf.shape[1:] != shape[1:]
        or buf.shape[0] < shape[0]
    ):
        buf = np.empty(shape, dtype)
        _SCRATCH[key] = buf
    return buf[: shape[0]]


def render_cropped_host(
    frames: np.ndarray,
    unstab_disp: np.ndarray,
    stab_disp: np.ndarray,
    crop: np.ndarray,
    config: MeshFlowConfig,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """Fused warp + crop + stretch for a chunk under a known global crop.

    Byte-identical to render_stabilized_host followed by crop_frames_host
    (stage-1 uint8 rounding preserved), at ~crop-area cost.

    `out`, if given, receives the result (the caller owns reuse safety —
    the streaming pipeline passes a persistent buffer once the previous
    chunk has been consumed, avoiding chunk-scale page-fault churn)."""
    if _use_cv2_remap():
        import cv2

        frames = np.ascontiguousarray(frames, np.uint8)
        f, h, w = frames.shape[:3]
        left, top, right, bottom = (int(v) for v in crop)
        rh, rw = bottom - top + 1, right - left + 1
        # One chunk-scale mf_maps call (its parallel_for rasterizes frames
        # across all cores) into a persistent scratch: reuse avoids the
        # page-fault tax a fresh chunk allocation would pay on every
        # call, while keeping the native layer's multithreading.
        maps = _scratch("maps_chunk", (f, 2, rh, rw), np.float32)
        stab = _scratch("stab", (rh, rw, 3), np.uint8)
        border = tuple(int(c) for c in config.color_outside_image_area_bgr)
        if out is None:
            out = np.empty_like(frames)
        _maps_host(
            unstab_disp, stab_disp, h, w, config,
            region=(left, top, right, bottom), out=maps,
        )
        for i in range(f):
            cv2.remap(
                frames[i], maps[i, 0], maps[i, 1], cv2.INTER_LINEAR,
                dst=stab,
                borderMode=cv2.BORDER_CONSTANT, borderValue=border,
            )
            cv2.resize(stab, (w, h), dst=out[i], interpolation=cv2.INTER_LINEAR)
        return out
    lib = load_library()
    frames = np.ascontiguousarray(frames, np.uint8)
    du = np.ascontiguousarray(unstab_disp, np.float32)
    ds = np.ascontiguousarray(stab_disp, np.float32)
    f, h, w = frames.shape[:3]
    if out is None:
        out = np.empty_like(frames)
    border = np.asarray(config.color_outside_image_area_bgr, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.mf_render_cropped(
        frames.ctypes.data_as(u8p),
        du.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ds.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        f, h, w, config.mesh_row_count, config.mesh_col_count,
        border.ctypes.data_as(u8p),
        int(crop[0]), int(crop[1]), int(crop[2]), int(crop[3]),
        out.ctypes.data_as(u8p),
    )
    return out


def render_stabilized_host(
    frames: np.ndarray,
    unstab_disp: np.ndarray,
    stab_disp: np.ndarray,
    config: MeshFlowConfig,
) -> Tuple[np.ndarray, np.ndarray]:
    """(F, H, W, 3) uint8 + displacement fields -> (stabilized, crop).

    crop is [left, top, right, bottom] (the intersection over frames,
    /root/reference/meshflowstabilizer.py:1102-1106).
    """
    if _use_cv2_remap():
        import cv2

        frames = np.ascontiguousarray(frames, np.uint8)
        f, h, w = frames.shape[:3]
        # Sub-chunked maps: one mf_maps call per block keeps the native
        # layer's frame-parallel rasterization without materializing the
        # whole clip's maps (8 GB at 1080p x 494 frames); the scratch
        # block is reused so pages fault once per process.
        block = min(f, 32)
        maps = _scratch("maps_full", (block, 2, h, w), np.float32)
        border = tuple(int(c) for c in config.color_outside_image_area_bgr)
        out = np.empty_like(frames)
        edges = np.empty((f, 4), np.int32)
        for b0 in range(0, f, block):
            b1 = min(b0 + block, f)
            _maps_host(
                unstab_disp[b0:b1], stab_disp[b0:b1], h, w, config,
                out=maps[: b1 - b0],
            )
            for i in range(b0, b1):
                cv2.remap(
                    frames[i], maps[i - b0, 0], maps[i - b0, 1],
                    cv2.INTER_LINEAR,
                    dst=out[i],
                    borderMode=cv2.BORDER_CONSTANT, borderValue=border,
                )
                edges[i] = _edges_from_maps(
                    maps[i - b0, 0], maps[i - b0, 1], h, w
                )
        crop = np.array(
            [
                edges[:, 0].max(),
                edges[:, 1].max(),
                edges[:, 2].min(),
                edges[:, 3].min(),
            ],
            np.int32,
        )
        return out, crop
    lib = load_library()
    frames = np.ascontiguousarray(frames, np.uint8)
    du = np.ascontiguousarray(unstab_disp, np.float32)
    ds = np.ascontiguousarray(stab_disp, np.float32)
    f, h, w = frames.shape[:3]
    out = np.empty_like(frames)
    edges = np.empty((f, 4), np.int32)
    border = np.asarray(config.color_outside_image_area_bgr, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.mf_render(
        frames.ctypes.data_as(u8p),
        du.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ds.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        f, h, w, config.mesh_row_count, config.mesh_col_count,
        border.ctypes.data_as(u8p),
        out.ctypes.data_as(u8p),
        edges.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    crop = np.array(
        [edges[:, 0].max(), edges[:, 1].max(), edges[:, 2].min(), edges[:, 3].min()],
        np.int32,
    )
    return out, crop


def crop_frames_host(
    stabilized: np.ndarray, crop: np.ndarray
) -> np.ndarray:
    """Crop+stretch back to full resolution (cv2.resize semantics)."""
    if _use_cv2_remap():
        import cv2

        stabilized = np.ascontiguousarray(stabilized, np.uint8)
        f, h, w = stabilized.shape[:3]
        left, top, right, bottom = (int(v) for v in crop)
        out = np.empty_like(stabilized)
        for i in range(f):
            region = np.ascontiguousarray(
                stabilized[i, top : bottom + 1, left : right + 1]
            )
            cv2.resize(
                region, (w, h), dst=out[i], interpolation=cv2.INTER_LINEAR
            )
        return out
    lib = load_library()
    stabilized = np.ascontiguousarray(stabilized, np.uint8)
    f, h, w = stabilized.shape[:3]
    out = np.empty_like(stabilized)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.mf_crop_resize(
        stabilized.ctypes.data_as(u8p), f, h, w,
        int(crop[0]), int(crop[1]), int(crop[2]), int(crop[3]),
        out.ctypes.data_as(u8p),
    )
    return out
