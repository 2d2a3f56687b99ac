"""Mesh warping, crop detection, and crop+resize (the reference's L5).

Rebuilds /root/reference/meshflowstabilizer.py:909-1157 with the 256x
redundancy removed.  The reference, per frame and per mesh cell, warps a
full-frame mask and perspective-transforms ALL HxW pixels through the
cell's inverse homography, compositing with later-cell-wins ordering
(:1031-1061) — O(F * cells * H * W).  Here each output pixel finds its one
containing cell directly:

1. Per cell, the stabilized->unstabilized homography comes from the 4
   corner pairs in closed form (quad_to_quad_homography; the reference
   calls cv2.findHomography per cell per frame at :1041-1042).
2. Per pixel p, a fixed-point iteration q <- Hinv_{cell(q)}(p) locates the
   candidate cell; cell(q) is pure arithmetic because the unstabilized
   grid lines are ceil((dim-1)*i/count) (:901-906) — no lookups.
3. A 3x3 candidate pass reproduces the reference's compositing semantics:
   membership means Hinv_c(p) lands strictly inside the cell's integer
   bbox expanded by 1 px (the bilinear support of its warped rect mask,
   :1050-1052), and the highest row-major cell index wins (:1060-1061
   overwrite order).  Uncovered pixels keep the sentinel map value
   (W+1, H+1) (:983-984) and render as border color.
4. Homography applications per cell id are one-hot matmuls, not
   gathers; only the final image sampling uses a 4-tap gather.

Crop-edge detection (:1075-1106) and the anisotropic crop+resize
(:1111-1157, where cv2.resize's dsize makes the fx/fy aspect logic dead
code) are reductions and a coordinate-remapped bilinear sample — no
dynamic shapes anywhere.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from meshflow.config import MeshFlowConfig
from meshflow.kernels.homography import quad_to_quad_homography

def cell_inverse_homographies(
    stab_pos: jnp.ndarray, unstab_grid: jnp.ndarray, config: MeshFlowConfig
) -> jnp.ndarray:
    """(cells, 3, 3) stabilized->unstabilized homography per mesh cell.

    stab_pos/unstab_grid: (R+1, C+1, 2).  Cell (r, c) uses its 4 corners in
    the same order the reference passes them to cv2.findHomography.
    """
    r_count, c_count = config.mesh_row_count, config.mesh_col_count

    def corners(pos):
        tl = pos[:-1, :-1]
        tr = pos[:-1, 1:]
        bl = pos[1:, :-1]
        br = pos[1:, 1:]
        return jnp.stack([tl, tr, bl, br], axis=2).reshape(r_count * c_count, 4, 2)

    stab_c = corners(stab_pos)
    unstab_c = corners(unstab_grid)
    return quad_to_quad_homography(stab_c, unstab_c)


def _grid_line_x(c, frame_width, mesh_col_count):
    """ceil((W-1) * c / C) as integer arithmetic (works on arrays)."""
    return -(-((frame_width - 1) * c) // mesh_col_count)


def _grid_line_y(r, frame_height, mesh_row_count):
    return -(-((frame_height - 1) * r) // mesh_row_count)


def _apply_h_table_block(
    cell_ids: jnp.ndarray, h_table: jnp.ndarray, px: jnp.ndarray, py: jnp.ndarray
):
    cells = h_table.shape[0]
    # The (P, cells) one-hot dominates this op's device-memory traffic;
    # bf16 halves it.  Selection stays exact: one-hot entries are 0/1 in
    # any dtype, and the f32 h table is
    # Dekker-split into three bf16 terms (hi + mid + lo reconstructs all
    # 24 mantissa bits) contracted against the bf16 one-hot — a one-hot
    # row picks exactly one (hi, mid, lo) triple whose f32 sum is the
    # original coefficient to ~2^-24 relative.
    #
    # The split terms MUST hide behind optimization_barriers: XLA's
    # algebraic simplifier treats the f32->bf16->f32 convert round-trip
    # as an identity and cancels `hf - f32(bf16(hf))` to ZERO, so without
    # the barriers h_mid/h_lo fold to 0 and the whole map runs at bf16
    # precision, which the float64 oracle in tests/test_render.py rejects.
    # The three terms ride ONE dot against a (cells, 27) [hi|mid|lo] concat (three
    # separate dots invite the dot(a,x)+dot(a,y) -> dot(a,x+y) rewrite,
    # whose operand sum in bf16 loses mid/lo the same way) and are summed
    # from the f32 output behind a final barrier.
    onehot = (
        cell_ids[:, None] == jnp.arange(cells, dtype=jnp.int32)[None, :]
    ).astype(jnp.bfloat16)
    hf = h_table.reshape(cells, 9)
    h_hi = jax.lax.optimization_barrier(hf.astype(jnp.bfloat16))
    rem = hf - h_hi.astype(jnp.float32)
    h_mid = jax.lax.optimization_barrier(rem.astype(jnp.bfloat16))
    h_lo = (rem - h_mid.astype(jnp.float32)).astype(jnp.bfloat16)
    h27 = jnp.concatenate([h_hi, h_mid, h_lo], axis=1)  # (cells, 27)
    dims = (((1,), (0,)), ((), ()))
    out27 = jax.lax.optimization_barrier(
        jax.lax.dot_general(
            onehot, h27, dims, preferred_element_type=jnp.float32
        )
    )
    hflat = out27[:, :9] + out27[:, 9:18] + out27[:, 18:27]  # (P, 9)
    d = hflat[:, 6] * px + hflat[:, 7] * py + hflat[:, 8]
    d = jnp.where(jnp.abs(d) < 1e-10, 1e-10, d)
    qx = (hflat[:, 0] * px + hflat[:, 1] * py + hflat[:, 2]) / d
    qy = (hflat[:, 3] * px + hflat[:, 4] * py + hflat[:, 5]) / d
    return qx, qy


_ONEHOT_BUDGET = 1 << 26  # elements: caps the (P, cells) one-hot at ~256MB


def _apply_h_table(
    cell_ids: jnp.ndarray, h_table: jnp.ndarray, px: jnp.ndarray, py: jnp.ndarray
):
    """Apply per-pixel cell homographies via one-hot contraction.

    cell_ids: (P,) int32 in [0, cells); h_table: (cells, 3, 3);
    px, py: (P,) pixel coords.  Returns (qx, qy): (P,).  Pixels are
    chunked so the one-hot stays bounded for dense meshes (64x64 = 4096
    cells would otherwise materialize multi-GB intermediates).
    """
    cells = h_table.shape[0]
    p = cell_ids.shape[0]
    if p * cells <= _ONEHOT_BUDGET:
        return _apply_h_table_block(cell_ids, h_table, px, py)
    chunk = max(1, _ONEHOT_BUDGET // cells)
    chunk = min(chunk, p)
    pad = (-p) % chunk
    def padded(a):
        return jnp.pad(a, (0, pad)).reshape(-1, chunk)
    qx, qy = jax.lax.map(
        lambda args: _apply_h_table_block(args[0], h_table, args[1], args[2]),
        (padded(cell_ids), padded(px), padded(py)),
    )
    return qx.reshape(-1)[:p], qy.reshape(-1)[:p]


class BackwardMap(NamedTuple):
    map_x: jnp.ndarray  # (H, W) float32 source x (sentinel W+1 if uncovered)
    map_y: jnp.ndarray  # (H, W) float32 source y (sentinel H+1 if uncovered)
    covered: jnp.ndarray  # (H, W) bool


@functools.partial(
    jax.jit, static_argnames=("config", "frame_height", "frame_width")
)
def backward_map(
    stab_pos: jnp.ndarray,
    unstab_grid: jnp.ndarray,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
) -> BackwardMap:
    """Per-pixel stabilized->unstabilized map for one frame."""
    rc, cc = config.mesh_row_count, config.mesh_col_count
    h_table = cell_inverse_homographies(stab_pos, unstab_grid, config)

    ys = jnp.arange(frame_height, dtype=jnp.float32)
    xs = jnp.arange(frame_width, dtype=jnp.float32)
    px = jnp.tile(xs[None, :], (frame_height, 1)).reshape(-1)
    py = jnp.tile(ys[:, None], (1, frame_width)).reshape(-1)

    def cell_of(qx, qy):
        # index of the last grid line <= q, clamped to a valid cell
        jx = jnp.arange(1, cc, dtype=jnp.int32)
        lines_x = _grid_line_x(jx, frame_width, cc).astype(jnp.float32)
        jy = jnp.arange(1, rc, dtype=jnp.int32)
        lines_y = _grid_line_y(jy, frame_height, rc).astype(jnp.float32)
        col = jnp.sum(
            (qx[:, None] >= lines_x[None, :]).astype(jnp.int32), axis=1
        )
        row = jnp.sum(
            (qy[:, None] >= lines_y[None, :]).astype(jnp.int32), axis=1
        )
        return (
            jnp.clip(row, 0, rc - 1),
            jnp.clip(col, 0, cc - 1),
        )

    # Fixed-point cell search.
    qx, qy = px, py
    for _ in range(3):
        row, col = cell_of(qx, qy)
        qx, qy = _apply_h_table(row * cc + col, h_table, px, py)
    row0, col0 = cell_of(qx, qy)

    # Candidate pass: 3x3 neighborhood, reference mask semantics
    # (strictly inside the integer bbox expanded by 1), last row-major wins.
    best_key = jnp.full(px.shape, -1, jnp.int32)
    best_qx = jnp.full(px.shape, float(frame_width + 1), jnp.float32)
    best_qy = jnp.full(px.shape, float(frame_height + 1), jnp.float32)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            row = jnp.clip(row0 + dr, 0, rc - 1)
            col = jnp.clip(col0 + dc, 0, cc - 1)
            cqx, cqy = _apply_h_table(row * cc + col, h_table, px, py)
            left = _grid_line_x(col, frame_width, cc).astype(jnp.float32)
            right = _grid_line_x(col + 1, frame_width, cc).astype(jnp.float32)
            top = _grid_line_y(row, frame_height, rc).astype(jnp.float32)
            bottom = _grid_line_y(row + 1, frame_height, rc).astype(jnp.float32)
            member = (
                (cqx > left - 1.0)
                & (cqx < right + 1.0)
                & (cqy > top - 1.0)
                & (cqy < bottom + 1.0)
            )
            key = row * cc + col
            take = member & (key > best_key)
            best_key = jnp.where(take, key, best_key)
            best_qx = jnp.where(take, cqx, best_qx)
            best_qy = jnp.where(take, cqy, best_qy)

    covered = best_key >= 0
    return BackwardMap(
        map_x=best_qx.reshape(frame_height, frame_width),
        map_y=best_qy.reshape(frame_height, frame_width),
        covered=covered.reshape(frame_height, frame_width),
    )


def bilinear_sample(
    frame: jnp.ndarray,
    sample_x: jnp.ndarray,
    sample_y: jnp.ndarray,
    border_bgr=None,
):
    """Bilinear sample of (H, W, C) uint8 frame at float coords.

    border_bgr None -> taps clamp to the edge (cv2.resize semantics);
    otherwise out-of-image taps contribute the border color (cv2.remap
    INTER_LINEAR + BORDER_CONSTANT, /root/reference/meshflowstabilizer.py:1063-1069).
    Returns float32 (..., C).

    3-channel uint8 frames take a packed path: B/G/R are packed into one
    uint32 word per pixel so each tap is ONE gather row instead of a
    3-element row gather — this is the render path's hot op.  Unpacking
    is integer work; values are exact either way.
    """
    h, w, c = frame.shape
    packed = c == 3 and frame.dtype == jnp.uint8
    packed1 = c == 1 and frame.dtype == jnp.uint8
    x0 = jnp.floor(sample_x)
    y0 = jnp.floor(sample_y)
    fx = sample_x - x0
    fy = sample_y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    if packed1:
        # Single-plane variant of the quad-packed gather below: the whole
        # 2x2 footprint of the u8 plane fits ONE u32 word
        # (tap(i) | tap(i+1)<<8 | tap(i+w)<<16 | tap(i+w+1)<<24), so each
        # output pixel costs a single 1-word gather row instead of 4
        # scalar gather rows.  Byte selection by clamped offset
        # reproduces edge-clamp semantics exactly as in the 3-channel
        # path; border mode substitutes the border color for outside taps.
        img8 = frame[..., 0].astype(jnp.uint32).reshape(h * w)
        quad1 = (
            img8
            | (jnp.roll(img8, -1) << 8)
            | (jnp.roll(img8, -w) << 16)
            | (jnp.roll(img8, -w - 1) << 24)
        )  # (h*w,)
        xb = jnp.clip(x0i, 0, w - 2)
        yb = jnp.clip(y0i, 0, h - 2)
        taps32 = jnp.take(quad1, yb * w + xb)  # (...,)

        out = 0.0
        border = (
            jnp.asarray(border_bgr, jnp.float32)[0]
            if border_bgr is not None
            else None
        )
        for dy in (0, 1):
            for dx in (0, 1):
                tx = x0i + dx
                ty = y0i + dy
                weight = (fx if dx else (1.0 - fx)) * (fy if dy else (1.0 - fy))
                inside = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
                wsel = (jnp.clip(ty, 0, h - 1) - yb) * 2 + (
                    jnp.clip(tx, 0, w - 1) - xb
                )  # in {0,1,2,3}
                vals = (
                    (taps32 >> (wsel.astype(jnp.uint32) * 8)) & 0xFF
                ).astype(jnp.float32)
                if border is not None:
                    vals = jnp.where(inside, vals, border)
                out = out + weight * vals
        return out[..., None]

    if packed:
        # Quad-packed gather: instead of four 1-word taps per pixel,
        # gather ONE 4-word row holding a 2x2 footprint.  quad[i] = [p(i), p(i+1), p(i+w), p(i+w+1)] of
        # the uint32-packed (B | G<<8 | R<<16) image; rolls build the
        # footprint table once per frame (~4 frame copies of traffic, far
        # below the gather saving).  The base corner is clamped to
        # [0, w-2] x [0, h-2] so the quad never wraps; each tap then
        # selects its word by its clamped offset from the base, which
        # reproduces edge-clamp semantics exactly, and border mode
        # substitutes the border color for outside taps as before.
        f32 = frame.astype(jnp.uint32)
        img32 = (
            f32[..., 0] | (f32[..., 1] << 8) | (f32[..., 2] << 16)
        ).reshape(h * w)
        quad = jnp.stack(
            [
                img32,
                jnp.roll(img32, -1),
                jnp.roll(img32, -w),
                jnp.roll(img32, -w - 1),
            ],
            axis=-1,
        )  # (h*w, 4)
        xb = jnp.clip(x0i, 0, w - 2)
        yb = jnp.clip(y0i, 0, h - 2)
        taps32 = jnp.take(quad, yb * w + xb, axis=0)  # (..., 4)

        out = 0.0
        border = (
            jnp.asarray(border_bgr, jnp.float32)
            if border_bgr is not None
            else None
        )
        for dy in (0, 1):
            for dx in (0, 1):
                tx = x0i + dx
                ty = y0i + dy
                weight = (fx if dx else (1.0 - fx)) * (fy if dy else (1.0 - fy))
                inside = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
                wsel = (jnp.clip(ty, 0, h - 1) - yb) * 2 + (
                    jnp.clip(tx, 0, w - 1) - xb
                )  # in {0,1,2,3}
                v32 = jnp.where(
                    wsel >= 2,
                    jnp.where(wsel == 3, taps32[..., 3], taps32[..., 2]),
                    jnp.where(wsel == 1, taps32[..., 1], taps32[..., 0]),
                )
                vals = jnp.stack(
                    [
                        (v32 & 0xFF).astype(jnp.float32),
                        ((v32 >> 8) & 0xFF).astype(jnp.float32),
                        ((v32 >> 16) & 0xFF).astype(jnp.float32),
                    ],
                    axis=-1,
                )
                if border is not None:
                    vals = jnp.where(inside[..., None], vals, border)
                out = out + weight[..., None] * vals
        return out

    img = frame.astype(jnp.float32).reshape(h * w, c)
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            tx = x0i + dx
            ty = y0i + dy
            weight = (fx if dx else (1.0 - fx)) * (fy if dy else (1.0 - fy))
            inside = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
            txc = jnp.clip(tx, 0, w - 1)
            tyc = jnp.clip(ty, 0, h - 1)
            vals = jnp.take(img, tyc * w + txc, axis=0)  # (..., C)
            if border_bgr is not None:
                border = jnp.asarray(border_bgr, jnp.float32)
                vals = jnp.where(inside[..., None], vals, border)
            out = out + weight[..., None] * vals
    return out


def warp_frame(
    frame: jnp.ndarray, bmap: BackwardMap, border_bgr
) -> jnp.ndarray:
    """Render one stabilized frame (uint8) from its backward map.

    frame: (H, W, C) uint8; border_bgr must be length C (the gray metric
    path passes the exact-cv2 gray of the BGR border color)."""
    c = frame.shape[-1]
    sampled = bilinear_sample(
        frame, bmap.map_x.reshape(-1), bmap.map_y.reshape(-1), border_bgr
    )
    border = jnp.asarray(border_bgr, jnp.float32)
    sampled = jnp.where(bmap.covered.reshape(-1, 1), sampled, border)
    h, w = bmap.map_x.shape
    return (
        jnp.clip(jnp.round(sampled), 0, 255).astype(jnp.uint8).reshape(h, w, c)
    )


def crop_edges(bmap: BackwardMap, frame_height: int, frame_width: int):
    """Per-frame crop edges, reference rules
    (/root/reference/meshflowstabilizer.py:1075-1098): a stabilized column
    matches a source edge when any backward-map entry is within 1 px of it;
    defaults are the full frame."""
    cols = jnp.arange(frame_width, dtype=jnp.int32)
    rows = jnp.arange(frame_height, dtype=jnp.int32)

    def col_extreme(match, default, reduce_max):
        any_col = jnp.any(match, axis=0)  # (W,)
        if reduce_max:
            vals = jnp.where(any_col, cols, -1)
            best = jnp.max(vals)
        else:
            vals = jnp.where(any_col, cols, frame_width + 1)
            best = jnp.min(vals)
        found = jnp.any(any_col)
        return jnp.where(found, best, default)

    def row_extreme(match, default, reduce_max):
        any_row = jnp.any(match, axis=1)  # (H,)
        if reduce_max:
            vals = jnp.where(any_row, rows, -1)
            best = jnp.max(vals)
        else:
            vals = jnp.where(any_row, rows, frame_height + 1)
            best = jnp.min(vals)
        found = jnp.any(any_row)
        return jnp.where(found, best, default)

    left = col_extreme(jnp.abs(bmap.map_x) < 1.0, 0, True)
    right = col_extreme(
        jnp.abs(bmap.map_x - (frame_width - 1)) < 1.0, frame_width - 1, False
    )
    top = row_extreme(jnp.abs(bmap.map_y) < 1.0, 0, True)
    bottom = row_extreme(
        jnp.abs(bmap.map_y - (frame_height - 1)) < 1.0, frame_height - 1, False
    )
    return jnp.stack([left, top, right, bottom])


def crop_resize_frame(
    frame: jnp.ndarray, crop: jnp.ndarray, frame_height: int, frame_width: int
) -> jnp.ndarray:
    """Crop to [left, top, right, bottom] (inclusive) and stretch back to
    (W, H) — cv2.resize INTER_LINEAR half-pixel semantics with edge clamp.
    Dynamic crop values, static shapes.

    Bilinear resize is separable, so it runs as two dense
    contractions with hat-function interpolation matrices instead of a
    4-tap gather: relu(1 - |src - s|) over integer taps s IS the
    two-tap bilinear kernel (and a single 1 at integer src), and the
    sample coordinates are already clamped inside the crop so no tap
    falls outside it.
    """
    left, top, right, bottom = crop[0], crop[1], crop[2], crop[3]
    crop_w = (right - left + 1).astype(jnp.float32)
    crop_h = (bottom - top + 1).astype(jnp.float32)
    sx = crop_w / frame_width
    sy = crop_h / frame_height
    xs = (jnp.arange(frame_width, dtype=jnp.float32) + 0.5) * sx - 0.5
    ys = (jnp.arange(frame_height, dtype=jnp.float32) + 0.5) * sy - 0.5
    # clamp into the crop (resize never reads outside its source)
    xs = jnp.clip(xs, 0.0, crop_w - 1.0) + left.astype(jnp.float32)
    ys = jnp.clip(ys, 0.0, crop_h - 1.0) + top.astype(jnp.float32)

    taps_x = jnp.arange(frame_width, dtype=jnp.float32)
    taps_y = jnp.arange(frame_height, dtype=jnp.float32)
    wx = jnp.maximum(0.0, 1.0 - jnp.abs(xs[:, None] - taps_x[None, :]))
    wy = jnp.maximum(0.0, 1.0 - jnp.abs(ys[:, None] - taps_y[None, :]))

    img = frame.astype(jnp.float32)  # (H, W, C)
    rows = jnp.einsum(
        "os,swc->owc", wy, img, precision=jax.lax.Precision.HIGHEST
    )
    out = jnp.einsum(
        "vs,osc->ovc", wx, rows, precision=jax.lax.Precision.HIGHEST
    )
    return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)


@functools.partial(
    jax.jit, static_argnames=("config", "frame_height", "frame_width")
)
def render_stabilized(
    frames: jnp.ndarray,
    unstab_disp: jnp.ndarray,
    stab_disp: jnp.ndarray,
    unstab_grid: jnp.ndarray,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
):
    """Warp all frames and compute the video crop rectangle.

    frames: (F, H, W, C) uint8 (C=3 BGR or C=1 gray); *_disp:
    (F, R+1, C+1, 2).  Returns (stabilized (F, H, W, C) uint8,
    crop (4,) int32 [left, top, right, bottom]).
    """
    if frames.shape[-1] == 1:
        from meshflow.kernels.color import gray_of_bgr_color

        border = jnp.asarray(
            [gray_of_bgr_color(config.color_outside_image_area_bgr)],
            jnp.float32,
        )
    else:
        border = jnp.asarray(
            config.color_outside_image_area_bgr, jnp.float32
        )

    def body(carry, inputs):
        frame, du, ds = inputs
        stab_pos = unstab_grid + (ds - du)
        bmap = backward_map(
            stab_pos, unstab_grid, config, frame_height, frame_width
        )
        stabilized = warp_frame(frame, bmap, border)
        edges = crop_edges(bmap, frame_height, frame_width)
        return carry, (stabilized, edges)

    _, (stabilized, edges) = jax.lax.scan(
        body, None, (frames, unstab_disp, stab_disp)
    )
    crop = jnp.stack(
        [
            jnp.max(edges[:, 0]),
            jnp.max(edges[:, 1]),
            jnp.min(edges[:, 2]),
            jnp.min(edges[:, 3]),
        ]
    )
    return stabilized, crop


@functools.partial(
    jax.jit, static_argnames=("frame_height", "frame_width")
)
def crop_frames(
    stabilized: jnp.ndarray,
    crop: jnp.ndarray,
    frame_height: int,
    frame_width: int,
) -> jnp.ndarray:
    """Crop+stretch all frames back to full resolution
    (/root/reference/meshflowstabilizer.py:1111-1157)."""

    def body(carry, frame):
        return carry, crop_resize_frame(frame, crop, frame_height, frame_width)

    _, out = jax.lax.scan(body, None, stabilized)
    return out
