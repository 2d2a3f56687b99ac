"""Pyramidal Lucas-Kanade sparse feature tracking, gather-free.

Accelerator replacement for ``cv2.calcOpticalFlowPyrLK`` with OpenCV's
defaults (winSize 21x21, maxLevel clamped by image size, criteria 30
iterations / eps 0.01, minEigThreshold 1e-4), used by the reference at
/root/reference/meshflowstabilizer.py:618-620.

Semantics reproduced from OpenCV's lkpyramid tracker:

* Scharr 3x3 derivatives (/32) of the previous level, REFLECT_101 borders.
* The spatial gradient matrix A is built once per level from the previous
  image's window around the (fixed) scaled prev point; iterations update
  only the next point via delta = -A^{-1} b with b from the current
  photometric difference.
* Iterations stop on |delta|^2 <= eps^2 or the oscillation check
  (|delta + prev_delta| < 0.01 componentwise -> back off half a step).
* status goes 0 only at level 0: window corner out of logical bounds, or
  minEig/winArea below threshold (in OpenCV's fixed-point scaling), or
  degenerate det.
* Windows may sample up to winSize outside the image; image levels are
  REFLECT_101-padded, derivative levels zero-padded, as in
  buildOpticalFlowPyramid.

Window reads: every window/patch read is expressed as a pair of batched
matmuls against sparse row/column selection matrices that carry the
bilinear weights (two nonzeros per row), instead of vmapped dynamic_slice
gathers.  Per level:

1. prev windows (image, gx, gy) come straight off the padded full level via
   bilinear selection matmuls — computed once, like OpenCV;
2. a (PATCH_H, PATCH_W) region of the next level is extracted around each
   feature's initial estimate (integer selection matmuls) — once;
3. each solver iteration samples its 21x21 window from that small patch
   with bilinear selection matmuls, so the while_loop body has no
   gathers.

Iterates that wander past the cached patch margin (+-37 px at the top
pyramid level, +-17/21 px at refinement levels) pause and resume in a fresh
patch re-centered on their estimate (up to 3 fetch rounds per level, with a
per-feature iteration budget matching OpenCV's criteria), so large motions
are followed rather than clamped.

OpenCV's int16/Q5 window quantization is replaced by float32, which moves
endpoints by ~1e-2 px; oracle tests are tolerance-based.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp


def _selection_precision() -> jax.lax.Precision | None:
    """Precision of the bilinear selection matmuls, by platform.

    On the GPU, Precision.HIGH is TF32 (10-bit mantissa, tensor cores);
    HIGHEST is full float32 on the CUDA cores.  Measured on an H100
    (400 W limit), 640x360 seeded pair, 5044 features, against the same
    tracker on the CPU: TF32 keeps 99.98% of endpoints within 1e-2 px
    (max 0.0119 px) with 100% status agreement — inside the tracker's
    tolerance (>= 99.5% within 1e-2 px, the cv2 oracle's 1e-2 px).
    (HIGHEST: max 1.5e-5 px.)  In one process on one H100 (700 W limit),
    HIGH against HIGHEST: motion LK 1.21x and metric LK 1.16x faster,
    1080p eval-mode stabilize 7% faster, and the three eval scores within
    3e-6 relative of each other.  So the GPU runs them at HIGH.  The CPU
    computes float32 dot products at any setting and keeps the package
    default.  The motion checkpoint key names this precision.
    """
    if jax.default_backend() == "gpu":
        return jax.lax.Precision.HIGH
    return None


_PAD = 22  # window corner may lie in [-21, cols-1]; reads span +-(21+1)

# Next-image patch sizes per pyramid position.  The top level carries the
# whole unknown displacement (initial estimate is the prev point), so its
# patch must cover large motions; lower levels only refine by a few pixels.
# Top-level images are the smallest, so the large patch is cheap there.
_PATCH_TOP = (96, 96)     # +-37/+-37 px margin at the top level
_PATCH_LOWER = (56, 64)   # +-17/+-21 px at refinement levels


def scharr_deriv(img: jnp.ndarray):
    """Scharr x/y derivatives / 32, REFLECT_101 border.  img: (..., H, W)."""
    p = jnp.pad(img, [(0, 0)] * (img.ndim - 2) + [(1, 1), (1, 1)], mode="reflect")
    h, w = img.shape[-2], img.shape[-1]

    def win(dy, dx):
        return p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    gx = (
        3.0 * (win(-1, 1) - win(-1, -1))
        + 10.0 * (win(0, 1) - win(0, -1))
        + 3.0 * (win(1, 1) - win(1, -1))
    ) * (1.0 / 32.0)
    gy = (
        3.0 * (win(1, -1) - win(-1, -1))
        + 10.0 * (win(1, 0) - win(-1, 0))
        + 3.0 * (win(1, 1) - win(-1, 1))
    ) * (1.0 / 32.0)
    return gx, gy


class PaddedLevel(NamedTuple):
    """One pyramid level prepared for window sampling.

    The logical level shape is recovered as shape[-2:] - 2*_PAD, keeping
    this pytree all-array so it vmaps over a frame axis cleanly.
    """

    image: jnp.ndarray  # (..., H+2P, W+2P) REFLECT_101-padded image
    gx: jnp.ndarray  # (..., H+2P, W+2P) zero-padded Scharr d/dx
    gy: jnp.ndarray  # (..., H+2P, W+2P) zero-padded Scharr d/dy


def prepare_level(level_img: jnp.ndarray) -> PaddedLevel:
    """Pad a (..., H, W) level and attach derivatives."""
    # REFLECT_101 cannot pad more than size-1 at once; do it in chunks.
    img = level_img
    remaining = _PAD
    while remaining > 0:
        step = min(remaining, min(img.shape[-2], img.shape[-1]) - 1)
        img = jnp.pad(
            img, [(0, 0)] * (img.ndim - 2) + [(step, step), (step, step)],
            mode="reflect",
        )
        remaining -= step
    gx, gy = scharr_deriv(level_img)
    zpad = [(0, 0)] * (level_img.ndim - 2) + [(_PAD, _PAD), (_PAD, _PAD)]
    return PaddedLevel(image=img, gx=jnp.pad(gx, zpad), gy=jnp.pad(gy, zpad))


def _selection_int(idx0: jnp.ndarray, win: int, size: int) -> jnp.ndarray:
    """(N, win, size) one-hot rows: out[n, r, i] = [i == idx0_n + r].

    idx0 indexes the PADDED axis (caller adds _PAD and clamps).
    """
    i = jnp.arange(size, dtype=jnp.int32)
    target = idx0[:, None] + jnp.arange(win, dtype=jnp.int32)[None, :]
    return (i[None, None, :] == target[:, :, None]).astype(jnp.float32)


def _selection_bilinear(
    idx0: jnp.ndarray, frac: jnp.ndarray, win: int, size: int
) -> jnp.ndarray:
    """(N, win, size) bilinear selection rows:
    out[n, r, i] = (1-frac_n)[i == idx0_n + r] + frac_n[i == idx0_n + r + 1]."""
    i = jnp.arange(size, dtype=jnp.int32)
    target = idx0[:, None] + jnp.arange(win, dtype=jnp.int32)[None, :]
    lo = (i[None, None, :] == target[:, :, None]).astype(jnp.float32)
    hi = (i[None, None, :] == (target + 1)[:, :, None]).astype(jnp.float32)
    return (1.0 - frac)[:, None, None] * lo + frac[:, None, None] * hi


def _apply_selection_block(
    rows: jnp.ndarray, cols: jnp.ndarray, imgs: jnp.ndarray
) -> jnp.ndarray:
    """windows[c, n] = rows[n] @ imgs[c] @ cols[n]^T.

    rows: (N, wr, H); cols: (N, wc, W); imgs: (C, H, W) ->
    (C, N, wr, wc).  Two batched MXU contractions; no gathers.
    """
    n, wr, h = rows.shape
    c = imgs.shape[0]
    tmp = jax.lax.dot_general(
        rows.reshape(n * wr, h), imgs,
        (((1,), (1,)), ((), ())),
        precision=_selection_precision(),
    )  # (N*wr, C, W)
    tmp = tmp.reshape(n, wr, c, -1).transpose(2, 0, 1, 3)  # (C, N, wr, W)
    out = jax.lax.dot_general(
        tmp, cols,
        (((3,), (2,)), ((1,), (0,))),
        precision=_selection_precision(),
    )  # (N, C, wr, wc)
    return out.transpose(1, 0, 2, 3)


_SEL_CHUNK = 512  # bounds selection one-hots + row-stage intermediates


def _extract_windows(
    imgs: jnp.ndarray,
    iy: jnp.ndarray,
    ix: jnp.ndarray,
    win_h: int,
    win_w: int,
    fy: jnp.ndarray | None = None,
    fx: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """(C, N, win_h, win_w) windows at per-feature integer corners (iy, ix)
    on the padded axes, with optional bilinear fractions (fy, fx).

    Feature chunks are serialized with lax.map so both the selection
    one-hots (N * win * dim floats) and the row-stage intermediates stay
    ~100MB regardless of N or resolution.
    """
    hpad, wpad = imgs.shape[-2], imgs.shape[-1]
    n = iy.shape[0]

    def block(args):
        biy, bix, bfy, bfx = args
        if fy is None:
            rows = _selection_int(biy, win_h, hpad)
            cols = _selection_int(bix, win_w, wpad)
        else:
            rows = _selection_bilinear(biy, bfy, win_h, hpad)
            cols = _selection_bilinear(bix, bfx, win_w, wpad)
        return _apply_selection_block(rows, cols, imgs)

    zeros = jnp.zeros_like(iy, jnp.float32)
    fy_in = zeros if fy is None else fy
    fx_in = zeros if fx is None else fx
    if n <= _SEL_CHUNK or n % _SEL_CHUNK != 0:
        return block((iy, ix, fy_in, fx_in))
    chunks = n // _SEL_CHUNK

    def reshape_c(a):
        return a.reshape(chunks, _SEL_CHUNK, *a.shape[1:])

    out = jax.lax.map(
        block, (reshape_c(iy), reshape_c(ix), reshape_c(fy_in), reshape_c(fx_in))
    )  # (chunks, C, chunk, wh, ww)
    out = jnp.moveaxis(out, 1, 0)
    return out.reshape(out.shape[0], n, win_h, win_w)


@functools.partial(
    jax.jit,
    static_argnames=("win_size", "max_iters", "eps", "min_eig_threshold"),
)
def lk_track(
    prev_levels: Sequence[PaddedLevel],
    next_levels: Sequence[PaddedLevel],
    points: jnp.ndarray,
    valid: jnp.ndarray,
    win_size: int = 21,
    max_iters: int = 30,
    eps: float = 0.01,
    min_eig_threshold: float = 1e-4,
):
    """Track points from the prev pyramid into the next pyramid.

    points: (N, 2) float32 [x, y] at level 0; valid: (N,) bool.
    Level images may be (Hp, Wp) gray or (C, Hp, Wp) multi-channel: the
    reference passes 3-channel BGR subframes to cv2.calcOpticalFlowPyrLK
    (/root/reference/meshflowstabilizer.py:618), whose gradient matrix and
    photometric residuals accumulate over channels — gray-only tracking
    fails OpenCV's minEig threshold on weak-texture windows that color
    tracking keeps.
    Returns (next_points (N, 2) float32, status (N,) bool).  Invalid input
    slots come back with status False and their input position.

    """
    half = (win_size - 1) * 0.5
    max_level = len(prev_levels) - 1
    eps2 = eps * eps
    win_area = float(win_size * win_size)
    # OpenCV accumulates with Scharr values (32x gradient) and FLT_SCALE
    # 2^-20; with true-unit gradients our A is 1024x OpenCV's.
    cv_scale = 1.0 / 1024.0

    status = valid
    next_pts = points / (2.0**max_level)

    for level in range(max_level, -1, -1):
        plevel = prev_levels[level]
        nlevel = next_levels[level]

        def chan(a):
            return a if a.ndim == 3 else a[None]

        p_img, p_gx, p_gy = chan(plevel.image), chan(plevel.gx), chan(plevel.gy)
        n_img = chan(nlevel.image)
        num_ch = p_img.shape[0]
        rows = p_img.shape[-2] - 2 * _PAD
        cols = p_img.shape[-1] - 2 * _PAD
        hpad = rows + 2 * _PAD
        wpad = cols + 2 * _PAD
        prev_pts_l = points / (2.0**level) - half
        if level != max_level:
            next_pts = next_pts * 2.0
        next_corner = next_pts - half

        ipx = jnp.floor(prev_pts_l[:, 0])
        ipy = jnp.floor(prev_pts_l[:, 1])
        a = prev_pts_l[:, 0] - ipx
        b = prev_pts_l[:, 1] - ipy
        ipx = ipx.astype(jnp.int32)
        ipy = ipy.astype(jnp.int32)

        in_bounds_prev = (
            (ipx >= -win_size) & (ipx < cols) & (ipy >= -win_size) & (ipy < rows)
        )

        # --- prev windows: bilinear selection matmuls off the full level ---
        ipy_c = jnp.clip(ipy + _PAD, 0, hpad - (win_size + 1))
        ipx_c = jnp.clip(ipx + _PAD, 0, wpad - (win_size + 1))
        prev_imgs = jnp.concatenate([p_img, p_gx, p_gy], axis=0)  # (3C, Hp, Wp)
        wins = _extract_windows(
            prev_imgs, ipy_c, ipx_c, win_size, win_size, fy=b, fx=a
        )  # (3C, N, w, w)
        # (N, C, w, w) each
        iwin = jnp.swapaxes(wins[:num_ch], 0, 1)
        gxwin = jnp.swapaxes(wins[num_ch : 2 * num_ch], 0, 1)
        gywin = jnp.swapaxes(wins[2 * num_ch :], 0, 1)

        a11 = jnp.sum(gxwin * gxwin, axis=(1, 2, 3))
        a12 = jnp.sum(gxwin * gywin, axis=(1, 2, 3))
        a22 = jnp.sum(gywin * gywin, axis=(1, 2, 3))

        a11c, a12c, a22c = a11 * cv_scale, a12 * cv_scale, a22 * cv_scale
        det = a11c * a22c - a12c * a12c
        min_eig = (
            a22c + a11c - jnp.sqrt((a11c - a22c) ** 2 + 4.0 * a12c * a12c)
        ) / (2.0 * win_area)
        well_posed = (min_eig >= min_eig_threshold) & (det >= 1.19209290e-07)

        active0 = valid & in_bounds_prev & well_posed
        if level == 0:
            status = status & in_bounds_prev & well_posed

        inv_det = jnp.where(det == 0, 0.0, 1.0 / det)

        patch_h, patch_w = _PATCH_TOP if level == max_level else _PATCH_LOWER
        patch_h = min(patch_h, hpad)
        patch_w = min(patch_w, wpad)
        margin_y = (patch_h - (win_size + 1)) // 2
        margin_x = (patch_w - (win_size + 1)) // 2

        def solve_round(round_state, _):
            """One patch-fetch + iterate round.

            Features that wander past the patch margin pause (their window
            would freeze); the next round re-fetches a patch centered on
            their current estimate and resumes, so large motions follow
            OpenCV instead of clamping.
            """
            corner0, finished, st0, used0 = round_state
            patch_y0 = jnp.floor(corner0[:, 1]).astype(jnp.int32) - margin_y
            patch_x0 = jnp.floor(corner0[:, 0]).astype(jnp.int32) - margin_x
            patch_y0 = jnp.clip(patch_y0 + _PAD, 0, hpad - patch_h)
            patch_x0 = jnp.clip(patch_x0 + _PAD, 0, wpad - patch_w)
            jpatch = jnp.swapaxes(
                _extract_windows(n_img, patch_y0, patch_x0, patch_h, patch_w),
                0, 1,
            )  # (N, C, patch_h, patch_w)

            def iter_cond(state):
                j, _, active, _, _, _, _ = state
                return (j < max_iters) & jnp.any(active)

            def iter_body(state):
                j, corner, active, prev_delta, st, done, used = state
                icx = jnp.floor(corner[:, 0])
                icy = jnp.floor(corner[:, 1])
                fa = corner[:, 0] - icx
                fb = corner[:, 1] - icy
                icx = icx.astype(jnp.int32)
                icy = icy.astype(jnp.int32)
                inb = (
                    (icx >= -win_size) & (icx < cols)
                    & (icy >= -win_size) & (icy < rows)
                )
                if level == 0:
                    st = st & (inb | ~active)
                done = done | (active & ~inb)  # out of image: stop for good
                still = active & inb

                oy_raw = icy + _PAD - patch_y0
                ox_raw = icx + _PAD - patch_x0
                oy = jnp.clip(oy_raw, 0, patch_h - (win_size + 1))
                ox = jnp.clip(ox_raw, 0, patch_w - (win_size + 1))
                # Past the margin: pause this round (not marked done, so the
                # next solve_round resumes from a re-centered patch).
                left_patch = (oy_raw != oy) | (ox_raw != ox)
                still = still & ~left_patch
                wrow = _selection_bilinear(oy, fb, win_size, patch_h)
                wcol = _selection_bilinear(ox, fa, win_size, patch_w)
                tmp = jax.lax.dot_general(
                    wrow, jpatch, (((2,), (2,)), ((0,), (0,))),
                    precision=_selection_precision(),
                )  # (N, win, C, patch_w)
                jwin = jax.lax.dot_general(
                    tmp, wcol, (((3,), (2,)), ((0,), (0,))),
                    precision=_selection_precision(),
                )  # (N, win, C, win)
                jwin = jnp.swapaxes(jwin, 1, 2)  # (N, C, win, win)

                diff = jwin - iwin
                b1 = jnp.sum(diff * gxwin, axis=(1, 2, 3)) * cv_scale
                b2 = jnp.sum(diff * gywin, axis=(1, 2, 3)) * cv_scale
                dx = (a12c * b2 - a22c * b1) * inv_det
                dy = (a12c * b1 - a11c * b2) * inv_det
                delta = jnp.stack([dx, dy], axis=-1)

                new_corner = jnp.where(still[:, None], corner + delta, corner)

                converged = jnp.sum(delta * delta, axis=-1) <= eps2
                oscillating = (j > 0) & (
                    (jnp.abs(delta[:, 0] + prev_delta[:, 0]) < 0.01)
                    & (jnp.abs(delta[:, 1] + prev_delta[:, 1]) < 0.01)
                )
                new_corner = jnp.where(
                    (still & oscillating)[:, None],
                    new_corner - delta * 0.5, new_corner,
                )
                # Per-feature iteration budget matches OpenCV's criteria
                # even across patch-refresh rounds.
                used = used + still.astype(jnp.int32)
                exhausted = used >= max_iters
                done = done | (still & (converged | oscillating | exhausted))
                new_active = still & ~converged & ~oscillating & ~exhausted
                return j + 1, new_corner, new_active, delta, st, done, used

            active_in = active0 & ~finished
            _, corner_end, _, _, st_end, done_end, used_end = jax.lax.while_loop(
                iter_cond,
                iter_body,
                (
                    jnp.asarray(0, jnp.int32),
                    corner0,
                    active_in,
                    jnp.zeros_like(corner0),
                    st0,
                    finished,
                    used0,
                ),
            )
            return (corner_end, done_end, st_end, used_end), None

        (next_corner, _, status, _), _ = jax.lax.scan(
            solve_round,
            (
                next_corner,
                jnp.zeros_like(valid),
                status,
                jnp.zeros(valid.shape, jnp.int32),
            ),
            None,
            length=3,
        )
        next_pts = next_corner + half

    out_pts = jnp.where(valid[:, None], next_pts, points)
    return out_pts, status & valid
