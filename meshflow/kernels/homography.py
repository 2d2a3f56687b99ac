"""Batched homography estimation on the accelerator.

Accelerator-native replacements for the reference's OpenCV calls:

* ``cv2.findHomography(pts, pts2)`` — default least-squares DLT over all
  points followed by LM refinement (used at
  /root/reference/meshflowstabilizer.py:524-526 for the global per-pair
  homography, :1041-1042 for per-cell homographies from 4 corner pairs,
  and :1195-1197 in the metrics path).
* ``cv2.findHomography(..., method=cv2.RANSAC)`` — per-subframe outlier
  rejection (:569-571).  OpenCV's RANSAC is adaptive-iteration; ours runs a
  fixed, seeded iteration count so the whole thing vmaps over subframes and
  frame pairs.  Exact inlier sets therefore differ; the parity gate is the
  end-to-end quality metrics (±1%), not bitwise masks.
* ``cv2.perspectiveTransform`` (:325, :420) — ``apply_homography``.

All functions are shape-polymorphic over leading batch dims via vmap and use
masked fixed-capacity point sets (weight 0 rows) instead of ragged arrays.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# This JAX build lowers float32 matmuls to bfloat16 by default (~1e-2 relative
# error) on every backend.  All matmuls in this module are tiny (3x3 / 8x8 /
# Nx9 solves) and precision-critical, so they pin Precision.HIGHEST.
_HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HIGHEST)


def apply_homography(h: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Perspective-transform points.

    h: (..., 3, 3); pts: (..., N, 2) -> (..., N, 2)
    """
    x, y = pts[..., 0], pts[..., 1]
    w = h[..., 2:3, 0] * x + h[..., 2:3, 1] * y + h[..., 2:3, 2]
    xn = h[..., 0:1, 0] * x + h[..., 0:1, 1] * y + h[..., 0:1, 2]
    yn = h[..., 1:2, 0] * x + h[..., 1:2, 1] * y + h[..., 1:2, 2]
    w = jnp.where(jnp.abs(w) < 1e-10, 1e-10, w)
    return jnp.stack([xn / w, yn / w], axis=-1)


def _normalize_points(pts: jnp.ndarray, weights: jnp.ndarray):
    """Hartley normalization of a weighted point set.

    Returns (normalized points, T) with T the 3x3 similarity such that
    normalized = T @ [pts; 1].  Weighted centroid at origin, weighted RMS
    distance sqrt(2).
    """
    wsum = jnp.maximum(jnp.sum(weights), 1e-6)
    centroid = jnp.sum(pts * weights[:, None], axis=0) / wsum
    centered = pts - centroid
    rms = jnp.sqrt(
        jnp.sum(weights * jnp.sum(centered**2, axis=-1)) / wsum
    )
    scale = jnp.sqrt(2.0) / jnp.maximum(rms, 1e-6)
    t = jnp.array(
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
        dtype=pts.dtype,
    )
    t = t.at[0, 0].set(scale).at[1, 1].set(scale)
    t = t.at[0, 2].set(-scale * centroid[0]).at[1, 2].set(-scale * centroid[1])
    return centered * scale, t


def dlt_homography(
    early: jnp.ndarray, late: jnp.ndarray, weights: jnp.ndarray
) -> jnp.ndarray:
    """Weighted direct linear transform.

    early, late: (N, 2); weights: (N,) nonnegative (0 masks a row out).
    Returns (3, 3) homography normalized to H[2,2] = 1.

    Solved via the 9x9 normal matrix's smallest eigenvector (the same
    strategy OpenCV's homography kernel uses), after Hartley normalization
    of both point sets for conditioning in float32.
    """
    en, te = _normalize_points(early, weights)
    ln, tl = _normalize_points(late, weights)
    x, y = en[:, 0], en[:, 1]
    xp, yp = ln[:, 0], ln[:, 1]
    zeros = jnp.zeros_like(x)
    ones = jnp.ones_like(x)
    row1 = jnp.stack(
        [x, y, ones, zeros, zeros, zeros, -x * xp, -y * xp, -xp], axis=-1
    )
    row2 = jnp.stack(
        [zeros, zeros, zeros, x, y, ones, -x * yp, -y * yp, -yp], axis=-1
    )
    a = jnp.concatenate([row1, row2], axis=0)  # (2N, 9)
    w2 = jnp.concatenate([weights, weights], axis=0)
    # SVD of the weighted design matrix: unlike the 9x9 normal-matrix
    # eigendecomposition, this does not square the condition number, which
    # matters because the whole pipeline runs in float32 on the accelerator.
    # full_matrices=True: with exactly 4 points the design matrix is 8x9 and
    # the nullspace vector is the 9th right singular vector, which the
    # reduced SVD does not return.
    _, _, vt = jnp.linalg.svd(a * jnp.sqrt(w2)[:, None], full_matrices=True)
    h = vt[-1].reshape(3, 3)
    # Denormalize: H = Tl^-1 @ Hn @ Te
    h = jnp.linalg.solve(tl, _mm(h, te))
    h22 = h[2, 2]
    safe = jnp.where(jnp.abs(h22) < 1e-10, 1e-10, h22)
    return h / safe


def unit_square_to_quad(quad: jnp.ndarray) -> jnp.ndarray:
    """Closed-form projective map from the unit square to a quad.

    quad: (..., 4, 2) corners ordered [(0,0), (1,0), (0,1), (1,1)] ->
    (..., 3, 3).  Heckbert's formula; for parallelogram (affine) quads the
    perspective terms vanish identically, so rectangles map exactly —
    which the SVD-based DLT cannot guarantee in float32.
    """
    a, b, c, d = quad[..., 0, :], quad[..., 1, :], quad[..., 2, :], quad[..., 3, :]
    sigma = a - b - c + d
    d1 = b - d
    d2 = c - d
    den = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    den = jnp.where(jnp.abs(den) < 1e-12, 1e-12, den)
    g = (sigma[..., 0] * d2[..., 1] - sigma[..., 1] * d2[..., 0]) / den
    h = (d1[..., 0] * sigma[..., 1] - d1[..., 1] * sigma[..., 0]) / den
    row0 = jnp.stack(
        [b[..., 0] - a[..., 0] + g * b[..., 0],
         c[..., 0] - a[..., 0] + h * c[..., 0],
         a[..., 0]], axis=-1)
    row1 = jnp.stack(
        [b[..., 1] - a[..., 1] + g * b[..., 1],
         c[..., 1] - a[..., 1] + h * c[..., 1],
         a[..., 1]], axis=-1)
    row2 = jnp.stack([g, h, jnp.ones_like(g)], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def adjugate3(m: jnp.ndarray) -> jnp.ndarray:
    """Adjugate of (..., 3, 3): inverse up to the (nonzero) determinant —
    homographies are homogeneous, so the scale never matters."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return jnp.stack(
        [
            jnp.stack([e * i - f * h, c * h - b * i, b * f - c * e], axis=-1),
            jnp.stack([f * g - d * i, a * i - c * g, c * d - a * f], axis=-1),
            jnp.stack([d * h - e * g, b * g - a * h, a * e - b * d], axis=-1),
        ],
        axis=-2,
    )


def quad_to_quad_homography(src: jnp.ndarray, dst: jnp.ndarray) -> jnp.ndarray:
    """Exact homography mapping src quad corners onto dst quad corners.

    src, dst: (..., 4, 2) ordered [tl, tr, bl, br].  Replaces
    cv2.findHomography for the per-mesh-cell case
    (/root/reference/meshflowstabilizer.py:1041-1042): closed form, exact
    for rectangles, no iterative solve — vmaps over cells x frames freely.
    Result is homogeneous (not normalized to H22 = 1).
    """
    return jnp.matmul(
        unit_square_to_quad(dst), adjugate3(unit_square_to_quad(src)),
        precision=_HIGHEST,
    )


def _similarity_inverse(t: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse of a Hartley normalization matrix
    [[s, 0, tx], [0, s, ty], [0, 0, 1]]."""
    s = t[0, 0]
    inv = jnp.eye(3, dtype=t.dtype)
    inv = inv.at[0, 0].set(1.0 / s).at[1, 1].set(1.0 / s)
    inv = inv.at[0, 2].set(-t[0, 2] / s).at[1, 2].set(-t[1, 2] / s)
    return inv


def refine_homography(
    h: jnp.ndarray,
    early: jnp.ndarray,
    late: jnp.ndarray,
    weights: jnp.ndarray,
    iterations: int = 10,
) -> jnp.ndarray:
    """Gauss-Newton refinement of geometric transfer error.

    Mirrors OpenCV's post-DLT LM refinement (capped iterations, geometric
    reprojection residuals, H[2,2] pinned to 1).  The optimization runs in
    Hartley-normalized coordinates: in pixel space the eight parameters span
    ~6 orders of magnitude (perspective vs translation terms), which float32
    normal equations cannot survive; normalized, the system is benign.
    Keeps the best-so-far parameters so a diverging step never worsens the
    result.
    """
    en, te = _normalize_points(early, weights)
    ln, tl = _normalize_points(late, weights)
    hn = _mm(_mm(tl, h), _similarity_inverse(te))
    early, late = en, ln
    h22 = hn[2, 2]
    hn = hn / jnp.where(jnp.abs(h22) < 1e-10, 1e-10, h22)
    params0 = hn.reshape(-1)[:8]

    def cost_and_system(p):
        hh = jnp.concatenate([p, jnp.ones((1,), p.dtype)]).reshape(3, 3)
        x, y = early[:, 0], early[:, 1]
        d = hh[2, 0] * x + hh[2, 1] * y + 1.0
        d = jnp.where(jnp.abs(d) < 1e-10, 1e-10, d)
        xi = (hh[0, 0] * x + hh[0, 1] * y + hh[0, 2]) / d
        yi = (hh[1, 0] * x + hh[1, 1] * y + hh[1, 2]) / d
        rx = xi - late[:, 0]
        ry = yi - late[:, 1]
        cost = jnp.sum(weights * (rx**2 + ry**2))
        zeros = jnp.zeros_like(x)
        inv_d = 1.0 / d
        jx = jnp.stack(
            [x * inv_d, y * inv_d, inv_d, zeros, zeros, zeros,
             -x * xi * inv_d, -y * xi * inv_d], axis=-1)
        jy = jnp.stack(
            [zeros, zeros, zeros, x * inv_d, y * inv_d, inv_d,
             -x * yi * inv_d, -y * yi * inv_d], axis=-1)
        jtj = _mm((jx * weights[:, None]).T, jx) + _mm((jy * weights[:, None]).T, jy)
        jtr = _mm((jx * weights[:, None]).T, rx) + _mm((jy * weights[:, None]).T, ry)
        return cost, jtj, jtr

    def body(_, state):
        params, best_params, best_cost = state
        cost, jtj, jtr = cost_and_system(params)
        better = cost < best_cost
        best_params = jnp.where(better, params, best_params)
        best_cost = jnp.where(better, cost, best_cost)
        damped = jtj + 1e-6 * jnp.eye(8, dtype=jtj.dtype) * jnp.trace(jtj)
        step = jnp.linalg.solve(damped, jtr)
        step = jnp.where(jnp.all(jnp.isfinite(step)), step, jnp.zeros_like(step))
        return params - step, best_params, best_cost

    init = (params0, params0, jnp.asarray(jnp.inf, params0.dtype))
    params, best_params, best_cost = jax.lax.fori_loop(0, iterations, body, init)
    final_cost, _, _ = cost_and_system(params)
    best_params = jnp.where(final_cost < best_cost, params, best_params)
    hn_refined = jnp.concatenate([best_params, jnp.ones((1,), h.dtype)]).reshape(3, 3)
    # Back to pixel space: H = Tl^-1 @ Hn @ Te, renormalized to H[2,2] = 1.
    out = _mm(_mm(_similarity_inverse(tl), hn_refined), te)
    out22 = out[2, 2]
    return out / jnp.where(jnp.abs(out22) < 1e-10, 1e-10, out22)


def estimate_homography(
    early: jnp.ndarray,
    late: jnp.ndarray,
    weights: jnp.ndarray,
    refine_iterations: int = 10,
) -> jnp.ndarray:
    """DLT + Gauss-Newton: the ``cv2.findHomography(method=0)`` analog."""
    h = dlt_homography(early, late, weights)
    return refine_homography(h, early, late, weights, refine_iterations)


def _sample_distinct4(
    key: jax.Array, iterations: int, num_valid: jnp.ndarray
) -> jnp.ndarray:
    """(iterations, 4) distinct draws, exactly uniform over [0, num_valid).

    Sequential inverse-CDF sampling without replacement: the k-th draw is
    uniform over the ``num_valid - k`` values not yet chosen, then shifted
    past the already-chosen values in ascending order.  No modulo bias
    (randint spans are the dynamic counts themselves) and no repeated
    indices for num_valid >= 4 (below 4 the caller reports ok=False, so
    collisions there are harmless).  Mirrors cv2.findHomography(RANSAC)'s
    distinct 4-point sampling (reference: meshflowstabilizer.py:569-571).
    """
    m = num_valid
    k0, k1, k2, k3 = jax.random.split(key, 4)
    d0 = jax.random.randint(k0, (iterations,), 0, jnp.maximum(m, 1))
    d1 = jax.random.randint(k1, (iterations,), 0, jnp.maximum(m - 1, 1))
    d2 = jax.random.randint(k2, (iterations,), 0, jnp.maximum(m - 2, 1))
    d3 = jax.random.randint(k3, (iterations,), 0, jnp.maximum(m - 3, 1))
    d1 = d1 + (d1 >= d0)
    lo, hi = jnp.minimum(d0, d1), jnp.maximum(d0, d1)
    d2 = d2 + (d2 >= lo)
    d2 = d2 + (d2 >= hi)
    a = jnp.minimum(lo, d2)
    c = jnp.maximum(hi, d2)
    b = d0 + d1 + d2 - a - c
    d3 = d3 + (d3 >= a)
    d3 = d3 + (d3 >= b)
    d3 = d3 + (d3 >= c)
    return jnp.stack([d0, d1, d2, d3], axis=1)


@functools.partial(
    jax.jit,
    static_argnames=("iterations", "refine_iterations", "polish_rounds"),
)
def ransac_homography(
    early: jnp.ndarray,
    late: jnp.ndarray,
    valid: jnp.ndarray,
    key: jax.Array,
    threshold: float = 3.0,
    iterations: int = 256,
    refine_iterations: int = 10,
    polish_rounds: int = 0,
):
    """Fixed-iteration RANSAC homography with masked fixed-capacity points.

    early, late: (N, 2) float32; valid: (N,) bool.  Returns
    (h, inlier_mask, ok) where ok is False when fewer than 4 valid points
    exist or no model found >= 4 inliers.

    Replaces cv2.findHomography(method=cv2.RANSAC) with reproj threshold
    ``threshold`` (OpenCV default 3.0).  Sampling is uniform over the valid
    points via a stable argsort compaction, so the behavior is deterministic
    given the seed.

    polish_rounds > 0 re-estimates the inlier set against the refit model
    and refits, LO-RANSAC style: draws whose consensus sets differ contract
    to a common inlier fixed point, which removes most of the seed-to-seed
    spread of the downstream metrics (the distortion score is a MIN over
    frames of a RANSAC-dependent eigenvalue ratio, so a single divergent
    draw moves the video-level value; see tests/fixtures/our_seed_variance_*
    and /root/reference/meshflowstabilizer.py:1206-1212 — OpenCV's RANSAC
    is internally deterministic, so the reference has no such spread).
    """
    n = early.shape[0]
    num_valid = jnp.sum(valid.astype(jnp.int32))
    # Stable compaction: indices of valid points first.
    order = jnp.argsort(jnp.logical_not(valid), stable=True)

    draws = _sample_distinct4(key, iterations, num_valid)
    sample_idx = order[draws]  # (iterations, 4)

    sampled_early = early[sample_idx]  # (iterations, 4, 2)
    sampled_late = late[sample_idx]

    # Closed-form 4-point models: any consistent assignment of the four
    # correspondences to unit-square corners yields the exact-fit
    # homography, so no SVD is needed (degenerate samples produce junk
    # models that simply lose the consensus vote).
    h_candidates = quad_to_quad_homography(sampled_early, sampled_late)

    # Inlier counting: squared reprojection error < threshold^2.
    proj = jax.vmap(lambda h: apply_homography(h, early))(h_candidates)
    err2 = jnp.sum((proj - late[None]) ** 2, axis=-1)  # (iterations, N)
    finite = jnp.all(jnp.isfinite(h_candidates.reshape(iterations, -1)), axis=-1)
    inlier = (err2 < threshold * threshold) & valid[None] & finite[:, None]
    counts = jnp.sum(inlier, axis=-1)
    # Degenerate samples (repeated indices) produce near-singular models that
    # simply lose the consensus vote.
    best = jnp.argmax(counts)
    best_mask = inlier[best]
    ok = (counts[best] >= 4) & (num_valid >= 4)

    weights = best_mask.astype(early.dtype)
    h = estimate_homography(early, late, weights, refine_iterations)

    if polish_rounds > 0:
        thr2 = threshold * threshold

        def polish_body(_, carry):
            h_c, mask_c = carry
            proj = apply_homography(h_c, early)
            err2 = jnp.sum((proj - late) ** 2, axis=-1)
            new_mask = (err2 < thr2) & valid & jnp.all(jnp.isfinite(h_c))
            # A collapsing inlier set (< 4 points) keeps the previous round's
            # mask: the model cannot be re-fit from fewer correspondences.
            enough = jnp.sum(new_mask.astype(jnp.int32)) >= 4
            new_mask = jnp.where(enough, new_mask, mask_c)
            h_n = estimate_homography(
                early, late, new_mask.astype(early.dtype), refine_iterations
            )
            h_n = jnp.where(jnp.all(jnp.isfinite(h_n)), h_n, h_c)
            return h_n, new_mask

        h, best_mask = jax.lax.fori_loop(
            0, polish_rounds, polish_body, (h, best_mask)
        )

    identity = jnp.eye(3, dtype=early.dtype)
    h = jnp.where(ok & jnp.all(jnp.isfinite(h)), h, identity)
    return h, best_mask & ok, ok
