"""Render-layer tests: warp identity/translation invariants, crop+resize vs
cv2.resize, and stage parity against the reference warp on synthetic data.
"""

import sys

import cv2
import numpy as np
import jax.numpy as jnp
import pytest

from meshflow.config import MeshFlowConfig
from meshflow.render.stabilize import (
    backward_map,
    crop_frames,
    crop_resize_frame,
    render_stabilized,
)
from meshflow.utils.grid import vertex_grid


def _frame(rng, h=120, w=160):
    img = rng.integers(0, 256, size=(h // 6, w // 6, 3), dtype=np.uint8)
    img = cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)
    return cv2.GaussianBlur(img, (3, 3), 0.8)


def test_identity_displacement_is_identity(rng):
    config = MeshFlowConfig()
    h, w = 120, 160
    frame = _frame(rng, h, w)
    vg = jnp.asarray(vertex_grid(config, h, w))
    zeros = jnp.zeros((1, config.vertex_rows, config.vertex_cols, 2), jnp.float32)
    stabilized, crop = render_stabilized(
        jnp.asarray(frame[None]), zeros, zeros, vg, config, h, w
    )
    np.testing.assert_array_equal(np.asarray(stabilized[0]), frame)
    np.testing.assert_array_equal(np.asarray(crop), [0, 0, w - 1, h - 1])


def test_translation_displacement_shifts_content(rng):
    config = MeshFlowConfig()
    h, w = 120, 160
    frame = _frame(rng, h, w)
    vg = jnp.asarray(vertex_grid(config, h, w))
    zeros = jnp.zeros((1, config.vertex_rows, config.vertex_cols, 2), jnp.float32)
    t = np.array([7.0, -5.0], np.float32)  # stabilized = grid + t
    stab = zeros + jnp.asarray(t)
    stabilized, crop = render_stabilized(
        jnp.asarray(frame[None]), zeros, stab, vg, config, h, w
    )
    out = np.asarray(stabilized[0])
    # output pixel p samples source p - t
    interior = out[10:110, 10:140]
    expected = frame[10 - int(t[1]) : 110 - int(t[1]), 10 - int(t[0]) : 140 - int(t[0])]
    np.testing.assert_array_equal(interior, expected)
    # border color appears where the source is out of range (left strip)
    assert (out[:, :6] == np.array([0, 0, 255], np.uint8)).all(axis=-1).mean() > 0.9
    # crop edges: left edge matches where |map_x| < 1 -> x in (tx-1, tx+1)
    left, top, right, bottom = np.asarray(crop)
    assert left == 7  # max x with |x - 7| < 1
    assert bottom == h - 1 - 5  # min y with |y - (h-1) + 5... via map
    assert right == w - 1
    assert top == 0


def test_crop_resize_matches_cv2(rng):
    frame = _frame(rng, 120, 160)
    crop = np.array([12, 7, 140, 100], np.int32)  # left, top, right, bottom
    ours = np.asarray(
        crop_resize_frame(jnp.asarray(frame), jnp.asarray(crop), 120, 160)
    )
    ref = cv2.resize(frame[7:101, 12:141], (160, 120))
    diff = np.abs(ours.astype(int) - ref.astype(int))
    # cv2 resize uses Q11 fixed-point weights; allow off-by-one rounding
    assert (diff <= 1).mean() > 0.999
    assert diff.max() <= 2


@pytest.mark.slow
def test_warp_parity_with_reference(rng):
    sys.path.insert(0, "/root/reference")
    import meshflowstabilizer as ref_mod

    config = MeshFlowConfig()
    h, w = 120, 160
    num_frames = 2
    frames = [np.ascontiguousarray(_frame(rng, h, w)) for _ in range(num_frames)]
    vr, vc = config.vertex_rows, config.vertex_cols
    unstab = rng.normal(scale=2.0, size=(num_frames, vr, vc, 2))
    stab = unstab + rng.normal(scale=3.0, size=(num_frames, vr, vc, 2))
    # smooth the difference so quads stay convex (realistic Jacobi output)
    diff = cv2.GaussianBlur(
        (stab - unstab).reshape(num_frames * vr, vc * 2).astype(np.float32), (5, 5), 1.5
    ).reshape(num_frames, vr, vc, 2)
    stab = unstab + diff

    ref = ref_mod.MeshFlowStabilizer()
    ref_frames, ref_crop = ref._get_stabilized_frames_and_crop_boundaries(
        num_frames, frames, unstab, stab
    )

    vg = jnp.asarray(vertex_grid(config, h, w))
    stabilized, crop = render_stabilized(
        jnp.asarray(np.stack(frames)),
        jnp.asarray(unstab, jnp.float32),
        jnp.asarray(stab, jnp.float32),
        vg,
        config,
        h,
        w,
    )
    stabilized = np.asarray(stabilized)

    for t in range(num_frames):
        diff_img = np.abs(
            stabilized[t].astype(int) - ref_frames[t].astype(int)
        ).max(axis=-1)
        match99 = (diff_img <= 2).mean()
        assert match99 > 0.97, f"frame {t}: only {match99:.3f} within 2"
    l, t_, r, b = np.asarray(crop)
    rl, rt, rr, rb = ref_crop
    assert abs(l - rl) <= 1 and abs(t_ - rt) <= 1
    assert abs(r - rr) <= 1 and abs(b - rb) <= 1


def test_backward_map_covers_frame_for_smooth_warp(rng):
    config = MeshFlowConfig()
    h, w = 120, 160
    vg = jnp.asarray(vertex_grid(config, h, w))
    stab_pos = vg + jnp.asarray(
        cv2.GaussianBlur(rng.normal(scale=2.0, size=(17, 17, 2)).astype(np.float32).reshape(17, 34), (5, 5), 2.0).reshape(17, 17, 2)
    )
    bmap = backward_map(stab_pos, vg, config, h, w)
    # A mild warp keeps nearly the whole frame covered.
    assert np.asarray(bmap.covered).mean() > 0.95


def test_bilinear_sample_packed_paths_match_generic(rng):
    """The packed u8 gather paths (3-channel uint32 word, 1-channel 2x2
    quad word) must be bit-identical to the generic float gather across
    inside/outside/edge/fractional coords, with and without a border
    color.  The generic path is forced via a uint16 copy of the same
    values (only u8 takes the packed routes)."""
    from meshflow.render.stabilize import bilinear_sample

    h, w = 37, 53
    n = 4000
    sx = rng.uniform(-4, w + 3, size=n).astype(np.float32)
    sy = rng.uniform(-4, h + 3, size=n).astype(np.float32)
    sx[:50] = np.arange(50) % w  # exact integers hit the clamp corners
    sy[:50] = (np.arange(50) * 7) % h

    for c, border in [(1, None), (1, [99.0]), (3, None), (3, [9.0, 99.0, 199.0])]:
        frame = rng.integers(0, 256, size=(h, w, c), dtype=np.uint8)
        packed = np.asarray(
            bilinear_sample(
                jnp.asarray(frame), jnp.asarray(sx), jnp.asarray(sy), border
            )
        )
        generic = np.asarray(
            bilinear_sample(
                jnp.asarray(frame.astype(np.uint16)),
                jnp.asarray(sx),
                jnp.asarray(sy),
                border,
            )
        )
        assert packed.shape == generic.shape == (n, c)
        assert np.array_equal(packed, generic), (c, border)


def _backward_map_f64(stab, unstab, mesh, h, w):
    """NumPy float64 oracle of render.stabilize.backward_map: per-cell
    stabilized->unstabilized homographies by an 8x8 DLT solve, the 3-step
    fixed-point cell search, then the 3x3 candidate pass (member iff the
    mapped point lies strictly inside the cell's integer bbox grown by
    1 px; the highest row-major cell wins)."""
    stab = stab.astype(np.float64)
    unstab = unstab.astype(np.float64)
    cells = np.empty((mesh, mesh, 3, 3))
    for r in range(mesh):
        for c in range(mesh):
            src = [stab[r + i, c + j] for i, j in ((0, 0), (0, 1), (1, 0), (1, 1))]
            dst = [unstab[r + i, c + j] for i, j in ((0, 0), (0, 1), (1, 0), (1, 1))]
            a, b = [], []
            for (x, y), (u, v) in zip(src, dst):
                a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
                a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
                b += [u, v]
            cells[r, c] = np.append(np.linalg.solve(np.array(a), np.array(b)), 1.0).reshape(3, 3)
    lines_x = -(-((w - 1) * np.arange(mesh + 1)) // mesh)
    lines_y = -(-((h - 1) * np.arange(mesh + 1)) // mesh)
    py, px = np.mgrid[0:h, 0:w].astype(np.float64)

    def apply(row, col):
        m = cells[row, col]  # (h, w, 3, 3)
        d = m[..., 2, 0] * px + m[..., 2, 1] * py + m[..., 2, 2]
        d = np.where(np.abs(d) < 1e-10, 1e-10, d)
        return (
            (m[..., 0, 0] * px + m[..., 0, 1] * py + m[..., 0, 2]) / d,
            (m[..., 1, 0] * px + m[..., 1, 1] * py + m[..., 1, 2]) / d,
        )

    def cell_of(qx, qy):
        col = (qx[..., None] >= lines_x[1:-1]).sum(-1)
        row = (qy[..., None] >= lines_y[1:-1]).sum(-1)
        return np.clip(row, 0, mesh - 1), np.clip(col, 0, mesh - 1)

    qx, qy = px, py
    for _ in range(3):
        qx, qy = apply(*cell_of(qx, qy))
    row0, col0 = cell_of(qx, qy)
    best = np.full((h, w), -1)
    map_x = np.full((h, w), w + 1.0)
    map_y = np.full((h, w), h + 1.0)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            row = np.clip(row0 + dr, 0, mesh - 1)
            col = np.clip(col0 + dc, 0, mesh - 1)
            cx, cy = apply(row, col)
            member = (
                (cx > lines_x[col] - 1) & (cx < lines_x[col + 1] + 1)
                & (cy > lines_y[row] - 1) & (cy < lines_y[row + 1] + 1)
            )
            key = row * mesh + col
            take = member & (key > best)
            best = np.where(take, key, best)
            map_x = np.where(take, cx, map_x)
            map_y = np.where(take, cy, map_y)
    return map_x, map_y, best >= 0


@pytest.mark.parametrize(
    "mesh,h,w,scale",
    [
        (16, 48, 64, 1.5),   # default mesh density, mild warp
        (4, 40, 56, 6.0),    # coarse cells, strong warp (uncovered px)
        (16, 48, 64, 12.0),  # heavy warp: sentinel + membership edges
    ],
)
def test_backward_map_matches_float64_oracle(mesh, h, w, scale):
    """The XLA backward map (bf16 one-hot x 3-term split table) against a
    float64 NumPy implementation of the same algorithm."""
    config = MeshFlowConfig(mesh_row_count=mesh, mesh_col_count=mesh)
    rng = np.random.default_rng(mesh * 7 + int(scale))
    unstab = np.asarray(vertex_grid(config, h, w), np.float32)
    stab = unstab + rng.normal(0.0, scale, unstab.shape).astype(np.float32)

    ours = backward_map(jnp.asarray(stab), jnp.asarray(unstab), config, h, w)
    map_x, map_y, covered = _backward_map_f64(stab, unstab, mesh, h, w)

    np.testing.assert_array_equal(np.asarray(ours.covered), covered)
    assert (~covered).any() or scale < 6.0  # strong warps leave gaps
    np.testing.assert_allclose(np.asarray(ours.map_x), map_x, rtol=0, atol=1e-3)
    np.testing.assert_allclose(np.asarray(ours.map_y), map_y, rtol=0, atol=1e-3)
