"""Kernel checks: each device stage against the same jitted function on the
CPU, at real widths, in one process.

chip_smoke.py (phase 1) and the `gpu`-marked tests call these with the GPU;
the CPU rehearsal calls them with the CPU on both sides at tiny sizes.  Each
check returns a CheckResult that carries its error, its tolerance and the
matmul precision it ran at.  Tolerances and why:

* LK tracker: endpoint error <= 1e-2 px on >= 99.5% of the features both
  sides track, and status agreement >= 99.5% — the same 1e-2 px as the cv2
  oracle tolerance in tests/test_lk.py; it covers reduction order.
* backward map: coverage identical, and p99.9 |d map| <= 1e-3 px over
  covered pixels (float32 homographies at 1080p coordinates).
* crop + stretch: max |d| <= 1 level of 255 (rounding of float32 sums).
* FAST keypoints: identical (integer arithmetic throughout).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

import jax
import jax.numpy as jnp

from meshflow.config import MeshFlowConfig
from meshflow.kernels.color import bgr_to_gray
from meshflow.kernels.fast import Keypoints, detect_keypoints
from meshflow.kernels.lk import _selection_precision
from meshflow.motion.features import track_pair
from meshflow.motion.pipeline import tile_pyramid
from meshflow.render.stabilize import backward_map, crop_frames
from meshflow.synth import synthetic_clip
from meshflow.utils import grid


@dataclasses.dataclass
class CheckResult:
    name: str
    error: str  # the measured error, as printed
    tolerance: str
    precision: str
    ok: bool

    def line(self) -> str:
        verdict = "ok" if self.ok else "FAIL"
        return (
            f"{self.name}: {self.error}; tolerance {self.tolerance}; "
            f"precision {self.precision} -> {verdict}"
        )


def _on(device, fn, arrays, **static):
    """fn(*arrays, **static) with the arrays committed to `device` (so the
    computation runs there), results as NumPy."""
    return jax.tree.map(np.asarray, fn(*jax.device_put(arrays, device), **static))


def _precision_on(device) -> str:
    if device.platform == "cpu":
        return "float32 (CPU)"
    return str(_selection_precision())


@functools.partial(
    jax.jit, static_argnames=("config", "frame_height", "frame_width")
)
def _track(frames, positions, valid, config, frame_height, frame_width):
    max_level = config.lk_max_level(frame_height, frame_width)
    prev_lv = tile_pyramid(frames[0], config, max_level)
    next_lv = tile_pyramid(frames[1], config, max_level)
    early = Keypoints(
        positions=positions, scores=jnp.zeros(valid.shape, jnp.int32), valid=valid
    )
    return track_pair(early, prev_lv, next_lv, config, frame_height, frame_width)


def check_lk(device, height=360, width=640, seed=0) -> CheckResult:
    """The tile-pyramid LK tracker on a seeded pair at (height, width)."""
    reference = jax.devices("cpu")[0]
    config = MeshFlowConfig()
    frames = synthetic_clip(2, height, width, seed)
    static = dict(config=config, frame_height=height, frame_width=width)
    kps = _on(reference, detect_keypoints, (bgr_to_gray(frames[0]),), **static)
    ran = [
        _on(d, _track, (frames, kps.positions, kps.valid), **static)
        for d in (device, reference)
    ]
    (pos_a, st_a), (pos_b, st_b) = ran
    valid = kps.valid
    both = st_a & st_b & valid
    err = np.linalg.norm(pos_a - pos_b, axis=-1)[both]
    within = float((err <= 1e-2).mean()) if err.size else 0.0
    agree = float((st_a == st_b)[valid].mean())
    return CheckResult(
        name=f"LK tracker {width}x{height} ({int(valid.sum())} features)",
        error=(
            f"max endpoint err {err.max() if err.size else float('nan'):.3g} px, "
            f"{100 * within:.2f}% within 1e-2 px, status agree {100 * agree:.2f}%"
        ),
        tolerance=">= 99.5% within 1e-2 px, status agree >= 99.5%",
        precision=_precision_on(device),
        ok=bool(err.size) and within >= 0.995 and agree >= 0.995,
    )


def warped_mesh(config: MeshFlowConfig, height: int, width: int, seed: int):
    """(stab_pos, unstab_grid): the vertex grid under a smooth seeded warp of
    a few pixels, as a solved frame's displacements give."""
    rng = np.random.default_rng(seed)
    unstab = np.asarray(grid.vertex_grid(config, height, width), np.float32)
    rows, cols = unstab.shape[:2]
    coarse = rng.normal(0.0, 1.0, (3, 3, 2))
    yi = np.linspace(0, 2, rows)[:, None]
    xi = np.linspace(0, 2, cols)[None, :]
    # bilinear upsample of a 3x3 random field: smooth, like a mesh path
    y0 = np.minimum(yi.astype(int), 1)
    x0 = np.minimum(xi.astype(int), 1)
    fy, fx = (yi - y0)[..., None], (xi - x0)[..., None]
    field = (
        coarse[y0, x0] * (1 - fy) * (1 - fx)
        + coarse[y0 + 1, x0] * fy * (1 - fx)
        + coarse[y0, x0 + 1] * (1 - fy) * fx
        + coarse[y0 + 1, x0 + 1] * fy * fx
    )
    scale = 4.0 * height / 360.0
    return (unstab + scale * field).astype(np.float32), unstab


def check_backward_map(
    device, height=1080, width=1920, mesh=16, seed=0
) -> CheckResult:
    """The one-pass backward map at (height, width) on a mesh x mesh grid."""
    reference = jax.devices("cpu")[0]
    config = MeshFlowConfig(mesh_row_count=mesh, mesh_col_count=mesh)
    stab, unstab = warped_mesh(config, height, width, seed)
    a, b = (
        _on(
            d, backward_map, (stab, unstab),
            config=config, frame_height=height, frame_width=width,
        )
        for d in (device, reference)
    )
    mismatch = int((a.covered != b.covered).sum())
    cov = a.covered & b.covered
    dmap = np.maximum(
        np.abs(a.map_x - b.map_x)[cov], np.abs(a.map_y - b.map_y)[cov]
    )
    p999 = float(np.percentile(dmap, 99.9)) if dmap.size else float("nan")
    return CheckResult(
        name=f"backward map {width}x{height} mesh {mesh}x{mesh}",
        error=(
            f"coverage mismatch {mismatch} px, p99.9 |d map| {p999:.3g} px, "
            f"max {dmap.max() if dmap.size else float('nan'):.3g} px"
        ),
        tolerance="coverage mismatch 0, p99.9 |d map| <= 1e-3 px",
        precision="bf16 one-hot x 3-term split table, float32 accumulate",
        ok=mismatch == 0 and p999 <= 1e-3,
    )


def check_crop_stretch(
    device, height=1080, width=1920, num_frames=2, seed=0
) -> CheckResult:
    """Crop + stretch (two hat-function contractions) at (height, width)."""
    reference = jax.devices("cpu")[0]
    frames = synthetic_clip(num_frames, height, width, seed)
    crop = np.asarray(
        [width // 16, height // 20, width - 1 - width // 12, height - 1 - height // 15],
        np.int32,
    )
    a, b = (
        _on(d, crop_frames, (frames, crop), frame_height=height, frame_width=width)
        for d in (device, reference)
    )
    err = int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
    return CheckResult(
        name=f"crop+stretch {width}x{height} x{num_frames}",
        error=f"max |d| {err} levels",
        tolerance="<= 1 level of 255",
        precision="HIGHEST",
        ok=err <= 1,
    )


def _keypoint_sets(kps, k: int):
    """Per subframe: sorted kept scores, and {(x, y, score)} above the
    top-K cutoff (ties at the cutoff may pick either of equal corners)."""
    out = []
    for s in range(kps.valid.shape[0]):
        v = kps.valid[s]
        scores = np.sort(kps.scores[s][v])
        cutoff = scores[0] if v.sum() == k else -1
        keep = v & (kps.scores[s] > cutoff)
        pts = {
            (float(x), float(y), int(c))
            for (x, y), c in zip(kps.positions[s][keep], kps.scores[s][keep])
        }
        out.append((tuple(scores.tolist()), pts))
    return out


def check_fast(device, height=1080, width=1920, seed=0) -> CheckResult:
    """FAST keypoints (score map, NMS, per-subframe top-K) at (height, width)."""
    reference = jax.devices("cpu")[0]
    config = MeshFlowConfig()
    gray = bgr_to_gray(synthetic_clip(1, height, width, seed)[0])
    a, b = (
        _on(
            d, detect_keypoints, (gray,),
            config=config, frame_height=height, frame_width=width,
        )
        for d in (device, reference)
    )
    sa = _keypoint_sets(a, config.max_features_per_subframe)
    sb = _keypoint_sets(b, config.max_features_per_subframe)
    differ = sum(x != y for x, y in zip(sa, sb))
    return CheckResult(
        name=f"FAST keypoints {width}x{height} ({int(a.valid.sum())} kept)",
        error=f"{differ} of {len(sa)} subframes differ",
        tolerance="identical",
        precision="int32",
        ok=differ == 0,
    )


def run_all(device, lk=(360, 640), frame=(1080, 1920), meshes=(16, 64)):
    """Every check, at the given (height, width) sizes."""
    results = [check_lk(device, *lk)]
    results += [check_backward_map(device, *frame, mesh=m) for m in meshes]
    results.append(check_crop_stretch(device, *frame))
    results.append(check_fast(device, *frame))
    return results
