"""Frame-axis sharded stabilization across a device mesh.

The reference is single-threaded; its three `TODO parallelize` loops
(/root/reference/meshflowstabilizer.py:502, :692, :1030) parallelize on one
chip via batching.  This module adds the multi-chip axis from SURVEY.md
section 2.3: frames sharded over a 1-D jax.sharding.Mesh, with

* a one-frame halo exchange (lax.ppermute) so every shard can match its
  boundary pair,
* a distributed prefix sum for displacement integration (local cumsum +
  all_gather of shard totals),
* the temporal solver replicated — the (F, V, 2) state is ~0.5 MB, so
  replicating it and keeping all pixel work local is the right trade
  (collectives ride ICI; no DCN),
* crop rectangle via pmax/pmin, metrics via psum/pmin.

Single chip is the degenerate 1-shard case.  All collectives are XLA
primitives inside one shard_mapped, jitted step.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from meshflow.config import MeshFlowConfig
from meshflow.metrics.quality import cropping_and_distortion_scanned
from meshflow.motion.pipeline import (
    detect_all_frames,
    pair_velocity_scan,
)
from meshflow.kernels.color import bgr_to_gray
from meshflow.render.stabilize import crop_frames, render_stabilized
from meshflow.solver.jacobi import jacobi_smooth, jacobi_smooth_sharded
from meshflow.solver.weights import adaptive_weights
from meshflow.utils import grid

_AXIS = "frames"


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(devices, (_AXIS,))


def frame_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(_AXIS))


@functools.partial(
    jax.jit,
    static_argnames=(
        "config",
        "frame_height",
        "frame_width",
        "mesh",
        "adaptive_weights_definition",
        "solver_mode",
    ),
)
def stabilize_sharded(
    frames: jnp.ndarray,
    key: jax.Array,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
    mesh: Mesh,
    adaptive_weights_definition: int = 0,
    solver_mode: str = "halo",
):
    """Full stabilization step over a frame-sharded clip.

    frames: (F, H, W, 3) uint8, F divisible by mesh size, sharded on axis 0.
    Returns (cropped (F, H, W, 3) uint8 sharded, crop (4,), cropping_ratio,
    distortion_score, stability_score) — scalars replicated.

    solver_mode: "halo" keeps the (F, V, 2) solver state frame-sharded
    with an Omega-frame halo exchange per Jacobi sweep (bit-identical to
    "replicated", which all_gathers the state and solves everywhere —
    fine at ~0.5 MB but needlessly global for multi-minute clips).
    """
    num_frames = frames.shape[0]
    num_shards = mesh.shape[_AXIS]
    assert num_frames % num_shards == 0
    block = num_frames // num_shards
    if block < config.temporal_smoothing_radius:
        # Halo exchange reaches one neighbor; shards smaller than Omega
        # would need multi-hop halos, and at that size replicating the
        # tiny state is cheaper anyway.
        solver_mode = "replicated"
    unstab_grid = jnp.asarray(grid.vertex_grid(config, frame_height, frame_width))

    def step(frames_local, key):
        idx = jax.lax.axis_index(_AXIS)

        # --- halo: receive the next shard's first frame -----------------
        perm = [(i, (i - 1) % num_shards) for i in range(num_shards)]
        halo = jax.lax.ppermute(frames_local[:1], _AXIS, perm)
        frames_ext = jnp.concatenate([frames_local, halo], axis=0)

        gray8 = bgr_to_gray(frames_ext)
        keypoints = detect_all_frames(gray8, config, frame_height, frame_width)

        # --- local pair motion (B pairs; the global wrap pair is masked) --
        vel, homo, ok = pair_velocity_scan(
            keypoints, frames_ext, key, idx * block, config,
            frame_height, frame_width,
        )
        global_pair = idx * block + jnp.arange(block)
        valid = (global_pair < num_frames - 1)[:, None, None, None]
        vel = jnp.where(valid, vel, 0.0)
        homo = jnp.where(
            valid[:, :, 0, 0, None], homo, jnp.eye(3, dtype=jnp.float32)[None]
        )

        # --- distributed displacement prefix sum -------------------------
        local_cum = jnp.cumsum(vel, axis=0)  # (B, vr, vc, 2)
        totals = jax.lax.all_gather(local_cum[-1], _AXIS)  # (n, vr, vc, 2)
        shard_ids = jnp.arange(num_shards)
        prefix = jnp.sum(
            jnp.where((shard_ids < idx)[:, None, None, None], totals, 0.0), axis=0
        )
        disp_pairs_local = local_cum + prefix  # displacement of frames t+1

        # --- adaptive weights need every pair homography (tiny) ----------
        homos_full = jax.lax.all_gather(homo, _AXIS).reshape((num_frames, 3, 3))
        lambdas = adaptive_weights(
            homos_full, frame_width, frame_height, adaptive_weights_definition
        )

        if solver_mode == "halo":
            # Shift displacements one frame right across shards: this
            # shard's frame iB takes the left neighbor's last prefix (zero
            # on the first shard), frames iB+1.. take the local prefixes.
            send_right = [(i, (i + 1) % num_shards) for i in range(num_shards)]
            prev_tail = jax.lax.ppermute(
                disp_pairs_local[-1:], _AXIS, send_right
            )
            first = jnp.where(idx == 0, jnp.zeros_like(prev_tail), prev_tail)
            du_local = jnp.concatenate(
                [first, disp_pairs_local[:-1]], axis=0
            )
            ds_local = jacobi_smooth_sharded(
                du_local,
                lambdas,
                config.temporal_smoothing_radius,
                config.optimization_num_iterations,
                _AXIS,
                num_shards,
            )
            # stability's FFT is global over frames; gather the tiny result
            stab_full = jax.lax.all_gather(ds_local, _AXIS).reshape(
                (num_frames,) + ds_local.shape[1:]
            )
        else:
            # --- replicate the tiny temporal state for the solver --------
            disp_tail = jax.lax.all_gather(disp_pairs_local, _AXIS).reshape(
                (num_frames,) + disp_pairs_local.shape[1:]
            )
            disp_full = jnp.concatenate(
                [jnp.zeros_like(disp_tail[:1]), disp_tail[: num_frames - 1]],
                axis=0,
            )
            stab_full = jacobi_smooth(
                disp_full,
                lambdas,
                config.temporal_smoothing_radius,
                config.optimization_num_iterations,
            )
            du_local = jax.lax.dynamic_slice_in_dim(
                disp_full, idx * block, block
            )
            ds_local = jax.lax.dynamic_slice_in_dim(
                stab_full, idx * block, block
            )
        stabilized_local, crop_local = render_stabilized(
            frames_local, du_local, ds_local, unstab_grid, config,
            frame_height, frame_width,
        )
        crop = jnp.stack(
            [
                jax.lax.pmax(crop_local[0], _AXIS),
                jax.lax.pmax(crop_local[1], _AXIS),
                jax.lax.pmin(crop_local[2], _AXIS),
                jax.lax.pmin(crop_local[3], _AXIS),
            ]
        )
        cropped_local = crop_frames(stabilized_local, crop, frame_height, frame_width)

        # --- metrics ------------------------------------------------------
        # Serving mode (config is static, so this prunes the whole metric
        # tracker from the compiled program — see config.compute_metrics).
        if config.compute_metrics:
            ratios, distortions = cropping_and_distortion_scanned(
                jax.tree.map(lambda a: a[:block], keypoints),
                frames_local,
                cropped_local,
                jax.random.fold_in(key, 10_000),
                idx * block,
                config,
                frame_height,
                frame_width,
            )
            cropping_ratio = jax.lax.pmean(jnp.mean(ratios), _AXIS)
            distortion_score = jax.lax.pmin(jnp.min(distortions), _AXIS)
        else:
            cropping_ratio = jnp.asarray(float("nan"), jnp.float32)
            distortion_score = jnp.asarray(float("nan"), jnp.float32)

        # stability from the replicated solver output (identical everywhere)
        profiles = jnp.diff(stab_full, axis=0)
        energy = jnp.abs(jnp.fft.fft(profiles, axis=0)) ** 2
        total = jnp.sum(energy, axis=0)
        low = jnp.sum(energy[1:6], axis=0)
        score = jnp.where(total > 0, low / jnp.where(total > 0, total, 1.0), 0.0)
        stability = (jnp.mean(score[..., 0]) + jnp.mean(score[..., 1])) / 2.0

        return cropped_local, crop, cropping_ratio, distortion_score, stability

    shard = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(_AXIS), P()),
        out_specs=(P(_AXIS), P(), P(), P(), P()),
        check_vma=False,
    )
    return shard(frames, key)
