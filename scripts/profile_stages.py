#!/usr/bin/env python
"""Time the device stages that hand-written kernels could serve, and list
their top device operations from a jax.profiler trace.

    python scripts/profile_stages.py

Stages, on one 64-frame chunk of the seeded synthetic 1920x1080 clip (the
chip_smoke.py geometry; tracking runs at its 640x360 track geometry):

* motion LK      — the tile-pyramid LK tracker over all 63 pairs;
* motion scan    — the whole pass-1 pair scan (pyramids, LK, RANSAC,
                   propagation), for context;
* metric LK      — the metric tracker's LK, unstabilized -> cropped frames;
* metric scan    — the whole cropping/distortion pass, for context;
* backward map   — the per-pixel backward map at 1080p, mesh 16 and 64.

Each stage: compile time, then the median of 3 warm runs ending in
block_until_ready, then one traced run reduced to the top device
operations by summed duration.  Needs an accelerator; exits non-zero
without one.  Writes a JSON summary to bench_data/profile_stages.json.
"""

from __future__ import annotations

import collections
import functools
import glob
import json
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

FRAMES, HEIGHT, WIDTH = 64, 1080, 1920  # one chunk of the chip_smoke.py clip


def top_device_ops(trace_dir: str, top: int = 8):
    """[(name, total_ms, share)] of device events in a trace, plus the
    device busy ms (union of event intervals) and the window span ms."""
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True)
    totals: dict = collections.defaultdict(float)
    intervals = []
    for path in paths:
        for plane in ProfileData.from_file(path).planes:
            if not plane.name.startswith("/device:"):
                continue
            for line in plane.lines:
                for ev in line.events:
                    totals[ev.name] += ev.duration_ns
                    intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    span = (max(e for _, e in intervals) - min(s for s, _ in intervals)) if intervals else 0
    total = sum(totals.values()) or 1.0
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return (
        [(name, ns / 1e6, ns / total) for name, ns in ranked],
        busy / 1e6,
        span / 1e6,
    )


def measure(name, fn, args, trace_root, runs=3):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    trace_dir = os.path.join(trace_root, name.replace(" ", "_"))
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(fn(*args))
    ops, busy_ms, span_ms = top_device_ops(trace_dir)
    result = {
        "stage": name,
        "first_call_s": compile_s,
        "warm_s": statistics.median(times),
        "warm_runs_s": times,
        "traced_device_busy_ms": busy_ms,
        "traced_device_span_ms": span_ms,
        "top_device_ops": [
            {"name": n, "ms": ms, "share": share} for n, ms, share in ops
        ],
    }
    print(
        f"{name}: first call {compile_s:.3f}s, warm {result['warm_s']:.4f}s "
        f"(runs {', '.join(f'{t:.4f}' for t in times)}), traced device busy "
        f"{busy_ms:.3f} ms of {span_ms:.3f} ms"
    )
    for n, ms, share in ops:
        print(f"    {ms:10.3f} ms  {100 * share:5.1f}%  {n[:110]}")
    return result


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    device = jax.devices()[0]
    if device.platform == "cpu":
        print("profile_stages: no accelerator found", file=sys.stderr)
        return 2

    import meshflow  # noqa: F401
    from meshflow import devcheck
    from meshflow.config import MeshFlowConfig
    from meshflow.kernels.fast import Keypoints
    from meshflow.metrics.quality import cropping_and_distortion_scanned
    from meshflow.motion import trackscale
    from meshflow.motion.features import track_pair
    from meshflow.motion.pipeline import (
        packed_tile_pyramids,
        pair_velocity_scan,
        prepare_frames,
        unpack_level,
    )
    from meshflow.render.stabilize import backward_map, crop_frames
    from meshflow.synth import synthetic_clip
    from meshflow.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    h, w, f = HEIGHT, WIDTH, FRAMES
    config = MeshFlowConfig()
    th, tw = config.track_shape(h, w)
    clip = jnp.asarray(synthetic_clip(f, h, w, seed=0))
    crop = jnp.asarray([w // 16, h // 20, w - 1 - w // 12, h - 1 - h // 15], jnp.int32)
    cropped = crop_frames(clip, crop, h, w)
    track = trackscale.to_track_planes_dev(clip, config)
    track_cropped = trackscale.to_track_planes_dev(cropped, config)
    keypoints, _ = prepare_frames(track, config)
    jax.block_until_ready((track, track_cropped, keypoints))

    @functools.partial(jax.jit, static_argnames=("pairs",))
    def lk_tracks(kps, early, late, pairs):
        """LK from early[t] into late[t + pairs] for every t: pairs=1 is
        the motion tracker, pairs=0 the metric tracker."""
        max_level = config.lk_max_level(th, tw)
        pe = packed_tile_pyramids(early, config, max_level)
        pl = pe if pairs else packed_tile_pyramids(late, config, max_level)

        def body(carry, t):
            k = Keypoints(*(a[t] for a in kps))
            prev = tuple(unpack_level(p, t) for p in pe)
            nxt = tuple(unpack_level(p, t + pairs) for p in pl)
            return carry, track_pair(k, prev, nxt, config, th, tw)

        return jax.lax.scan(body, None, jnp.arange(early.shape[0] - pairs))[1]

    key = jax.random.PRNGKey(0)
    zero = jnp.asarray(0, jnp.int32)

    def bmap_scan(mesh):
        cfg = MeshFlowConfig(mesh_row_count=mesh, mesh_col_count=mesh)
        meshes = [devcheck.warped_mesh(cfg, h, w, seed=i) for i in range(f)]
        stab = jnp.asarray(np.stack([m[0] for m in meshes]))
        unstab = jnp.asarray(meshes[0][1])

        @jax.jit
        def run(stab, unstab):
            def body(carry, s):
                b = backward_map(s, unstab, cfg, h, w)
                return carry, (b.map_x.sum() + b.map_y.sum(), b.covered.sum())

            return jax.lax.scan(body, None, stab)[1]

        return run, (stab, unstab)

    results = []
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as traces:
        stages = [
            ("motion LK", lambda: (functools.partial(lk_tracks, pairs=1), (keypoints, track, track))),
            ("motion scan", lambda: (
                functools.partial(pair_velocity_scan, config=config, frame_height=th, frame_width=tw),
                (keypoints, track, key, zero),
            )),
            ("metric LK", lambda: (functools.partial(lk_tracks, pairs=0), (keypoints, track, track_cropped))),
            ("metric scan", lambda: (
                functools.partial(cropping_and_distortion_scanned, config=config, frame_height=th, frame_width=tw),
                (keypoints, track, track_cropped, key, zero),
            )),
            ("backward map mesh16", lambda: bmap_scan(16)),
            ("backward map mesh64", lambda: bmap_scan(64)),
        ]
        for name, make in stages:
            fn, fargs = make()
            results.append(measure(name, fn, fargs, traces))

    summary = {
        "device": {"platform": device.platform, "kind": device.device_kind},
        "frames": f,
        "frame": [h, w],
        "track": [th, tw],
        "stages": results,
    }
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "bench_data")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_stages.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
