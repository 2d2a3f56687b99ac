#!/usr/bin/env python
"""End-to-end stabilization throughput on the accelerator.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "fps", "vs_baseline": null, "detail": {...}}

Input: a seeded synthetic 640x360 clip of 494 frames (meshflow/synth.py) in
the raw .npy container, the geometry and length of the reference's demo
clip video-1.  The run needs an accelerator: without one it exits non-zero.
The reference publishes no speed of its own (BASELINE.md), so vs_baseline
is null.  The benchmark's cells are defined in BENCHMARK.json's workloads
once they exist; this script is the single 640x360 eval/serve measurement.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

NUM_FRAMES, HEIGHT, WIDTH = 494, 360, 640


def main():
    import jax

    device = jax.devices()[0]
    if device.platform == "cpu":
        print("bench.py: no accelerator found; refusing to time the CPU", file=sys.stderr)
        return 2

    import numpy as np

    import meshflow  # noqa: F401
    from meshflow.api import MeshFlowStabilizer
    from meshflow.synth import synthetic_clip
    from meshflow.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        clip = os.path.join(tmp, "in.npy")
        out = os.path.join(tmp, "out.npy")
        np.save(clip, synthetic_clip(NUM_FRAMES, HEIGHT, WIDTH, seed=0))

        # Cold pass carries compilation; the last warm pass is the steady
        # state a long-lived service sees.
        stabilizer = MeshFlowStabilizer()
        t0 = time.perf_counter()
        stabilizer.stabilize(clip, out, 0)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        metrics = stabilizer.stabilize(clip, out, 0)
        warm = time.perf_counter() - t0

        # Serving mode: same output video, no evaluation pass.
        serve = MeshFlowStabilizer(compute_metrics=False)
        serve.stabilize(clip, out, 0)  # compiles the serving configuration
        t0 = time.perf_counter()
        serve.stabilize(clip, out, 0)
        serve_warm = time.perf_counter() - t0

    print(
        json.dumps(
            {
                "metric": f"synthetic {WIDTH}x{HEIGHT}x{NUM_FRAMES} end-to-end stabilize throughput",
                "value": NUM_FRAMES / warm,
                "unit": "fps",
                "vs_baseline": None,
                "detail": {
                    "platform": device.platform,
                    "device_kind": device.device_kind,
                    "device_count": len(jax.devices()),
                    "xla_flags": os.environ.get("XLA_FLAGS", ""),
                    "warm_seconds": warm,
                    "cold_seconds": cold,
                    "serve_warm_seconds": serve_warm,
                    "serve_fps": NUM_FRAMES / serve_warm,
                    "metrics": {
                        "cropping_ratio": metrics[0],
                        "distortion_score": metrics[1],
                        "stability_score": metrics[2],
                    },
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
