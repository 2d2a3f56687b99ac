"""Multi-clip batch parallelism (SURVEY.md §2.3, axis 6).

Independent clips are embarrassingly parallel: nothing couples them, so
the right multi-device strategy is to fan whole clips out across devices
rather than shard one clip's frames.  Each worker thread pins one device
with jax.default_device (JAX's per-thread config) and drives the standard
stabilize pipeline; device compute for different clips overlaps across
chips while host decode/warp/encode threads interleave on the host cores.

The reference has no batch mode at all — its main() runs one hardcoded
clip (/root/reference/meshflowstabilizer.py:1325-1336).  On a single
device this degrades to one worker (still overlapping one clip's host and
device work with another's through JAX's async dispatch is handled inside
the streaming pipeline itself).

CLI: python -m meshflow.parallel.batch manifest.json
  manifest: [{"input": ..., "output": ..., "variant": "original"}, ...]
"""

from __future__ import annotations

import concurrent.futures
import queue
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import jax

from meshflow import config as cfg
from meshflow.config import MeshFlowConfig


@dataclass(frozen=True)
class BatchJob:
    input_path: str
    output_path: str
    adaptive_weights_definition: int = cfg.ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL


def stabilize_batch(
    jobs: Sequence[BatchJob],
    config: Optional[MeshFlowConfig] = None,
    devices: Optional[Sequence] = None,
    seed: int = 0,
) -> Tuple[Tuple[float, float, float], ...]:
    """Stabilize independent clips concurrently across devices.

    Returns the per-job metric tuples in job order.  Each job produces
    the same result as a solo MeshFlowStabilizer(seed=seed).stabilize()
    call (workers get their own stabilizer instances; RANSAC seeds are
    per-clip, not per-worker).
    """
    from meshflow.api import MeshFlowStabilizer

    devices = list(devices if devices is not None else jax.local_devices())
    num_workers = max(1, min(len(devices), len(jobs)))
    device_pool: "queue.Queue" = queue.Queue()
    for d in devices[:num_workers]:
        device_pool.put(d)

    def run(job: BatchJob):
        device = device_pool.get()
        try:
            with jax.default_device(device):
                stabilizer = MeshFlowStabilizer(config=config, seed=seed)
                return stabilizer.stabilize(
                    job.input_path,
                    job.output_path,
                    job.adaptive_weights_definition,
                )
        finally:
            device_pool.put(device)

    if num_workers == 1:
        return tuple(run(job) for job in jobs)
    with concurrent.futures.ThreadPoolExecutor(num_workers) as pool:
        return tuple(pool.map(run, jobs))


def main(argv=None):
    import argparse
    import json

    p = argparse.ArgumentParser(
        prog="meshflow-batch",
        description="Stabilize a manifest of clips across local devices",
    )
    p.add_argument("manifest", help="JSON list of {input, output, variant}")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    variants = {
        "original": cfg.ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL,
        "flipped": cfg.ADAPTIVE_WEIGHTS_DEFINITION_FLIPPED,
        "constant-high": cfg.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH,
        "constant-low": cfg.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW,
    }
    with open(args.manifest) as f:
        spec = json.load(f)
    jobs = [
        BatchJob(
            input_path=item["input"],
            output_path=item["output"],
            adaptive_weights_definition=variants[item.get("variant", "original")],
        )
        for item in spec
    ]
    results = stabilize_batch(jobs, seed=args.seed)
    for job, (cr, ds, ss) in zip(jobs, results):
        print(
            json.dumps(
                {
                    "input": job.input_path,
                    "output": job.output_path,
                    "cropping_ratio": cr,
                    "distortion_score": ds,
                    "stability_score": ss,
                }
            )
        )


if __name__ == "__main__":
    main()
