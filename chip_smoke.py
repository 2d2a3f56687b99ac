#!/usr/bin/env python
"""Start the stabilizer on one GPU and check it end to end.

    python chip_smoke.py               # phases 1-5 on one card
    python chip_smoke.py --four-cards  # phase 6 only, on four cards

Phases (one process; nothing else may hold the card meanwhile):

1. kernels: each device stage against the same jitted function on the CPU
   at real widths (meshflow/devcheck.py): LK tracker, backward map at two
   mesh densities, crop+stretch, FAST;
2. main path, eval mode: a seeded synthetic 1920x1080 clip (raw .npy
   container) through MeshFlowStabilizer().stabilize twice, cold then
   warm, and once through the CLI's main();
3. serve mode (compute_metrics=False): output bit-identical to phase 2's;
4. render routes: device warp and native host warp, in-memory;
5. online: OnlineMeshFlowStabilizer on a seeded 640x360 stream;
6. (--four-cards) parallel.pipeline.stabilize_sharded on a 4-device mesh
   against a 1-device mesh.

Timings printed here are smoke timings of one run, not benchmark numbers.
The last line is one JSON object: {"ok": ..., "device": {...}}.  Without a
GPU the script exits non-zero before any phase and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# Phases 2-4 clip: 1080p, 150 frames at 30 fps (three 64-frame chunks).
# Cut frames, never width, and no lower than 65 (two chunks), if time forces.
FRAMES, HEIGHT, WIDTH = 150, 1080, 1920


def gpus_or_exit(count: int):
    """The first `count` GPU devices; exits non-zero without them."""
    import jax

    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if len(devices) < count:
        print(
            f"chip_smoke: needs {count} GPU(s), JAX found {len(devices)} "
            f"(backend {jax.default_backend()})",
            file=sys.stderr,
        )
        sys.exit(2)
    return devices[:count]


def card_line() -> str:
    """nvidia-smi's name and power limit, one line per card."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def print_environment(cache_dir: str) -> None:
    import jax
    import jaxlib

    from meshflow.io import native as native_io
    from meshflow.render import host as host_render
    from meshflow.utils import native_build

    print(f"card: {card_line()}")  # one line per card
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"compile cache: {cache_dir}")
    try:
        import cv2

        cv2_state = f"cv2 {cv2.__version__}"
    except ImportError:
        cv2_state = "cv2 absent"
    warp = (
        "built" if host_render.available()
        else f"not available ({native_build.error('warp')})"
    )
    print(
        f"backends: raw .npy always; native videoio (libav) "
        f"{native_io.unavailable_reason()}; native warp {warp}; {cv2_state}"
    )


@contextlib.contextmanager
def env(**values):
    """Temporarily set environment variables (the render-route selectors)."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _buckets(timer) -> str:
    return ", ".join(f"{name} {secs:.3f}s" for name, secs in timer.stages)


def _check_output(path: str, shape) -> np.ndarray:
    from meshflow.io.video import open_raw

    out = open_raw(path)
    if out.shape != tuple(shape):
        raise AssertionError(f"output {path} has shape {out.shape}, want {tuple(shape)}")
    return out


def _check_scores(scores, eval_mode: bool = True) -> None:
    ratio, distortion, stability = scores
    if not (np.isfinite(stability) and 0.0 < stability <= 1.2):
        raise AssertionError(f"stability score {stability} not in (0, 1.2]")
    if eval_mode and not all(
        np.isfinite(v) and 0.0 <= v <= 1.2 for v in (ratio, distortion)
    ):
        raise AssertionError(f"scores {scores} not finite in [0, 1.2]")


def make_clip(path: str, num_frames: int, height: int, width: int, seed: int = 0):
    from meshflow.synth import synthetic_clip

    clip = synthetic_clip(num_frames, height, width, seed)
    np.save(path, clip)
    return clip.shape


# ---------------------------------------------------------------- phases
def phase_kernels(device, lk=(360, 640), frame=(1080, 1920), meshes=(16, 64)):
    """Phase 1: every kernel check; raises if any is outside tolerance."""
    from meshflow import devcheck

    results = devcheck.run_all(device, lk=lk, frame=frame, meshes=meshes)
    for r in results:
        print(f"  {r.line()}")
    failed = [r.name for r in results if not r.ok]
    if failed:
        raise AssertionError(f"outside tolerance: {failed}")
    return results


def phase_main(workdir: str, clip_path: str, shape, label: str, config=None):
    """Phase 2: eval-mode stabilize (cold, warm) + the CLI; returns the
    warm output's path and scores."""
    from meshflow import cli
    from meshflow.api import MeshFlowStabilizer

    stab = MeshFlowStabilizer(config=config)
    out = None
    for run in ("cold", "warm"):
        out = os.path.join(workdir, f"out_{run}.npy")
        t0 = time.perf_counter()
        scores = stab.stabilize(clip_path, out, 0)
        secs = time.perf_counter() - t0
        _check_output(out, shape)
        _check_scores(scores)
        print(
            f"  {run}: {secs:.3f}s, {shape[0] / secs:.3f} fps ({label}); "
            f"scores {tuple(round(s, 6) for s in scores)}"
        )
        print(f"    buckets: {_buckets(stab.last_timer)}")
    if config is None:  # the CLI builds its own default configuration
        cli_out = os.path.join(workdir, "out_cli.npy")
        t0 = time.perf_counter()
        rc = cli.main([clip_path, cli_out, "--json"])
        if rc != 0:
            raise AssertionError(f"cli.main returned {rc}")
        _check_output(cli_out, shape)
        os.unlink(cli_out)
        print(f"  cli: {time.perf_counter() - t0:.3f}s ({label})")
    return out, scores


def phase_serve(
    workdir: str, clip_path: str, shape, eval_output: str, eval_scores,
    label: str, config=None,
):
    """Phase 3: serve mode; output must equal eval mode's bit for bit."""
    import dataclasses

    from meshflow.api import MeshFlowStabilizer
    from meshflow.config import MeshFlowConfig

    config = dataclasses.replace(config or MeshFlowConfig(), compute_metrics=False)
    stab = MeshFlowStabilizer(config=config)
    out = os.path.join(workdir, "out_serve.npy")
    t0 = time.perf_counter()
    scores = stab.stabilize(clip_path, out, 0)
    secs = time.perf_counter() - t0
    _check_scores(scores, eval_mode=False)
    if scores[2] != eval_scores[2]:
        raise AssertionError(f"serve stability {scores[2]} != eval {eval_scores[2]}")
    if not np.array_equal(_check_output(out, shape), np.load(eval_output, mmap_mode="r")):
        raise AssertionError("serve-mode output differs from eval mode")
    os.unlink(out)
    print(f"  serve: {secs:.3f}s, {shape[0] / secs:.3f} fps ({label}); bit-identical to eval")
    print(f"    buckets: {_buckets(stab.last_timer)}")


def phase_render_routes(workdir: str, clip_path: str, shape, label: str, config=None):
    """Phase 4: the in-memory pipeline on each render route, one run each
    (compilation of the route's shapes included)."""
    from meshflow.api import MeshFlowStabilizer
    from meshflow.render import host as host_render

    routes = ["device"] + (["host"] if host_render.available() else [])
    default = "host (streaming)" if host_render.available() else "device"
    print(
        f"  default route here: {default} — MESHFLOW_RENDER=auto takes the native "
        "host warp whenever it builds on this host"
    )
    for route in routes:
        stab = MeshFlowStabilizer(config=config)
        out = os.path.join(workdir, f"out_{route}.npy")
        with env(MESHFLOW_STREAM="0", MESHFLOW_RENDER=route):
            t0 = time.perf_counter()
            scores = stab.stabilize(clip_path, out, 0)
            secs = time.perf_counter() - t0
        _check_output(out, shape)
        _check_scores(scores)
        os.unlink(out)
        print(f"  {route} render (first run): {secs:.3f}s, {shape[0] / secs:.3f} fps ({label})")
        print(f"    buckets: {_buckets(stab.last_timer)}")


def phase_online(num_frames: int, height: int, width: int, label: str, config=None, warmup: int = 5):
    """Phase 5: the online stabilizer, frame by frame."""
    from meshflow.online import OnlineMeshFlowStabilizer
    from meshflow.synth import synthetic_clip

    frames = synthetic_clip(num_frames, height, width, seed=1)
    online = OnlineMeshFlowStabilizer(config=config)
    ms = []
    for frame in frames:
        t0 = time.perf_counter()
        out = online.process(frame)
        ms.append(1e3 * (time.perf_counter() - t0))
        if out.shape != frame.shape or out.dtype != np.uint8:
            raise AssertionError(f"online output {out.shape} {out.dtype}")
    steady = np.asarray(ms[warmup:])
    print(
        f"  online {width}x{height}: first frame {ms[0]:.3f} ms, compile+second "
        f"{ms[1]:.3f} ms, steady p50 {np.percentile(steady, 50):.3f} ms, "
        f"p90 {np.percentile(steady, 90):.3f} ms over {steady.size} frames ({label})"
    )


def phase_four_cards(devices, num_frames: int, height: int, width: int, label: str, config=None):
    """Phase 6: the frame-sharded step on len(devices) devices against one,
    one run each (compilation included)."""
    import jax

    from meshflow.config import MeshFlowConfig
    from meshflow.parallel.pipeline import frame_sharding, make_mesh, stabilize_sharded
    from meshflow.synth import synthetic_clip

    config = config or MeshFlowConfig()
    clip = synthetic_clip(num_frames, height, width, seed=2)
    key = jax.random.PRNGKey(0)
    results = {}
    for n in (len(devices), 1):
        mesh = make_mesh(devices[:n])
        frames = jax.device_put(clip, frame_sharding(mesh))
        t0 = time.perf_counter()
        out = jax.block_until_ready(
            stabilize_sharded(frames, key, config, height, width, mesh)
        )
        print(f"  {n} device(s), first run: {time.perf_counter() - t0:.3f}s ({label})")
        cropped, crop, ratio, distortion, stability = out
        if cropped.shape != clip.shape:
            raise AssertionError(f"sharded output {cropped.shape}")
        results[n] = (np.asarray(crop), np.asarray([ratio, distortion, stability], np.float64))
    (crop_n, m_n), (crop_1, m_1) = results[len(devices)], results[1]
    rel = np.abs(m_n - m_1) / np.maximum(np.abs(m_1), 1e-30)
    print(
        f"  crop {crop_n.tolist()} vs {crop_1.tolist()}; metrics {m_n.tolist()} vs "
        f"{m_1.tolist()}; max rel diff {rel.max():.3g} (tolerance 1e-5)"
    )
    if not np.array_equal(crop_n, crop_1) or not np.all(np.isfinite(m_n)) or rel.max() > 1e-5:
        raise AssertionError("sharded result differs from the 1-device mesh")


# ------------------------------------------------------------------ main
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the 4-card sharded path (phase 6) and its 1-card comparison",
    )
    args = parser.parse_args(argv)
    devices = gpus_or_exit(4 if args.four_cards else 1)

    import jax

    import meshflow  # noqa: F401  (matmul precision)
    from meshflow.utils.compile_cache import configure_compile_cache

    print_environment(configure_compile_cache())
    dev = devices[0]
    label = f"smoke, not benchmark: {card_line().splitlines()[0]}"
    failed = []

    def phase(name, fn, *a, **k):
        print(f"phase {name}")
        t0 = time.perf_counter()
        try:
            result = fn(*a, **k)
        except Exception:  # every phase runs; any failure fails the script
            traceback.print_exc(file=sys.stdout)
            failed.append(name)
            result = None
        print(f"phase {name}: {'FAILED' if name in failed else 'ok'} in {time.perf_counter() - t0:.1f}s")
        return result

    workdir = os.path.join(HERE, ".smoke")  # clips and outputs, removed at exit
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        if args.four_cards:
            phase("6 four cards", phase_four_cards, devices, 64, HEIGHT, WIDTH, label)
        else:
            phase("1 kernels", phase_kernels, dev)
            clip = os.path.join(workdir, "in.npy")
            shape = make_clip(clip, FRAMES, HEIGHT, WIDTH)
            main_out = phase("2 main path", phase_main, workdir, clip, shape, label)
            if main_out is None:
                failed.append("3 serve (needs phase 2)")
            else:
                phase("3 serve", phase_serve, workdir, clip, shape, *main_out, label)
            phase("4 render routes", phase_render_routes, workdir, clip, shape, label)
            phase("5 online", phase_online, 120, 360, 640, label)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    result = {
        "ok": not failed,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(devices),
        },
    }
    if failed:
        print(f"failed phases: {failed}")
        result["failed"] = failed
    print(json.dumps(result))
    return 0 if not failed else 1


if __name__ == "__main__":
    sys.exit(main())
