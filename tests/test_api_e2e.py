"""End-to-end API tests on short synthetic clips, plus metric oracles."""

import importlib
import os
import pathlib
import subprocess
import sys

import cv2
import numpy as np
import jax.numpy as jnp
import pytest

from meshflow import MeshFlowStabilizer
from meshflow.metrics.quality import stability_score


def _write_clip(path, rng, num_frames=8, h=180, w=320, max_shift=10):
    canvas = rng.integers(0, 256, size=((h + 4 * max_shift) // 6, (w + 4 * max_shift) // 6), dtype=np.uint8)
    canvas = cv2.resize(canvas, (w + 4 * max_shift, h + 4 * max_shift), interpolation=cv2.INTER_NEAREST)
    canvas = cv2.GaussianBlur(canvas, (5, 5), 1.0)
    canvas = cv2.cvtColor(canvas, cv2.COLOR_GRAY2BGR)
    shifts = [np.array([0, 0])]
    for _ in range(num_frames - 1):
        shifts.append(np.clip(shifts[-1] + rng.integers(-3, 4, size=2), -max_shift, max_shift))
    writer = cv2.VideoWriter(
        str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (w, h)
    )
    for s in shifts:
        y0, x0 = 2 * max_shift + s[1], 2 * max_shift + s[0]
        writer.write(canvas[y0 : y0 + h, x0 : x0 + w])
    writer.release()


def test_stability_score_matches_numpy_oracle(rng):
    disp = rng.normal(size=(40, 17, 17, 2)).astype(np.float32)
    ours = float(stability_score(jnp.asarray(disp)))
    # Oracle: the reference's formula (/root/reference/meshflowstabilizer.py:1240-1259)
    x = np.moveaxis(disp[..., 0], 0, 2)
    y = np.moveaxis(disp[..., 1], 0, 2)
    sx = np.square(np.abs(np.fft.fft(np.diff(x))))
    sy = np.square(np.abs(np.fft.fft(np.diff(y))))
    ref = (
        np.mean(sx[:, :, 1:6].sum(2) / sx.sum(2))
        + np.mean(sy[:, :, 1:6].sum(2) / sy.sum(2))
    ) / 2
    np.testing.assert_allclose(ours, ref, rtol=1e-4)


def test_invalid_variant_raises():
    m = MeshFlowStabilizer()
    with pytest.raises(ValueError, match="adaptive_weights_definition"):
        m.stabilize("/nonexistent.mp4", "/tmp/out.mp4", adaptive_weights_definition=9)


def test_missing_file_raises_ioerror():
    m = MeshFlowStabilizer()
    with pytest.raises(IOError):
        m.stabilize("/nonexistent-clip.mp4", "/tmp/out.mp4")


@pytest.mark.slow
def test_stabilize_end_to_end(tmp_path, rng):
    inp = tmp_path / "in.mp4"
    out = tmp_path / "out.mp4"
    _write_clip(inp, rng)

    m = MeshFlowStabilizer()
    cropping_ratio, distortion_score, stability = m.stabilize(
        str(inp), str(out), MeshFlowStabilizer.ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL
    )

    assert np.isfinite([cropping_ratio, distortion_score, stability]).all()
    assert 0.2 < cropping_ratio <= 1.5
    assert 0.0 < distortion_score <= 1.01
    assert 0.0 <= stability <= 1.0

    cap = cv2.VideoCapture(str(out))
    assert cap.isOpened()
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 8
    assert abs(cap.get(cv2.CAP_PROP_FPS) - 30.0) < 0.1
    ok, frame = cap.read()
    cap.release()
    assert ok and frame.shape == (180, 320, 3)
    # Border color must have been cropped away: no saturated-red pixels.
    b, g, r = frame[..., 0].astype(int), frame[..., 1].astype(int), frame[..., 2].astype(int)
    red_fraction = ((r > 200) & (g < 40) & (b < 40)).mean()
    assert red_fraction < 0.01


@pytest.mark.slow
def test_threaded_host_pipeline_matches_serial(tmp_path, rng, monkeypatch):
    """The 3-stage threaded host pipeline (decode | warp | encode) must be
    byte-identical to the serial producer: same encoded video, same
    metrics.  Force each (auto picks by core count)."""
    inp = tmp_path / "in.mp4"
    _write_clip(inp, rng)  # 8 frames: same shapes as the e2e test above
    outs, metrics = [], []
    for mode in ("serial", "threaded"):
        out = tmp_path / f"out-{mode}.mp4"
        monkeypatch.setenv("MESHFLOW_HOST_PIPELINE", mode)
        m = MeshFlowStabilizer()
        metrics.append(m.stabilize(str(inp), str(out), 0))
        with open(out, "rb") as f:
            outs.append(f.read())
    assert metrics[0] == metrics[1]
    assert outs[0] == outs[1]


def test_threaded_pipeline_error_propagates(tmp_path, rng, monkeypatch):
    """A stage error in the threaded producer must surface as the original
    exception, not deadlock: the stage's cancel.set() used to swallow its
    own finally-sentinel, leaving the consumer blocked on work.get()
    forever (round-4 advisor finding, streaming._sentinel)."""
    import threading

    from meshflow import streaming

    inp = tmp_path / "in.mp4"
    _write_clip(inp, rng)  # same shapes as the e2e tests: cached compiles
    monkeypatch.setenv("MESHFLOW_HOST_PIPELINE", "threaded")

    def boom(self, frames):
        raise IOError("synthetic encoder failure")

    monkeypatch.setattr(streaming.StreamWriter, "write", boom)
    result = {}

    def run():
        try:
            MeshFlowStabilizer().stabilize(
                str(inp), str(tmp_path / "out.mp4"), 0
            )
            result["exc"] = None
        except BaseException as e:
            result["exc"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout=300)
    assert not th.is_alive(), "threaded pipeline deadlocked on stage error"
    assert isinstance(result["exc"], IOError)


# The package and its former import name, kept for existing users.
IMPORT_NAMES = sorted(
    p.parent.name
    for p in pathlib.Path(__file__).resolve().parents[1].glob("meshflow*/__init__.py")
)


@pytest.mark.parametrize("name", IMPORT_NAMES)
def test_import_names_resolve_to_one_package(name):
    """Each import name gives the same stabilizer and a CLI module with
    main() (so `python -m <name>.cli` runs)."""
    assert len(IMPORT_NAMES) == 2, IMPORT_NAMES
    assert importlib.import_module(name).MeshFlowStabilizer is MeshFlowStabilizer
    assert callable(importlib.import_module(f"{name}.cli").main)


@pytest.mark.slow
def test_cli_end_to_end(tmp_path, rng):
    inp = tmp_path / "in.mp4"
    out = tmp_path / "out.mp4"
    _write_clip(inp, rng, num_frames=6)
    proc = subprocess.run(
        [
            sys.executable, "-m", "meshflow.cli",
            str(inp), str(out), "--variant", "constant-low", "--json",
        ],
        capture_output=True,
        text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env={
            **os.environ,
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        },
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    import json

    line = proc.stdout.strip().splitlines()[-1]
    metrics = json.loads(line)
    assert set(metrics) >= {"cropping_ratio", "distortion_score", "stability_score"}
    assert out.exists()


@pytest.mark.slow
def test_streamed_matches_in_memory(tmp_path, rng, monkeypatch):
    """The two-pass streaming pipeline is bit-identical to the in-memory
    host-render path: same metric tuple, same output pixels (multi-window
    clip exercises the stride-(chunk-1) halo logic with CHUNK=16).

    Reduced feature/iteration budget: the invariant is path identity, not
    tracking quality, and the default config's XLA LK path costs tens of
    minutes on this host's single core."""
    from meshflow import MeshFlowConfig
    from meshflow.render import host as host_render

    if not host_render.available():
        pytest.skip("native streaming renderer not built")
    clip = tmp_path / "in.avi"
    _write_clip(clip, rng, num_frames=40, h=120, w=160)
    config = MeshFlowConfig(
        max_features_per_subframe=64,
        ransac_iterations=64,
        lk_max_iterations=10,
        optimization_num_iterations=20,
    )

    results, outs = {}, {}
    # "1" streams with the pass-1 decoded-frame cache (default);
    # "1-nocache" forces pass 2's re-decode path.
    for mode in ("0", "1", "1-nocache"):
        monkeypatch.setenv("MESHFLOW_STREAM", mode[0])
        monkeypatch.setenv("MESHFLOW_RENDER", "host")
        monkeypatch.setenv(
            "MESHFLOW_HOST_FRAME_CACHE_GB",
            "0" if mode.endswith("nocache") else "8",
        )
        m = MeshFlowStabilizer(config=config)
        m.CHUNK = 16
        out = tmp_path / f"out_{mode}.avi"
        results[mode] = m.stabilize(str(clip), str(out), 0)
        cap = cv2.VideoCapture(str(out))
        frames = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f)
        cap.release()
        outs[mode] = np.stack(frames)

    assert results["0"] == results["1"] == results["1-nocache"]
    np.testing.assert_array_equal(outs["0"], outs["1"])
    np.testing.assert_array_equal(outs["1"], outs["1-nocache"])


@pytest.mark.slow
def test_checkpoint_resume_identical(tmp_path, rng, monkeypatch):
    """A checkpointed rerun (same clip/config, any variant) resumes at the
    solver and produces identical metrics + output to the fresh run."""
    from meshflow.render import host as host_render

    if not host_render.available():
        pytest.skip("native streaming renderer not built")
    from meshflow import MeshFlowConfig

    clip = tmp_path / "in.avi"
    _write_clip(clip, rng, num_frames=24, h=120, w=160)
    monkeypatch.setenv("MESHFLOW_STREAM", "1")
    ckpt_dir = tmp_path / "ckpt"
    config = MeshFlowConfig(
        max_features_per_subframe=64,
        ransac_iterations=64,
        lk_max_iterations=10,
        optimization_num_iterations=20,
    )

    m = MeshFlowStabilizer(config=config, checkpoint_dir=str(ckpt_dir))
    fresh = m.stabilize(str(clip), str(tmp_path / "out1.avi"), 0)
    ckpts = list(ckpt_dir.glob("motion-*.npz"))
    assert len(ckpts) == 1

    # resumed run: sabotage pass 1 by making the scan unreachable
    import meshflow.streaming as streaming_mod

    def boom(*a, **k):
        raise AssertionError("pass 1 ran despite checkpoint")

    monkeypatch.setattr(streaming_mod, "pair_velocity_scan", boom)
    m2 = MeshFlowStabilizer(config=config, checkpoint_dir=str(ckpt_dir))
    resumed = m2.stabilize(str(clip), str(tmp_path / "out2.avi"), 0)
    assert fresh == resumed

    # other variants reuse the same motion checkpoint
    m3 = MeshFlowStabilizer(config=config, checkpoint_dir=str(ckpt_dir))
    m3.stabilize(str(clip), str(tmp_path / "out3.avi"), 2)
    assert len(list(ckpt_dir.glob("motion-*.npz"))) == 1

    out1 = cv2.VideoCapture(str(tmp_path / "out1.avi"))
    out2 = cv2.VideoCapture(str(tmp_path / "out2.avi"))
    while True:
        ok1, f1 = out1.read()
        ok2, f2 = out2.read()
        assert ok1 == ok2
        if not ok1:
            break
        np.testing.assert_array_equal(f1, f2)


def test_serving_mode_skips_metrics(tmp_path, rng):
    """compute_metrics=False (serving mode) must keep the output video
    byte-identical and the stability score unchanged, while skipping the
    cropping/distortion evaluation pass (returned as NaN).  The metric
    pass is a second full tracker pass per frame, and the reference
    computes it unconditionally inside stabilize()
    (/root/reference/meshflowstabilizer.py:1160-1212)."""
    inp = tmp_path / "in.mp4"
    _write_clip(inp, rng)  # 8 frames: same shapes as the e2e test above

    out_eval = tmp_path / "out-eval.mp4"
    ratio, distortion, stability = MeshFlowStabilizer().stabilize(
        str(inp), str(out_eval), 0
    )

    out_serve = tmp_path / "out-serve.mp4"
    ratio_s, distortion_s, stability_s = MeshFlowStabilizer(
        compute_metrics=False
    ).stabilize(str(inp), str(out_serve), 0)

    assert np.isnan(ratio_s) and np.isnan(distortion_s)
    assert np.isfinite([ratio, distortion, stability]).all()
    assert stability_s == stability
    with open(out_eval, "rb") as f1, open(out_serve, "rb") as f2:
        assert f1.read() == f2.read()


def test_serving_mode_env_and_cli_flag(tmp_path, rng, monkeypatch):
    """MESHFLOW_COMPUTE_METRICS=0 and the CLI --no-metrics flag both route
    to the serving mode; an explicit constructor True wins over the env."""
    monkeypatch.setenv("MESHFLOW_COMPUTE_METRICS", "0")
    assert MeshFlowStabilizer().config.compute_metrics is False
    assert MeshFlowStabilizer(compute_metrics=True).config.compute_metrics
    monkeypatch.delenv("MESHFLOW_COMPUTE_METRICS")

    from meshflow.cli import build_parser

    inp, out = str(tmp_path / "i.mp4"), str(tmp_path / "o.mp4")
    args = build_parser().parse_args([inp, out, "--no-metrics"])
    assert args.no_metrics
    args = build_parser().parse_args([inp, out])
    assert not args.no_metrics
