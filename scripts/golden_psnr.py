#!/usr/bin/env python
"""Pixel-level parity vs the reference's golden stabilized videos.

The reference ships 28 golden outputs (videos/*/stabilized-method-*.m4v,
README.md:115-121) — the de-facto regression artifacts (SURVEY.md §4).
This compares our stabilized outputs frame by frame against them and
writes GOLDEN_PSNR.json: per config, mean and min per-frame PSNR.

Pixel parity decouples "do the videos match" from the noisy metric
estimator (the min-over-frames distortion score is seed-sensitive on
constant-high configs; the videos themselves are not).

Usage:
  python scripts/golden_psnr.py VIDEOS_DIR [--out-dir DIR]

VIDEOS_DIR is the reference's videos/ directory: <clip>/<clip>.m4v inputs
and <clip>/stabilized-method-<variant>.m4v golden outputs.  A configuration
whose output DIR/suite-<clip>-<variant>.m4v (DIR defaults to the temporary
directory) does not exist yet is stabilized first, so reruns compare only.
"""

import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(REPO, "GOLDEN_PSNR.json")
sys.path.insert(0, REPO)
CLIPS = ["video-1", "video-2", "video-3", "video-5", "video-8", "video-9", "video-10"]
VARIANTS = {"original": 0, "flipped": 1, "constant-high": 2, "constant-low": 3}


def read_video(path):
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(path)
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        yield frame
    cap.release()


def psnr_series(ours_path, golden_path):
    psnrs = []
    for ours, golden in zip(read_video(ours_path), read_video(golden_path)):
        if ours.shape != golden.shape:
            raise ValueError(f"shape mismatch {ours.shape} vs {golden.shape}")
        mse = np.mean(
            np.square(ours.astype(np.float32) - golden.astype(np.float32))
        )
        psnrs.append(
            99.0 if mse == 0 else float(10.0 * np.log10(255.0**2 / mse))
        )
    return psnrs


def main():
    videos = sys.argv[1]
    out_dir = tempfile.gettempdir()
    if "--out-dir" in sys.argv:
        out_dir = sys.argv[sys.argv.index("--out-dir") + 1]

    results = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            results = json.load(f)
    stabilizer = None
    for clip in CLIPS:
        for variant, method in VARIANTS.items():
            key = f"{clip}/{variant}"
            ours = os.path.join(out_dir, f"suite-{clip}-{variant}.m4v")
            golden = os.path.join(videos, clip, f"stabilized-method-{variant}.m4v")
            if not os.path.exists(ours):
                if stabilizer is None:
                    from meshflow import MeshFlowStabilizer
                    from meshflow.utils.compile_cache import configure_compile_cache

                    configure_compile_cache()
                    stabilizer = MeshFlowStabilizer()
                stabilizer.stabilize(
                    os.path.join(videos, clip, f"{clip}.m4v"), ours, method
                )
            series = psnr_series(ours, golden)
            entry = {
                "mean_psnr_db": round(float(np.mean(series)), 2),
                "min_psnr_db": round(float(np.min(series)), 2),
                "frames": len(series),
            }
            results[key] = entry
            print(f"{key}: mean {entry['mean_psnr_db']} dB  "
                  f"min {entry['min_psnr_db']} dB  ({entry['frames']} frames)",
                  flush=True)
            with open(OUT, "w") as f:
                json.dump(results, f, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
