"""Pixel-parity gate over the recorded golden-video comparison.

scripts/golden_psnr.py compares our stabilized outputs of the reference's
demo suite with the reference's own golden outputs and writes
GOLDEN_PSNR.json; this test holds each configuration to its frozen floor.
Skips when no results file exists.
"""

import json
import os

import pytest

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PSNR = os.path.join(os.path.dirname(__file__), "..", "GOLDEN_PSNR.json")


@pytest.mark.skipif(not os.path.exists(PSNR), reason="no GOLDEN_PSNR.json")
def test_golden_video_pixel_parity():
    """Pixel-level parity vs the reference's 28 golden stabilized videos
    (scripts/golden_psnr.py; /root/reference/videos/*/stabilized-method-*).

    Our stabilized outputs measure 27.7-40 dB mean PSNR against the
    reference's own outputs (median 36 dB) — different RANSAC draws and
    tracker convergence bound the agreement, heavy-crop constant-high
    configs the most.  Floors are frozen PER CONFIG at the round-3
    measured value minus 2 dB (tests/fixtures/golden_psnr_floors.json) so
    a regression in one config cannot hide under a global floor; configs
    without a frozen floor fall back to the 25/20 dB global floors (far
    above any real regression — a wrong crop rectangle, broken warp, or
    swapped variant lands under 15 dB)."""
    with open(PSNR) as f:
        results = json.load(f)
    floors_path = os.path.join(FIXTURES, "golden_psnr_floors.json")
    floors = {}
    if os.path.exists(floors_path):
        with open(floors_path) as f:
            floors = json.load(f)
    assert len(results) == 28, f"expected 28 configs, got {len(results)}"
    failures = []
    for key, entry in sorted(results.items()):
        floor = floors.get(key, {})
        mean_floor = floor.get("mean_floor_db", 25.0)
        min_floor = floor.get("min_floor_db", 20.0)
        if entry["mean_psnr_db"] < mean_floor:
            failures.append(
                f"{key}: mean {entry['mean_psnr_db']} dB < {mean_floor}"
            )
        if entry["min_psnr_db"] < min_floor:
            failures.append(
                f"{key}: min {entry['min_psnr_db']} dB < {min_floor}"
            )
    assert not failures, "\n".join(failures)

