"""chip_smoke.py and the card checks.

The rehearsal drives every phase of chip_smoke.py on the CPU at a tiny
size, bypassing only its GPU check: the same phase functions, the same
main-path code, a smaller clip and feature budget.  The `gpu`-marked tests
run the phase-1 kernel checks (meshflow/devcheck.py) at real widths; they
skip where there is no GPU, and chip_smoke.py runs the same checks on the
card.
"""

import os
import sys

import jax
import pytest

from meshflow import devcheck
from meshflow.config import MeshFlowConfig

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

SMALL = MeshFlowConfig(
    max_features_per_subframe=64,
    ransac_iterations=64,
    lk_max_iterations=10,
    optimization_num_iterations=20,
)


def test_chip_smoke_phases_rehearsal_on_cpu(tmp_path):
    cpu = jax.devices("cpu")
    label = "CPU rehearsal"
    results = chip_smoke.phase_kernels(cpu[0], lk=(72, 128), frame=(48, 64), meshes=(4,))
    assert all(r.ok for r in results) and len(results) == 4

    clip = str(tmp_path / "in.npy")
    shape = chip_smoke.make_clip(clip, 12, 72, 128)
    out, scores = chip_smoke.phase_main(str(tmp_path), clip, shape, label, config=SMALL)
    chip_smoke.phase_serve(str(tmp_path), clip, shape, out, scores, label, config=SMALL)
    chip_smoke.phase_render_routes(str(tmp_path), clip, shape, label, config=SMALL)
    chip_smoke.phase_online(8, 72, 128, label, config=SMALL, warmup=2)
    chip_smoke.phase_four_cards(cpu[:4], 16, 48, 64, label, config=SMALL)


@pytest.mark.gpu
def test_gpu_lk_tracker_matches_cpu(gpu):
    result = devcheck.check_lk(gpu)
    assert result.ok, result.line()


@pytest.mark.gpu
@pytest.mark.parametrize("mesh", [16, 64])
def test_gpu_backward_map_matches_cpu(gpu, mesh):
    result = devcheck.check_backward_map(gpu, mesh=mesh)
    assert result.ok, result.line()


@pytest.mark.gpu
def test_gpu_crop_stretch_matches_cpu(gpu):
    result = devcheck.check_crop_stretch(gpu)
    assert result.ok, result.line()


@pytest.mark.gpu
def test_gpu_fast_matches_cpu(gpu):
    result = devcheck.check_fast(gpu)
    assert result.ok, result.line()
