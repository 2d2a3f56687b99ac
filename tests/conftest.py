"""Test harness configuration.

Tests run on the CPU with 8 virtual devices, so
multi-device sharding paths are exercised without accelerators (SURVEY.md
section 4: shard-count invariance is the fake-backend analog for this
framework).  The env vars must be set before jax initializes its backends,
hence module scope here.
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# CPU unless the caller says otherwise: `JAX_PLATFORMS=cuda,cpu python -m
# pytest -m gpu tests/` runs the card checks on a GPU host.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

from meshflow.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none.  Decided
    here, at run time, never at import: every xdist worker must collect
    the same tests."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip(
            "needs a GPU: run `python chip_smoke.py`, or "
            "`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`, on the card"
        )
    return devices[0]
