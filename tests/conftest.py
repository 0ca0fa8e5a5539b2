"""Test configuration: force an 8-virtual-device CPU platform.

Multi-device sharding tests run against a virtual CPU mesh
(xla_force_host_platform_device_count=8) so the suite is hardware-independent.
Tests that need a GPU carry the `gpu` marker and skip here; chip_smoke.py
runs the same checks on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

from orbslam2commentedbyxcm_tpu.utils.runtime import configure_compile_cache  # noqa: E402

# Persistent XLA compilation cache: most of the suite's wall time is compiles,
# which are identical across runs.
configure_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: heavy end-to-end / fixture tests excluded from -m quick"
    )
    config.addinivalue_line(
        "markers", "quick: fast tier — auto-applied to every test not marked slow"
    )
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips elsewhere (chip_smoke.py covers it on the card)"
    )


def pytest_collection_modifyitems(config, items):
    for item in items:
        if "slow" not in item.keywords:
            item.add_marker(pytest.mark.quick)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs this check on the card")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
