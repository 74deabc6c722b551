"""Test harness: the tests run on the CPU backend with a virtual 8-device
mesh, so sharding paths compile and execute without accelerators, and with
x64 enabled (the reference math is f64).

Tests marked ``gpu`` need an NVIDIA GPU; they skip here (the ``gpu_device``
fixture decides) and run on the card under ``python chip_smoke.py``, which
sets LONGCALLR_TEST_GPU=1 to leave the platform choice to JAX.
"""

import os

_ON_GPU = os.environ.get("LONGCALLR_TEST_GPU") == "1"
if not _ON_GPU:
    # hard-set: an ambient JAX_PLATFORMS must never pick the unit tests'
    # backend
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_ENABLE_X64"] = "1"

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

DEMO_BAM = "/root/reference/demo/demo.bam"


@pytest.fixture(scope="session")
def demo_bam_path():
    if not os.path.exists(DEMO_BAM):
        pytest.skip("demo.bam not available")
    return DEMO_BAM


@pytest.fixture()
def rng(request):
    # deterministic per test and independent of execution order
    import zlib
    seed = zlib.crc32(request.node.nodeid.encode()) & 0x7FFFFFFF
    return np.random.default_rng([2025, seed])


@pytest.fixture()
def gpu_device():
    """The first GPU, or a skip: decided here, when the test runs."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (python chip_smoke.py runs the "
                    "gpu-marked tests on the card)")
