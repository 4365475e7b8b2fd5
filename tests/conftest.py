"""Test configuration: run everything on a virtual 8-device CPU mesh.

The reference's tests are CPU-feature-aware so SIMD variants are skipped on
machines lacking them (tests/TestSuite.hs:52-53).  Our analog: tests run on
the CPU backend with 8 virtual devices so the *sharded* code paths run
everywhere, and Pallas kernels run in interpret mode.  Tests marked ``gpu``
compile the kernels for the card: they run only with
``SDR_TPU_TEST_GPU=1`` on a machine with an NVIDIA GPU and skip otherwise
(decided in the ``gpu`` fixture, never at import).
"""

import os

if not os.environ.get("SDR_TPU_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not os.environ.get("SDR_TPU_TEST_GPU"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The attached NVIDIA GPU; skips the test anywhere else."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (have {dev.platform}); run with "
                    "SDR_TPU_TEST_GPU=1 on a GPU machine")
    return dev


# Input distributions mirroring the reference's QuickCheck generators
# (tests/TestSuite.hs:55-58): block sizes, tap counts, values in (-10, 10),
# factors from a small prime set.  Sizes are scaled down vs the reference's
# {1024..65536} to keep the matrix fast.
SIZES = [1024, 4096]
NUM_COEFFS = [32, 64, 128, 256]
FACTORS = [1, 2, 3, 5, 7, 11, 13, 17, 23]
