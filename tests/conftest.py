"""Test configuration: the CPU backend with 8 virtual devices by default.

Tests run on CPU (Pallas kernels in interpret mode); multi-device sharding
tests use the 8 virtual CPU devices.  This must happen before any JAX
backend initialization.

GPU lane: ``TPUFG_TEST_GPU=1 python -m pytest tests/ -m gpu -q`` keeps the
GPU backend and runs the ``gpu``-marked suite (tests/test_gpu.py) with
COMPILED kernels — the production artifact, not interpret mode.  Whether a
card is there is decided inside the ``gpu_backend`` fixture, never at
import or collection time, so every xdist worker collects the same tests.
"""

import os

ON_GPU = bool(os.environ.get("TPUFG_TEST_GPU"))

if not ON_GPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="module")
def gpu_backend():
    """Skip unless this run targets a real GPU backend."""
    if not ON_GPU:
        pytest.skip("GPU lane: needs TPUFG_TEST_GPU=1 and a CUDA GPU")
    if jax.default_backend() != "gpu":
        pytest.skip(f"not a GPU backend: {jax.default_backend()}")


def random_frame(rng, h, w, c=4):
    """uint8-quantized random frame in [0,1] f32 — realistic frame content."""
    return (rng.integers(0, 256, size=(h, w, c)).astype(np.float32) / 255.0)
