"""Test configuration.

By default the suite runs on a virtual 8-device CPU mesh: unit tests check
numerics and the multi-device sharding path without hardware. Tests marked
`gpu` need the card and skip elsewhere; run them on a GPU machine with
`JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`.
"""
import os

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    # decided per test at run time, never at collection: every xdist worker
    # must collect the same tests
    if request.node.get_closest_marker("gpu") is not None:
        import jax
        if jax.default_backend() != "gpu":
            pytest.skip("needs a GPU: compiled Pallas/Triton kernel")


@pytest.fixture()
def rng(request):
    # deterministic per-test stream: independent of execution order and of
    # Python's per-process hash salt
    import zlib
    seed = zlib.crc32(request.node.nodeid.encode())
    return np.random.default_rng(seed)


@pytest.fixture(scope="session")
def sample_image_dir():
    d = "/root/reference/src/odml_visual_odometry/sample_images"
    if not os.path.isdir(d):
        pytest.skip("reference sample images unavailable")
    return d
