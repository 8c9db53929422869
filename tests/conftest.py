import os

# Tests run on a virtual 8-device CPU mesh so sharding logic is exercised
# without accelerator hardware (SURVEY.md §4.4). XLA_FLAGS must be set
# before the backend initializes.
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from tracer import compile_cache  # noqa: E402

# CPU unless JAX_PLATFORMS says otherwise: `JAX_PLATFORMS=cuda,cpu pytest
# -m gpu tests/` runs the GPU-marked tests on a card.
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
# the scan'd integrator takes minutes to compile; cache across processes
compile_cache.enable()


@pytest.fixture
def gpu():
    """The first GPU; skips the test where JAX has none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU; JAX found none")
    return devs[0]
