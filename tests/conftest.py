"""Test configuration.

Tests run on the CPU unless JAX_PLATFORMS says otherwise, with 8
virtual CPU devices so that column sharding is tested on a mesh. Tests
of code compiled for the card carry the `gpu` marker and take the `gpu`
fixture, which skips them where JAX has no GPU; run them on a machine
with one by `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
# Keep test numerics deterministic & fast
os.environ.setdefault("JAX_ENABLE_X64", "0")

import pytest  # noqa: E402

from ecrad_tpu.paths import data_dir  # noqa: E402

REFERENCE_DIR = "/root/reference"
TEST_IFS_DIR = os.path.join(REFERENCE_DIR, "test", "ifs")


@pytest.fixture(scope="session")
def reference_data_dir():
    """The data root (ecrad_tpu.paths.data_dir) when it holds the cloud,
    aerosol and McICA tables that the cloudy configurations read."""
    root = data_dir()
    if not os.path.exists(os.path.join(root, "mcica_gamma.nc")):
        pytest.skip(f"no cloud/McICA tables in the data root {root} "
                    "(set ECRAD_DATA_DIR)")
    return root


@pytest.fixture(scope="session")
def test_ifs_dir():
    if not os.path.isdir(TEST_IFS_DIR):
        pytest.skip("reference test/ifs directory not available")
    return TEST_IFS_DIR


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    import jax
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda,cpu)")
