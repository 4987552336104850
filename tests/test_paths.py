"""Data root and compile-cache location (ecrad_tpu/paths.py)."""
import os

import jax
import pytest

from ecrad_tpu import paths
from ecrad_tpu.config import RadiationConfig


@pytest.mark.parametrize("env", [None, "/somewhere/jax-cache"])
def test_compile_cache_dir(monkeypatch, env):
    """$JAX_COMPILATION_CACHE_DIR when set, else the fixed
    <repo>/.jax_cache; enable_compile_cache hands it to JAX."""
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(paths.REPO_ROOT, ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        want = env
    assert paths.compile_cache_dir() == want
    before = jax.config.jax_compilation_cache_dir
    try:
        assert paths.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_data_root_defaults_to_the_package(monkeypatch):
    monkeypatch.delenv("ECRAD_DATA_DIR", raising=False)
    assert paths.data_dir() == paths.PACKAGE_DATA_DIR
    assert RadiationConfig().directory_name == paths.PACKAGE_DATA_DIR
    for f in (paths.IFS_SLICE, paths.CLOUDLESS_NAMELIST,
              os.path.join(paths.PACKAGE_DATA_DIR, "rrtmg_tables.npz")):
        assert os.path.exists(f), f
    monkeypatch.setenv("ECRAD_DATA_DIR", "/other/tables")
    assert RadiationConfig().directory_name == "/other/tables"
