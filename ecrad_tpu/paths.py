"""Where the program finds its data and keeps its compile cache.

The data root holds the NetCDF optics tables a configuration names
(cloud, aerosol and McICA PDF tables; `RadiationConfig.directory_name`
defaults to it). It is `ECRAD_DATA_DIR` when that is set, else the
package's own `data/` directory, which ships the RRTMG-IFS gas-optics
tables, an 8-column IFS input slice and a clear-sky namelist for it.
"""
from __future__ import annotations

import os

PACKAGE_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "data")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: 8 IFS columns x 137 levels (4 daylit) with clouds and aerosols
IFS_SLICE = os.path.join(PACKAGE_DATA_DIR, "ifs_slice_8col.nc")
#: Cloudless LW+SW, full RRTMG-IFS spectrum, for IFS_SLICE
CLOUDLESS_NAMELIST = os.path.join(PACKAGE_DATA_DIR, "cloudless_slice8.nam")


def data_dir() -> str:
    """The data root: $ECRAD_DATA_DIR, else the package data directory."""
    return os.environ.get("ECRAD_DATA_DIR") or PACKAGE_DATA_DIR


def compile_cache_dir() -> str:
    """$JAX_COMPILATION_CACHE_DIR, else the fixed `<repo>/.jax_cache`
    (a stable path, so later runs of the same checkout hit it)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO_ROOT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir()
    (the entry points call this). Returns the directory."""
    import jax
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
