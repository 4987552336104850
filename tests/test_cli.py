"""The CLI driver (python -m ecrad_tpu.driver) on the in-repository
clear-sky namelist and IFS slice. Under the test configuration there
are 8 CPU devices, so the 8 columns run one per device
(parallel/sharding.py column_parallel)."""
import jax
import numpy as np
from scipy.io import netcdf_file

from ecrad_tpu.driver import main
from ecrad_tpu.paths import CLOUDLESS_NAMELIST, IFS_SLICE


def test_cli_on_in_repo_namelist_and_slice(tmp_path, monkeypatch):
    out = str(tmp_path / "fluxes.nc")
    # the driver turns on the persistent compile cache: keep it here
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert main([CLOUDLESS_NAMELIST, IFS_SLICE, out]) == 0
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    golden = np.load("tests/goldens/cloudless_slice8_f64.npz")
    with netcdf_file(out, "r", mmap=False) as f:
        for name, key in (("flux_up_lw", "lw_up"), ("flux_dn_lw", "lw_dn"),
                          ("flux_up_sw", "sw_up"), ("flux_dn_sw", "sw_dn"),
                          ("flux_dn_direct_sw", "sw_dn_direct")):
            got = np.asarray(f.variables[name][:], np.float64)
            assert got.shape == (8, 138) and np.isfinite(got).all(), name
            # the float32 path, as in tests/test_e2e_cloudless.py
            np.testing.assert_allclose(got, golden[key], atol=0.2,
                                       err_msg=name)
