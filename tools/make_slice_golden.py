#!/usr/bin/env python
"""Write the float64 truth for the in-repository clear-sky case.

Runs the Cloudless LW+SW configuration (ecrad_tpu/data/
cloudless_slice8.nam) on the 8 IFS columns of ecrad_tpu/data/
ifs_slice_8col.nc in double precision on the CPU and writes the flux
profiles to tests/goldens/cloudless_slice8_f64.npz. The float32 path is
held to this truth by tests/test_e2e_cloudless.py on the CPU and by
chip_smoke.py on the GPU.

    python tools/make_slice_golden.py
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "cloudless_slice8_f64.npz")
FIELDS = ("lw_up", "lw_dn", "sw_up", "sw_dn", "sw_dn_direct")


def main():
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, REPO)
    import jax
    import numpy as np
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from ecrad_tpu.config import load_config_from_namelist
    from ecrad_tpu.interface import radiation, setup_radiation
    from ecrad_tpu.io.input_reader import read_input
    from ecrad_tpu.paths import CLOUDLESS_NAMELIST, IFS_SLICE

    setup = setup_radiation(load_config_from_namelist(
        CLOUDLESS_NAMELIST, dtype="float64"))
    flux = jax.jit(lambda *a: radiation(setup, *a))(*read_input(IFS_SLICE))
    out = {k: np.asarray(getattr(flux, k), np.float64) for k in FIELDS}
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN}: lw_up TOA mean {out['lw_up'][:, 0].mean():.4f}"
          f" W m-2, sw_dn surface max {out['sw_dn'][:, -1].max():.4f}")


if __name__ == "__main__":
    main()
