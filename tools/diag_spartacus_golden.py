#!/usr/bin/env python
"""Diagnose the SPARTACUS regression-golden drift: compare BOTH the
pinned golden and the current f32 output against an f64 run of the
same code on CPU. Whichever is closer to the f64 truth is the better
answer; a current-output win justifies regenerating the golden.

    JAX_PLATFORMS=cpu python tools/diag_spartacus_golden.py
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np
import jax

# force the CPU through the config API as well
jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:
    pass
jax.config.update("jax_enable_x64", True)


def run(dtype):
    from ecrad_tpu.config import Solver, load_config_from_namelist
    from ecrad_tpu.interface import radiation, setup_radiation
    from ecrad_tpu.io.input_reader import read_input
    inputs = read_input("/root/reference/test/ifs/ecrad_meridian.nc")
    cfg = load_config_from_namelist(
        "/root/reference/test/ifs/configCY47R1.nam",
        directory_name="/root/reference/data",
        do_save_spectral_flux=False, do_canopy_fluxes_sw=False,
        do_canopy_fluxes_lw=False, i_solver_sw=Solver.SPARTACUS,
        i_solver_lw=Solver.SPARTACUS, do_3d_effects=True, dtype=dtype)
    setup = setup_radiation(cfg)
    return jax.jit(lambda *a: radiation(setup, *a))(*inputs)


def main():
    golden = np.load(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", "tests", "goldens",
        "spartacus_meridian.npz"))
    f32 = run("float32")
    f64 = run("float64")
    for key in golden.files:
        t = np.asarray(getattr(f64, key), np.float64)
        a = np.asarray(getattr(f32, key), np.float64)
        g = np.asarray(golden[key], np.float64)
        scale = max(np.abs(t).max(), 1.0)
        print(f"{key:28s} cur_vs_f64 {np.abs(a - t).max():.4e}  "
              f"golden_vs_f64 {np.abs(g - t).max():.4e}  "
              f"cur_vs_golden {np.abs(a - g).max():.4e}  "
              f"(scale {scale:.1f})")


if __name__ == "__main__":
    main()
