#!/usr/bin/env python
"""Generate self-regression goldens for the deterministic solvers.

The reference repo ships a golden NetCDF only for the default McICA
config; Tripleclouds/SPARTACUS/Homogeneous/Cloudless are deterministic
here (no RNG), so checked-in goldens of our own output catch numerical
drift from refactors (the reference's test strategy, SURVEY.md section 4,
applied to ourselves). Run on CPU for platform-stable numerics:

    JAX_PLATFORMS=cpu python tools/make_regression_goldens.py

Writes tests/goldens/<solver>_meridian.npz (broadband flux profiles).
"""
import os
import sys

# EXACTLY the test environment (tests/conftest.py): 8 virtual CPU
# devices — the device-count flag changes XLA CPU reduction
# partitioning and shifts fluxes by ~1e-3, so goldens generated on a
# single device do NOT match the suite.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:
    pass


def make_ifs_variant_goldens(outdir):
    """Full-meridian-width goldens for the reference's 7-variant
    test/ifs namelist matrix (test/ifs/Makefile:12-63), via the driver
    CLI path — pins lwscat / Exp-Ran / entrapment variants, not just
    the default config per solver."""
    import tempfile

    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "tests"))
    from ifs_variants import (GOLDEN_VARS, IFS_DIR, VARIANTS,
                              write_variant_namelist)

    from ecrad_tpu.driver import main as driver_main
    from ecrad_tpu.io.netcdf import NetcdfFile

    os.makedirs(outdir, exist_ok=True)
    for name, subs in VARIANTS:
        with tempfile.TemporaryDirectory() as tmp:
            nam = write_variant_namelist(tmp, name, subs,
                                         {"iverbose": "1"})
            out_nc = os.path.join(tmp, f"{name}_out.nc")
            rc = driver_main([nam, os.path.join(IFS_DIR,
                                                "ecrad_meridian.nc"),
                              out_nc])
            assert rc == 0, f"driver failed for {name}"
            out = {}
            with NetcdfFile(out_nc) as f:
                for var in GOLDEN_VARS:
                    try:
                        out[var] = np.asarray(f.read(var))
                    except Exception:
                        pass
        path = os.path.join(outdir, f"ifs_{name}.npz")
        np.savez_compressed(path, **out)
        print(f"wrote {path}: flux_up_lw TOA mean "
              f"{out['flux_up_lw'][:, 0].mean():.3f}")


def make_f64_goldens(outdir):
    """f64 CPU truth for every deterministic solver on the meridian
    case — the anchors of the production-accuracy gates
    (tests/test_f64_validation.py per-field CPU-f32 gates for all
    four): the analogue of the reference's golden-file strategy
    (test/ifs/README:33-37) against double precision, which is how
    the reference itself runs (parkind1 JPRB)."""
    import jax
    jax.config.update("jax_enable_x64", True)
    from ecrad_tpu.config import Solver, load_config_from_namelist
    from ecrad_tpu.interface import radiation, setup_radiation
    from ecrad_tpu.io.input_reader import read_input
    inputs = read_input("/root/reference/test/ifs/ecrad_meridian.nc")
    for name, solver, kw in [
            ("spartacus", Solver.SPARTACUS, {"do_3d_effects": True}),
            ("tripleclouds", Solver.TRIPLECLOUDS, {}),
            ("homogeneous", Solver.HOMOGENEOUS, {}),
            ("cloudless", Solver.CLOUDLESS, {})]:
        cfg = load_config_from_namelist(
            "/root/reference/test/ifs/configCY47R1.nam",
            directory_name="/root/reference/data",
            do_save_spectral_flux=False, do_canopy_fluxes_sw=False,
            do_canopy_fluxes_lw=False, i_solver_sw=solver,
            i_solver_lw=solver, dtype="float64", **kw)
        setup = setup_radiation(cfg)
        flux = jax.jit(lambda *a: radiation(setup, *a))(*inputs)
        out = {k: np.asarray(getattr(flux, k))
               for k in ("lw_up", "lw_dn", "sw_up", "sw_dn",
                         "sw_dn_direct", "lw_up_clear", "lw_dn_clear",
                         "sw_up_clear", "sw_dn_clear")}
        path = os.path.join(outdir, f"{name}_meridian_f64.npz")
        np.savez_compressed(path, **out)
        print(f"wrote {path}: lw_up TOA mean "
              f"{out['lw_up'][:, 0].mean():.3f}")


def main():
    from ecrad_tpu.config import Solver, load_config_from_namelist
    from ecrad_tpu.interface import radiation, setup_radiation
    from ecrad_tpu.io.input_reader import read_input

    inputs = read_input("/root/reference/test/ifs/ecrad_meridian.nc")
    outdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "..", "tests", "goldens")
    os.makedirs(outdir, exist_ok=True)
    for name, solver, kw in [
            ("cloudless", Solver.CLOUDLESS, {}),
            ("homogeneous", Solver.HOMOGENEOUS, {}),
            ("tripleclouds", Solver.TRIPLECLOUDS, {}),
            ("spartacus", Solver.SPARTACUS, {"do_3d_effects": True}),
    ]:
        cfg = load_config_from_namelist(
            "/root/reference/test/ifs/configCY47R1.nam",
            directory_name="/root/reference/data",
            do_save_spectral_flux=False, do_canopy_fluxes_sw=False,
            do_canopy_fluxes_lw=False, i_solver_sw=solver,
            i_solver_lw=solver, **kw)
        setup = setup_radiation(cfg)
        flux = jax.jit(lambda *a: radiation(setup, *a))(*inputs)
        out = {k: np.asarray(getattr(flux, k))
               for k in ("lw_up", "lw_dn", "sw_up", "sw_dn",
                         "sw_dn_direct", "lw_up_clear", "lw_dn_clear",
                         "sw_up_clear", "sw_dn_clear")}
        path = os.path.join(outdir, f"{name}_meridian.npz")
        np.savez_compressed(path, **out)
        print(f"wrote {path}: lw_up TOA mean "
              f"{out['lw_up'][:, 0].mean():.3f}")


if __name__ == "__main__":
    args = sys.argv[1:]
    outdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "..", "tests", "goldens")
    if "--ifs" in args or not args:
        make_ifs_variant_goldens(outdir)
    if "--solvers" in args or not args:
        main()
    if "--f64" in args or "--spartacus-f64" in args or not args:
        # LAST: flips jax_enable_x64 for the process
        make_f64_goldens(outdir)
