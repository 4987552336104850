"""Offline CLI driver: `python -m ecrad_tpu.driver config.nam in.nc out.nc`.

Reference parity: driver/ecrad_driver.F90 — reads the two namelists, the
NetCDF input, runs the radiation scheme (with an nrepeat benchmarking
loop and wall-clock timing) and writes the flux output. Instead of the
reference's OpenMP column-block loop, columns are sharded over all local
devices, one program per device (parallel/sharding.py column_parallel;
columns are embarrassingly parallel, SURVEY §2.8). The compile cache is
$JAX_COMPILATION_CACHE_DIR, else <repo>/.jax_cache.
"""
from __future__ import annotations

import argparse
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from .config import (load_config_from_namelist,
                     load_driver_config_from_namelist)
from .interface import radiation, setup_radiation
from .io.input_reader import read_input
from .io.output import save_fluxes
from .parallel.sharding import column_mesh, column_parallel, shard_columns
from .paths import enable_compile_cache


def _lowest_level_extinction(setup, single_level, thermo, gas):
    """Extinction (m-1) of the lowest model level at canopy spectral
    resolution, for gas absorption inside canopies.

    Reference: radsurf_intermediate.F90:955-1038 (calc_boundary_conditions)
    — note the reference computes gas optics for its first (TOA) level and
    only ever passes the longwave extinction on (:1027-1036); here the
    *bottom* layer is used, which is the physically intended one for a
    surface canopy. Returns (ext_lw, ext_sw, ssa_sw, g_sw); the SW values
    are returned for completeness though the reference never consumes them.
    """
    from .constants import ACCEL_DUE_TO_GRAVITY
    from .interface import get_albedos
    from .optics.rrtmg.gas_optics import gas_optics as run_gas_optics
    cfg = setup.config
    _, _, lw_albedo = get_albedos(setup, single_level)
    go = run_gas_optics(
        thermo.pressure_hl, thermo.temperature_hl, gas.mixing_ratio,
        single_level.skin_temperature, single_level.cos_sza,
        single_level.solar_irradiance, setup.spec, tables=setup.tables,
        lw_albedo=lw_albedo, min_gas_od_lw=cfg.min_gas_od_lw,
        min_gas_od_sw=cfg.min_gas_od_sw)
    r_over_g = 287.058 / ACCEL_DUE_TO_GRAVITY
    p = thermo.pressure_hl
    t = thermo.temperature_hl
    layer_depth = (r_over_g * (p[:, -1] - p[:, -2])
                   * (t[:, -1] + t[:, -2]) / (p[:, -1] + p[:, -2]))
    inv_depth = (1.0 / jnp.maximum(layer_depth, 1.0e-3))[:, None]
    ext_lw = go.od_lw[:, -1, :] * inv_depth
    ext_sw = go.od_sw[:, -1, :] * inv_depth
    return ext_lw, ext_sw, go.ssa_sw[:, -1, :], jnp.zeros_like(ext_sw)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="ecrad_tpu",
        description="ecRad in JAX: offline radiation driver")
    ap.add_argument("namelist")
    ap.add_argument("input_nc")
    ap.add_argument("output_nc")
    ap.add_argument("surface_output_nc", nargs="?", default=None,
                    help="surface-flux output for tiled surfaces "
                         "(driver/ecrad_driver.F90:116-117, 4th arg)")
    ap.add_argument("--no-jit", action="store_true")
    args = ap.parse_args(argv)
    enable_compile_cache()

    config = load_config_from_namelist(args.namelist)
    driver_config = load_driver_config_from_namelist(args.namelist)

    if driver_config.iverbose >= 2:
        print(f"Reading {args.input_nc}")
    single_level, thermo, gas, cloud, aerosol, is_reversed = read_input(
        args.input_nc, driver_config, return_orientation=True)
    ncol = single_level.ncol
    if is_reversed and driver_config.iverbose >= 2:
        print("Input arrays ordered by increasing height: flipping "
              "(radiation_interface.F90:283-290)")

    # Complex (tiled) surface? (driver/ecrad_driver.F90:184-196)
    from .surface import read_surface, print_surface_representation
    from .surface.properties import input_has_tiled_surface
    surface = None
    if input_has_tiled_surface(args.input_nc):
        surface = read_surface(args.input_nc)
        import dataclasses
        config = dataclasses.replace(config, do_canopy_fluxes_sw=True,
                                     do_canopy_fluxes_lw=True)
        if driver_config.iverbose >= 2:
            print(print_surface_representation(surface.representation))

    istart = max(driver_config.istartcol - 1, 0)
    iend = driver_config.iendcol if driver_config.iendcol > 0 else ncol
    if istart > 0 or iend < ncol:
        sl = jax.tree.map(lambda x: x[istart:iend]
                          if hasattr(x, "shape") and x.ndim > 0 else x,
                          single_level)
        single_level, thermo, gas, cloud, aerosol = (
            sl,
            jax.tree.map(lambda x: x[istart:iend], thermo),
            jax.tree.map(lambda x: x[istart:iend], gas),
            jax.tree.map(lambda x: x[istart:iend], cloud),
            jax.tree.map(lambda x: x[istart:iend], aerosol))

    # cloud effective-size overrides (driver/ecrad_driver.F90:190-215)
    dc = driver_config
    if dc.cloud_separation_scale_toa > 0.0 and \
            dc.cloud_separation_scale_surface > 0.0:
        cloud = cloud.param_cloud_effective_separation_eta(
            thermo, dc.cloud_separation_scale_surface,
            dc.cloud_separation_scale_toa,
            dc.cloud_separation_scale_power,
            dc.cloud_inhom_separation_factor)
    elif dc.low_inv_effective_size > 0.0 or \
            dc.middle_inv_effective_size > 0.0 or \
            dc.high_inv_effective_size > 0.0:
        cloud = cloud.create_inv_cloud_effective_size_eta(
            thermo, dc.low_inv_effective_size,
            dc.middle_inv_effective_size, dc.high_inv_effective_size,
            0.8, 0.45)
    if dc.effective_size_scaling > 0.0 and \
            cloud.inv_cloud_effective_size is not None:
        cloud = cloud.replace(
            inv_cloud_effective_size=cloud.inv_cloud_effective_size
            / dc.effective_size_scaling)

    # input physical-bounds checking (driver/ecrad_driver.F90:245-254)
    from .utils.checks import clamp_inputs, validate_inputs
    findings = validate_inputs(single_level, thermo, gas, cloud, aerosol)
    for msg in findings:
        print(f"Warning: input {msg}")
    if findings and driver_config.do_correct_unphysical_inputs:
        single_level, thermo, gas, cloud, aerosol = clamp_inputs(
            single_level, thermo, gas, cloud, aerosol)

    if driver_config.iverbose >= 2:
        print("Setting up radiation scheme")
    setup = setup_radiation(config)
    if getattr(config, "iverbosesetup", 0) >= 3:
        from .config import describe_config
        print(describe_config(setup.config))

    if driver_config.do_save_inputs:
        from .io.output import save_inputs
        save_inputs("inputs.nc", single_level, thermo, gas, cloud,
                    aerosol)
        if driver_config.iverbose >= 2:
            print("Wrote inputs.nc")

    if config.do_save_radiative_properties:
        from .io.output import save_radiative_properties
        save_radiative_properties("radiative_properties.nc", setup,
                                  single_level, thermo, gas)
        if driver_config.iverbose >= 2:
            print("Wrote radiative_properties.nc")

    # shard columns across local devices (pure data parallelism)
    mesh = None
    ndev = len(jax.devices())
    if (driver_config.do_parallel and ndev > 1
            and single_level.ncol % ndev == 0):
        mesh = column_mesh()
        single_level, thermo, gas, cloud, aerosol = shard_columns(
            (single_level, thermo, gas, cloud, aerosol), mesh)

    if surface is not None:
        # Fold the tiled surface into effective boundary conditions
        # (ecrad_driver.F90:290-292 -> radsurf_intermediate.F90:955-1038)
        from .surface import calc_boundary_conditions, partition_fluxes
        ext_lw = ext_sw = ssa_sw = g_sw = None
        # Gas absorption in canopies needs the canopy scheme to run at
        # full spectral resolution; the reference only ever uses the LW
        # path (radsurf_intermediate.F90:1027-1036).
        if config.do_canopy_gases_lw and config.use_canopy_full_spectrum_lw:
            ext_lw, _, _, _ = _lowest_level_extinction(
                setup, single_level, thermo, gas)
        bc = calc_boundary_conditions(
            setup, surface, single_level.cos_sza,
            ext_sw_air=ext_sw, ssa_sw_air=ssa_sw, g_sw_air=g_sw,
            ext_lw_air=ext_lw)
        single_level = single_level.replace(
            sw_albedo=bc.sw_albedo_diffuse,
            sw_albedo_direct=bc.sw_albedo_direct,
            lw_emissivity=bc.lw_emissivity,
            lw_emission=bc.lw_emission)

    run = lambda *a: radiation(setup, *a)  # noqa: E731
    if driver_config.column_block_size > 0:
        from .parallel.scaling import chunk_columns
        run = chunk_columns(run, driver_config.column_block_size)
    if args.no_jit:
        fn = run
    elif mesh is not None:
        fn = column_parallel(run, mesh)
    else:
        fn = jax.jit(run)

    flux = None
    for jrepeat in range(max(driver_config.nrepeat, 1)):
        t0 = time.time()
        flux = fn(single_level, thermo, gas, cloud, aerosol)
        jax.block_until_ready(flux)
        elapsed = time.time() - t0
        if driver_config.iverbose >= 1:
            print(f"Time elapsed in radiative transfer: "
                  f"{elapsed:.6f} seconds")

    surface_flux = None
    if surface is not None:
        surface_flux = partition_fluxes(surface, bc.intermediate, flux)
        if args.surface_output_nc:
            from .io.output import save_surface_fluxes
            save_surface_fluxes(args.surface_output_nc,
                                jax.device_get(surface_flux))
        elif driver_config.iverbose >= 1:
            print("Warning: file name for surface-flux outputs "
                  "not provided")

    from .utils.checks import validate_fluxes
    for msg in validate_fluxes(flux):
        print(f"Warning: output {msg}")

    if is_reversed:
        # return fluxes in the caller's (height-increasing) orientation
        # (radiation_reverse, radiation_interface.F90:475-617)
        flux = jax.tree.map(
            lambda x: (jnp.flip(x, axis=1)
                       if hasattr(x, "ndim") and x.ndim >= 2
                       and x.shape[1] in (thermo.nlev, thermo.nlev + 1)
                       else x), flux)
        thermo = thermo.replace(
            pressure_hl=jnp.flip(thermo.pressure_hl, axis=1),
            temperature_hl=jnp.flip(thermo.temperature_hl, axis=1))

    if driver_config.iverbose >= 2:
        print(f"Writing {args.output_nc}")
    save_fluxes(args.output_nc, jax.device_get(flux), thermo,
                hdf5=driver_config.do_write_hdf5,
                double_precision=driver_config.do_write_double_precision)
    if getattr(flux, "entrapment_data", None) is not None:
        _dump_entrapment_data(args.output_nc, flux.entrapment_data)
    return 0


def _dump_entrapment_data(output_nc, data):
    """fort.101/fort.102-format text dumps of SPARTACUS entrapment
    internals (the reference's PRINT_ENTRAPMENT_DATA compile flag,
    Makefile:54-60; radiation_spartacus_sw.F90:1007-1020,:1486-1497).
    Written next to the output file as <out>.fort.101/.fort.102."""
    import numpy as np
    x_dir, x_diff, direct_dn, flux_dn = [np.asarray(a) for a in data]
    nlev, nreg, ncol = x_dir.shape
    base = output_nc
    with open(base + ".fort.101", "w") as f101:
        for jcol in range(ncol):
            for jlev in range(nlev):
                vals = (list(x_dir[jlev, :, jcol])
                        + list(x_diff[jlev, :, jcol]) + [1.0] * nreg)
                f101.write(f"{jcol + 1:4d}{jlev + 1:4d}"
                           + "".join(f"{v:14.6e}" for v in vals) + "\n")
    with open(base + ".fort.102", "w") as f102:
        for jcol in range(ncol):
            for jlev in range(nlev):
                vals = (list(direct_dn[jlev, :, jcol])
                        + list(flux_dn[jlev, :, jcol]))
                f102.write(f"{jcol + 1:4d}{jlev + 1:4d}"
                           + "".join(f"{v:14.6e}" for v in vals) + "\n")


if __name__ == "__main__":
    sys.exit(main())
