"""Write flux outputs to NetCDF.

Reference parity: radiation/radiation_save.F90:34-304 (save_fluxes) —
same variable names/units so downstream tooling (ecradplot,
compare_output.py) works unchanged.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..types import Flux, Thermodynamics
from .netcdf import write_netcdf


def save_fluxes(path: str, flux: Flux,
                thermodynamics: Optional[Thermodynamics] = None,
                **nc_kwargs) -> None:
    """nc_kwargs forward to write_netcdf (hdf5=, deflate_level=,
    double_precision= — the driver's do_write_hdf5 path)."""
    dims = {}
    variables = {}
    attrs = {}

    def add(name, dims_needed, data, units, long_name):
        if data is None:
            return
        data = np.asarray(data)
        for dname, dlen in zip(dims_needed, data.shape):
            dims.setdefault(dname, dlen)
        variables[name] = (dims_needed, data.astype(np.float32))
        attrs[name] = {"units": units, "long_name": long_name}

    if thermodynamics is not None:
        add("pressure_hl", ("column", "half_level"),
            thermodynamics.pressure_hl, "Pa", "Pressure on half-levels")

    cl = ("column", "half_level")
    add("flux_up_lw", cl, flux.lw_up, "W m-2", "Upwelling longwave flux")
    add("flux_dn_lw", cl, flux.lw_dn, "W m-2", "Downwelling longwave flux")
    add("flux_up_sw", cl, flux.sw_up, "W m-2", "Upwelling shortwave flux")
    add("flux_dn_sw", cl, flux.sw_dn, "W m-2",
        "Downwelling shortwave flux")
    add("flux_dn_direct_sw", cl, flux.sw_dn_direct, "W m-2",
        "Downwelling direct shortwave flux")
    add("flux_up_lw_clear", cl, flux.lw_up_clear, "W m-2",
        "Upwelling clear-sky longwave flux")
    add("flux_dn_lw_clear", cl, flux.lw_dn_clear, "W m-2",
        "Downwelling clear-sky longwave flux")
    add("flux_up_sw_clear", cl, flux.sw_up_clear, "W m-2",
        "Upwelling clear-sky shortwave flux")
    add("flux_dn_sw_clear", cl, flux.sw_dn_clear, "W m-2",
        "Downwelling clear-sky shortwave flux")
    add("flux_dn_direct_sw_clear", cl, flux.sw_dn_direct_clear, "W m-2",
        "Downwelling clear-sky direct shortwave flux")
    add("lw_derivative", cl, flux.lw_derivatives, "1",
        "Derivative of upwelling LW flux w.r.t. surface value")
    add("cloud_cover_lw", ("column",), flux.cloud_cover_lw, "1",
        "Total cloud cover diagnosed by longwave solver")
    add("cloud_cover_sw", ("column",), flux.cloud_cover_sw, "1",
        "Total cloud cover diagnosed by shortwave solver")
    # surface spectral fluxes (reference names: radiation_save.F90:270-282)
    add("spectral_flux_dn_sw_surf", ("column", "band_sw"),
        flux.sw_dn_surf_band, "W m-2",
        "Spectral downwelling shortwave flux at surface")
    add("spectral_flux_dn_direct_sw_surf", ("column", "band_sw"),
        flux.sw_dn_direct_surf_band, "W m-2",
        "Spectral downwelling direct shortwave flux at surface")
    add("spectral_flux_dn_sw_surf_clear", ("column", "band_sw"),
        flux.sw_dn_surf_clear_band, "W m-2",
        "Spectral downwelling clear-sky shortwave flux at surface")
    add("spectral_flux_dn_direct_sw_surf_clear", ("column", "band_sw"),
        flux.sw_dn_direct_surf_clear_band, "W m-2",
        "Spectral downwelling clear-sky direct shortwave flux at surface")
    add("flux_dn_lw_surf_band", ("column", "band_lw"),
        flux.lw_dn_surf_band, "W m-2",
        "Surface downwelling longwave flux in each band")
    # canopy-top fluxes (radiation_save.F90 canopy_flux_*)
    add("canopy_flux_dn_diffuse_sw_surf", ("column", "canopy_band_sw"),
        flux.sw_dn_diffuse_surf_canopy, "W m-2",
        "Surface downwelling diffuse shortwave flux in canopy bands")
    add("canopy_flux_dn_direct_sw_surf", ("column", "canopy_band_sw"),
        flux.sw_dn_direct_surf_canopy, "W m-2",
        "Surface downwelling direct shortwave flux in canopy bands")
    add("canopy_flux_dn_lw_surf", ("column", "canopy_band_lw"),
        flux.lw_dn_surf_canopy, "W m-2",
        "Surface downwelling longwave flux in canopy bands")
    # band-resolved profiles (do_save_spectral_flux)
    p3 = ("column", "half_level", "band_sw")
    add("spectral_flux_up_sw", p3, flux.sw_up_band, "W m-2",
        "Spectral upwelling shortwave flux")
    add("spectral_flux_dn_sw", p3, flux.sw_dn_band, "W m-2",
        "Spectral downwelling shortwave flux")
    add("spectral_flux_dn_direct_sw", p3, flux.sw_dn_direct_band, "W m-2",
        "Spectral downwelling direct shortwave flux")
    add("spectral_flux_up_sw_clear", p3, flux.sw_up_band_clear, "W m-2",
        "Spectral clear-sky upwelling shortwave flux")
    add("spectral_flux_dn_sw_clear", p3, flux.sw_dn_band_clear, "W m-2",
        "Spectral clear-sky downwelling shortwave flux")
    add("spectral_flux_dn_direct_sw_clear", p3,
        flux.sw_dn_direct_band_clear, "W m-2",
        "Spectral clear-sky downwelling direct shortwave flux")
    p3l = ("column", "half_level", "band_lw")
    add("spectral_flux_up_lw", p3l, flux.lw_up_band, "W m-2",
        "Spectral upwelling longwave flux")
    add("spectral_flux_dn_lw", p3l, flux.lw_dn_band, "W m-2",
        "Spectral downwelling longwave flux")
    add("spectral_flux_up_lw_clear", p3l, flux.lw_up_band_clear, "W m-2",
        "Spectral clear-sky upwelling longwave flux")
    add("spectral_flux_dn_lw_clear", p3l, flux.lw_dn_band_clear, "W m-2",
        "Spectral clear-sky downwelling longwave flux")

    write_netcdf(path, dims, variables, attrs,
                 global_attrs={"title":
                               "Radiative fluxes from ecRad (JAX)"},
                 **nc_kwargs)


def save_inputs(path: str, single_level, thermo, gas, cloud,
                aerosol) -> None:
    """Dump the scheme's inputs (driver do_save_inputs;
    radiation_save.F90:719 save_inputs) with the standard names, so the
    file can be fed back into the driver."""
    from ..constants import GAS_NAMES
    dims = {}
    variables = {}

    def add(name, dims_needed, data):
        if data is None:
            return
        data = np.asarray(data)
        for dname, dlen in zip(dims_needed, data.shape):
            dims.setdefault(dname, dlen)
        variables[name] = (dims_needed, data.astype(np.float32))

    add("pressure_hl", ("column", "half_level"), thermo.pressure_hl)
    add("temperature_hl", ("column", "half_level"), thermo.temperature_hl)
    add("cos_solar_zenith_angle", ("column",), single_level.cos_sza)
    add("skin_temperature", ("column",), single_level.skin_temperature)
    add("sw_albedo", ("column", "sw_albedo_band"), single_level.sw_albedo)
    add("lw_emissivity", ("column", "lw_emiss_band"),
        single_level.lw_emissivity)
    cl = ("column", "level")
    for name in GAS_NAMES:
        field = np.asarray(gas.get(name))
        if np.any(field != 0.0):
            add(f"{name}_mmr" if name != "h2o" else "q", cl, field)
    add("cloud_fraction", cl, cloud.fraction)
    add("q_liquid", cl, cloud.q_liq)
    add("q_ice", cl, cloud.q_ice)
    add("re_liquid", cl, cloud.re_liq)
    add("re_ice", cl, cloud.re_ice)
    add("fractional_std", cl, cloud.fractional_std)
    add("overlap_param", ("column", "level_interface"),
        cloud.overlap_param)
    add("inv_cloud_effective_size", cl, cloud.inv_cloud_effective_size)
    if aerosol is not None and np.any(
            np.asarray(aerosol.mixing_ratio) != 0.0):
        add("aerosol_mmr", ("column", "level", "aerosol_type"),
            aerosol.mixing_ratio)
    write_netcdf(path, dims, variables,
                 global_attrs={"title": "ecRad (JAX) scheme inputs"})


def save_radiative_properties(path: str, setup, single_level, thermo,
                              gas) -> None:
    """Dump the per-g-point radiative properties entering the solver
    (do_save_radiative_properties; radiation_save.F90:411), the
    intermediate the reference exposes for kernel-level validation."""
    import jax

    from ..interface import get_albedos
    from ..optics.rrtmg.gas_optics import gas_optics
    cfg = setup.config
    _, _, lw_albedo = get_albedos(setup, single_level)
    go = jax.jit(lambda p, t, m, s, c: gas_optics(
        p, t, m, s, c, single_level.solar_irradiance, setup.spec,
        tables=setup.tables, lw_albedo=lw_albedo,
        min_gas_od_lw=cfg.min_gas_od_lw,
        min_gas_od_sw=cfg.min_gas_od_sw))(
        thermo.pressure_hl, thermo.temperature_hl, gas.mixing_ratio,
        single_level.skin_temperature, single_level.cos_sza)
    dims = {}
    variables = {}

    def add(name, dims_needed, data):
        if data is None:
            return
        data = np.asarray(data)
        for dname, dlen in zip(dims_needed, data.shape):
            dims.setdefault(dname, dlen)
        variables[name] = (dims_needed, data.astype(np.float32))

    clg = ("column", "level", "g_lw")
    csg = ("column", "level", "g_sw")
    add("od_lw", clg, go.od_lw)
    add("od_sw", csg, go.od_sw)
    add("ssa_sw", csg, go.ssa_sw)
    add("planck_hl", ("column", "half_level", "g_lw"), go.planck_hl)
    add("lw_emission", ("column", "g_lw"), go.lw_emission)
    add("incoming_sw", ("column", "g_sw"), go.incoming_sw)
    write_netcdf(path, dims, variables,
                 global_attrs={"title":
                               "ecRad (JAX) per-g radiative properties"})


def save_surface_fluxes(path: str, surface_flux) -> None:
    """Write per-facet surface fluxes.

    Reference parity: radsurf/radsurf_save.F90:24-140 — same variable
    names (flux_dn_lw_facet, absorption_sw_canopy, ...) and layout
    (column, facet)/(column, tile)."""
    dims = {}
    variables = {}
    attrs = {}

    def add(name, dims_needed, data, units, long_name):
        if data is None:
            return
        data = np.asarray(data)
        for dname, dlen in zip(dims_needed, data.shape):
            dims.setdefault(dname, dlen)
        variables[name] = (dims_needed, data.astype(np.float32))
        attrs[name] = {"units": units, "long_name": long_name}

    cf = ("column", "facet")
    ct = ("column", "tile")
    add("flux_dn_lw_facet", cf, surface_flux.lw_dn_facet, "W m-2",
        "Longwave flux into facet of surface")
    add("flux_up_lw_facet", cf, surface_flux.lw_up_facet, "W m-2",
        "Longwave flux out of facet of surface")
    add("absorption_lw_canopy", ct, surface_flux.lw_abs_canopy, "W m-2",
        "Longwave absorption by tile canopy")
    add("flux_dn_sw_facet", cf, surface_flux.sw_dn_facet, "W m-2",
        "Shortwave flux into facet of surface")
    add("flux_dn_direct_sw_facet", cf, surface_flux.sw_dn_direct_facet,
        "W m-2", "Shortwave direct flux into facet of surface")
    add("flux_up_sw_facet", cf, surface_flux.sw_up_facet, "W m-2",
        "Shortwave flux out of facet of surface")
    add("absorption_sw_canopy", ct, surface_flux.sw_abs_canopy, "W m-2",
        "Shortwave absorption by tile canopy")

    write_netcdf(path, dims, variables, attrs,
                 global_attrs={"title":
                               "Surface fluxes from ecRad (JAX)"})
