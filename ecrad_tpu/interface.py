"""Top-level orchestrator: setup + the radiation() entry point.

Reference parity: radiation/radiation_interface.F90 — setup_radiation
(:37) builds static tables and spectral mappings; radiation (:175)
composes gas optics -> cloud optics -> aerosol optics -> solver dispatch
-> flux assembly. Here setup produces a `RadiationSetup` of numpy
constants (closed over by jit), and `radiation()` is a pure jittable
function of the input pytrees.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import RadiationConfig, Solver, GasModel
from .constants import NG_LW, NG_SW
from .optics.rrtmg.gas_optics import (
    WAVENUM1_LW, WAVENUM1_SW, WAVENUM2_LW, WAVENUM2_SW,
    GasOpticsSpec, gas_optics, make_spec,
)
from .optics.rrtmg.tables import load_tables
from .optics.spectral_mapping import expand_to_g, interval_mapping
from .solvers.cloudless import solver_cloudless_lw, solver_cloudless_sw
from .types import Aerosol, Cloud, Flux, GasConcs, SingleLevel, \
    Thermodynamics


@dataclass
class RadiationSetup:
    """Static (trace-time constant) data for a given configuration."""
    config: RadiationConfig
    tables: dict                       # RRTMG coefficient tables (numpy)
    spec: GasOpticsSpec
    # albedo/emissivity interval mappings (one of map/weights is None)
    sw_albedo_map: Optional[np.ndarray]
    sw_albedo_weights: Optional[np.ndarray]
    lw_emiss_map: Optional[np.ndarray]
    lw_emiss_weights: Optional[np.ndarray]
    cloud_optics: Optional[object] = None
    aerosol_optics: Optional[object] = None
    pdf_sampler: Optional[object] = None


def setup_radiation(config: RadiationConfig) -> RadiationSetup:
    """Load tables & precompute spectral mappings
    (radiation_interface.F90:37-134)."""
    config = config.consolidated()
    if config.i_gas_model == GasModel.MONOCHROMATIC:
        # single band/g-point; trivial spectral mapping
        one = np.zeros(1, dtype=int)
        spec = GasOpticsSpec(
            band_from_g_lw=one, band_from_g_sw=one,
            g_from_reordered_g_lw=np.arange(1),
            g_from_reordered_g_sw=np.arange(1),
            band_from_reordered_g_lw=one, band_from_reordered_g_sw=one)
        setup = RadiationSetup(
            config=config, tables={}, spec=spec,
            sw_albedo_map=one, sw_albedo_weights=None,
            lw_emiss_map=one, lw_emiss_weights=None)
        if config.i_solver_sw == Solver.MCICA or \
                config.i_solver_lw == Solver.MCICA:
            from .solvers.pdf_sampler import setup_pdf_sampler
            setup.pdf_sampler = setup_pdf_sampler(config)
        return setup
    tables = load_tables()
    spec = make_spec(
        reorder_lw=config.i_solver_lw == Solver.SPARTACUS,
        reorder_sw=config.i_solver_sw == Solver.SPARTACUS,
        tables=tables)

    sw_map, sw_weights = interval_mapping(
        config.sw_albedo_wavelength_bound, config.i_sw_albedo_index,
        WAVENUM1_SW, WAVENUM2_SW, config.do_nearest_spectral_sw_albedo)
    lw_map, lw_weights = interval_mapping(
        config.lw_emiss_wavelength_bound, config.i_lw_emiss_index,
        WAVENUM1_LW, WAVENUM2_LW, config.do_nearest_spectral_lw_emiss)

    setup = RadiationSetup(
        config=config, tables=tables, spec=spec,
        sw_albedo_map=sw_map, sw_albedo_weights=sw_weights,
        lw_emiss_map=lw_map, lw_emiss_weights=lw_weights)

    if (config.i_solver_sw != Solver.CLOUDLESS
            or config.i_solver_lw != Solver.CLOUDLESS):
        from .optics.cloud import setup_cloud_optics
        setup.cloud_optics = setup_cloud_optics(config)
    if config.use_aerosols:
        from .optics.aerosol import setup_aerosol_optics
        setup.aerosol_optics = setup_aerosol_optics(config)
    if config.i_solver_sw == Solver.MCICA or \
            config.i_solver_lw == Solver.MCICA:
        from .solvers.pdf_sampler import setup_pdf_sampler
        setup.pdf_sampler = setup_pdf_sampler(config)
    return setup


def get_albedos(setup: RadiationSetup, single_level: SingleLevel):
    """Per-g surface albedos (radiation_single_level.F90:204-330).

    Returns (sw_albedo_diffuse, sw_albedo_direct, lw_albedo), each
    (ncol, ng). When use_canopy_full_spectrum_* the single-level values
    were written by the surface/canopy scheme directly in (reordered)
    g space and pass through unchanged (:240-248)."""
    cfg = setup.config
    band_g_sw = setup.spec.band_from_reordered_g_sw
    band_g_lw = setup.spec.band_from_reordered_g_lw
    if cfg.use_canopy_full_spectrum_sw and \
            single_level.sw_albedo.shape[-1] == len(band_g_sw):
        sw_diffuse = single_level.sw_albedo
        sw_direct = (single_level.sw_albedo_direct
                     if single_level.sw_albedo_direct is not None
                     else sw_diffuse)
    else:
        sw_diffuse = expand_to_g(single_level.sw_albedo,
                                 setup.sw_albedo_map,
                                 setup.sw_albedo_weights, band_g_sw)
        if single_level.sw_albedo_direct is not None:
            sw_direct = expand_to_g(single_level.sw_albedo_direct,
                                    setup.sw_albedo_map,
                                    setup.sw_albedo_weights, band_g_sw)
        else:
            sw_direct = sw_diffuse
    if cfg.use_canopy_full_spectrum_lw and \
            single_level.lw_emissivity.shape[-1] == len(band_g_lw):
        lw_albedo = 1.0 - single_level.lw_emissivity
    else:
        lw_albedo = 1.0 - expand_to_g(single_level.lw_emissivity,
                                      setup.lw_emiss_map,
                                      setup.lw_emiss_weights, band_g_lw)
    return sw_diffuse, sw_direct, lw_albedo


def _indexed_band_sum(flux_g, band_from_g, nbands):
    """Sum per-g values into bands: (ncol, ..., ng) -> (ncol, ..., nb).

    One-hot matmul (radiation_flux.F90:518 indexed_sum)."""
    onehot = jnp.asarray(
        np.eye(nbands, dtype=np.float32)[:, band_from_g])  # (nb, ng)
    return jnp.einsum("...g,bg->...b", flux_g, onehot,
                      precision=jax.lax.Precision.HIGHEST)


def _gsum(x):
    """Broadband sum of a g-first flux profile:
    (nlev+1, ng, ncol) -> (ncol, nlev+1), or (ng, ncol) -> (ncol,)."""
    return x.sum(-2).T


def _surf_g(x):
    """Surface slice of a g-first flux profile:
    (nlev+1, ng, ncol) -> (ncol, ng)."""
    return x[-1].T


def _band_sum_gfirst(x, band_from_g, nbands):
    """g-first profile (nlev+1, ng, ncol) -> (ncol, nlev+1, nbands)."""
    onehot = jnp.asarray(
        np.eye(nbands, dtype=np.float32)[:, band_from_g])  # (nb, ng)
    return jnp.einsum("lgc,bg->clb", x, onehot,
                      precision=jax.lax.Precision.HIGHEST)


def _canopy_sum(flux_g, band_from_g, imap, weights):
    """Per-g surface flux -> canopy spectral intervals
    (radiation_flux.F90:377-450): nearest-interval indexed sum, or
    band-sum followed by interval overlap weights."""
    if imap is not None:
        interval_from_g = imap[band_from_g]
        nint = int(np.max(imap)) + 1
        return _indexed_band_sum(flux_g, interval_from_g, nint)
    band_sums = _indexed_band_sum(flux_g, band_from_g,
                                  int(np.max(band_from_g)) + 1)
    w = jnp.asarray(weights, flux_g.dtype)   # (nint, nband)
    return jnp.matmul(band_sums, w.T,
                      precision=jax.lax.Precision.HIGHEST)


#: flux fields carrying a level axis (axis 1), flipped back for
#: reversed-orientation inputs (radiation_reverse,
#: radiation_interface.F90:475-617)
_LEVEL_FLUX_FIELDS = (
    "lw_up", "lw_dn", "sw_up", "sw_dn", "sw_dn_direct",
    "lw_up_clear", "lw_dn_clear", "sw_up_clear", "sw_dn_clear",
    "sw_dn_direct_clear",
    "lw_up_band", "lw_dn_band", "sw_up_band", "sw_dn_band",
    "sw_dn_direct_band",
    "lw_up_band_clear", "lw_dn_band_clear", "sw_up_band_clear",
    "sw_dn_band_clear", "sw_dn_direct_band_clear",
    "lw_derivatives",
)


def radiation(setup: RadiationSetup, single_level: SingleLevel,
              thermodynamics: Thermodynamics, gas: GasConcs,
              cloud: Optional[Cloud] = None,
              aerosol: Optional[Aerosol] = None) -> Flux:
    """Compute radiative fluxes (radiation_interface.F90:175-473).

    Height-increasing (pressure-decreasing) inputs are handled the way
    the reference handles them inside radiation() itself
    (radiation_interface.F90:283-290): every level-bearing input is
    flipped, the TOA-first pipeline runs, and the flux profiles are
    flipped back.

    When pressure_hl is concrete (eager callers, the driver) the
    orientation check is a Python bool, the canonical orientation skips
    all flips entirely, and a reversed input is flipped with plain
    jnp.flip — bit-identical to running the canonical orientation.
    Under jit the check is a traced scalar select; that path is correct
    but only ulp-exact: XLA's CPU backend unswitches the uniform select
    predicate into two loop versions whose codegen (FMA contraction)
    can differ in the last bits (measured <= 1e-3 W/m2 on meridian
    fluxes, far below the golden-test tolerances)."""
    phl = thermodynamics.pressure_hl
    if not isinstance(phl, jax.core.Tracer):
        if not bool(phl[0, 1] < phl[0, 0]):
            return _radiation_oriented(setup, single_level,
                                       thermodynamics, gas, cloud,
                                       aerosol)
        is_rev = True

        def flip(x, axis=1):
            return None if x is None else jnp.flip(x, axis)
    else:
        is_rev = phl[0, 1] < phl[0, 0]

        def flip(x, axis=1):
            if x is None:
                return None
            return jnp.where(is_rev, jnp.flip(x, axis), x)

    thermodynamics = thermodynamics.replace(
        pressure_hl=flip(phl),
        temperature_hl=flip(thermodynamics.temperature_hl),
        h2o_sat_liq=flip(thermodynamics.h2o_sat_liq))
    gas = gas.replace(mixing_ratio=flip(gas.mixing_ratio))
    if cloud is not None:
        cloud = cloud.replace(
            q_liq=flip(cloud.q_liq), q_ice=flip(cloud.q_ice),
            re_liq=flip(cloud.re_liq), re_ice=flip(cloud.re_ice),
            fraction=flip(cloud.fraction),
            fractional_std=flip(cloud.fractional_std),
            overlap_param=flip(cloud.overlap_param),
            inv_cloud_effective_size=flip(
                cloud.inv_cloud_effective_size),
            inv_inhom_effective_size=flip(
                cloud.inv_inhom_effective_size))
    if aerosol is not None:
        aerosol = aerosol.replace(
            mixing_ratio=flip(aerosol.mixing_ratio),
            od_sw=flip(aerosol.od_sw), ssa_sw=flip(aerosol.ssa_sw),
            g_sw=flip(aerosol.g_sw), od_lw=flip(aerosol.od_lw),
            ssa_lw=flip(aerosol.ssa_lw))

    flux = _radiation_oriented(setup, single_level, thermodynamics, gas,
                               cloud, aerosol)
    return flux.replace(**{
        name: flip(getattr(flux, name))
        for name in _LEVEL_FLUX_FIELDS
        if getattr(flux, name) is not None})


def _radiation_oriented(setup: RadiationSetup, single_level: SingleLevel,
                        thermodynamics: Thermodynamics, gas: GasConcs,
                        cloud: Optional[Cloud] = None,
                        aerosol: Optional[Aerosol] = None) -> Flux:
    cfg = setup.config
    dtype = jnp.float32 if cfg.dtype == "float32" else jnp.float64

    # cast every floating input to the configured compute dtype up front
    # so float64 validation runs don't mix precisions inside scan carries
    def _cast(tree):
        if tree is None:
            return None
        return jax.tree.map(
            lambda x: x.astype(dtype)
            if hasattr(x, "dtype") and jnp.issubdtype(x.dtype,
                                                      jnp.floating)
            else x, tree)

    single_level = _cast(single_level)
    thermodynamics = _cast(thermodynamics)
    gas = _cast(gas)
    cloud = _cast(cloud)
    aerosol = _cast(aerosol)
    sw_alb_diff, sw_alb_dir, lw_albedo = get_albedos(setup, single_level)

    if cfg.i_gas_model == GasModel.MONOCHROMATIC:
        from .optics.monochromatic import gas_optics_mono
        mono = gas_optics_mono(cfg, single_level, thermodynamics)
        from .optics.rrtmg.gas_optics import GasOptics
        go = GasOptics(od_lw=mono.od_lw, od_sw=mono.od_sw,
                       ssa_sw=mono.ssa_sw, planck_hl=mono.planck_hl,
                       lw_emission=mono.lw_emission,
                       incoming_sw=mono.incoming_sw)
    else:
        go = gas_optics(
            thermodynamics.pressure_hl, thermodynamics.temperature_hl,
            gas.mixing_ratio, single_level.skin_temperature,
            single_level.cos_sza, single_level.solar_irradiance,
            setup.spec, tables=setup.tables, lw_albedo=lw_albedo,
            min_gas_od_lw=cfg.min_gas_od_lw,
            min_gas_od_sw=cfg.min_gas_od_sw,
            spectral_solar_scaling=(single_level.spectral_solar_scaling
                                    if cfg.use_spectral_solar_scaling
                                    else None),
            dtype=dtype)

    # Tiled/canopy surfaces supply the surface LW emission directly
    # (radiation_ifs_rrtm.F90:436-443); it overrides Planck x (1-albedo).
    if single_level.lw_emission is not None:
        emission = single_level.lw_emission
        if emission.shape[-1] != go.od_lw.shape[-1]:
            if setup.lw_emiss_map is not None:
                band_g = setup.spec.band_from_reordered_g_lw
                emission = emission[:, setup.lw_emiss_map[band_g]]
            else:
                emission = emission[:, setup.spec.band_from_reordered_g_lw]
        go = go._replace(lw_emission=emission)

    ncol, nlev, _ = go.od_lw.shape
    zeros_ssa_lw = jnp.zeros_like(go.od_lw)

    # ---- aerosol merge (clear-sky includes aerosols) ---------------------
    od_lw, ssa_lw, g_lw = go.od_lw, zeros_ssa_lw, zeros_ssa_lw
    od_sw, ssa_sw, g_sw = go.od_sw, go.ssa_sw, jnp.zeros_like(go.od_sw)
    if cfg.use_aerosols and aerosol is not None and \
            setup.aerosol_optics is not None:
        from .optics.aerosol import add_aerosol_optics
        (od_lw, ssa_lw, g_lw, od_sw, ssa_sw, g_sw) = add_aerosol_optics(
            setup, thermodynamics, gas, aerosol,
            od_lw, ssa_lw, g_lw, od_sw, ssa_sw, g_sw)

    # ---- cloud optics -------------------------------------------------------
    # do_clouds (radiation_config.F90:898-900 / interface.F90:317-340):
    # skip cropping + cloud optics entirely when no active spectral
    # region runs a cloud-aware solver
    cloud_props = None
    if cfg.do_clouds and cloud is not None:
        from .optics.cloud import cloud_optics
        if cloud.fractional_std is None:
            cloud = cloud.replace(
                fractional_std=jnp.zeros_like(cloud.fraction))
        if cloud.overlap_param is None:
            cloud = cloud.set_overlap_param(thermodynamics, 2000.0)
        cloud = cloud.crop_cloud_fraction(cfg.cloud_fraction_threshold,
                                          cfg.cloud_mixing_ratio_threshold)
        if cfg.i_gas_model == GasModel.MONOCHROMATIC:
            from .optics.monochromatic import cloud_optics_mono
            cloud_props = cloud_optics_mono(cfg, thermodynamics, cloud)
        else:
            cloud_props = cloud_optics(cfg, setup.cloud_optics,
                                       thermodynamics.pressure_hl,
                                       thermodynamics.temperature_hl,
                                       cloud)

    # ---- solvers ----------------------------------------------------------
    flux = Flux()
    lw_scat_clear = cfg.do_lw_aerosol_scattering and cfg.use_aerosols

    if cfg.do_lw:
        if cfg.i_solver_lw == Solver.CLOUDLESS or cloud_props is None:
            lw, t_clear = solver_cloudless_lw(
                od_lw, ssa_lw, g_lw, go.planck_hl, go.lw_emission,
                lw_albedo, do_scattering=lw_scat_clear, want_trans=True)
            lw_clear = lw
            if cfg.do_lw_derivatives:
                # ICA form on the clear transmittance
                # (radiation_cloudless_lw.F90:166-171)
                from .solvers.lw_derivatives import lw_derivatives_ica
                flux = flux.replace(lw_derivatives=lw_derivatives_ica(
                    t_clear, lw.up[-1].T, gfirst=True))
        else:
            from .solvers.dispatch import solve_lw
            lw, lw_clear, extras_lw = solve_lw(
                setup, single_level, thermodynamics, cloud, cloud_props,
                od_lw, ssa_lw, g_lw, go.planck_hl, go.lw_emission,
                lw_albedo)
        lw_dn_surf_g = _surf_g(lw.dn)
        flux = flux.replace(
            lw_up=_gsum(lw.up), lw_dn=_gsum(lw.dn),
            lw_dn_surf_g=lw_dn_surf_g,
            lw_dn_surf_band=_indexed_band_sum(
                lw_dn_surf_g, setup.spec.band_from_reordered_g_lw, 16),
        )
        if cfg.do_clear:
            flux = flux.replace(
                lw_up_clear=_gsum(lw_clear.up),
                lw_dn_clear=_gsum(lw_clear.dn),
                lw_dn_surf_clear_band=_indexed_band_sum(
                    _surf_g(lw_clear.dn),
                    setup.spec.band_from_reordered_g_lw, 16))
        if cfg.i_solver_lw != Solver.CLOUDLESS and cloud_props is not None:
            flux = flux.replace(**extras_lw)
        if cfg.do_canopy_fluxes_lw:
            lw_dn_surf_g = _surf_g(lw.dn)
            if cfg.use_canopy_full_spectrum_lw:
                canopy = lw_dn_surf_g
            else:
                canopy = _canopy_sum(lw_dn_surf_g,
                                     setup.spec.band_from_reordered_g_lw,
                                     setup.lw_emiss_map,
                                     setup.lw_emiss_weights)
            flux = flux.replace(lw_dn_surf_canopy=canopy)
        if cfg.do_save_spectral_flux:
            # band (or per-g) resolved profiles (radiation_save.F90)
            if cfg.do_save_gpoint_flux:
                spec_map = np.asarray(setup.spec.g_from_reordered_g_lw)
                nspec = len(spec_map)
            else:
                spec_map = setup.spec.band_from_reordered_g_lw
                nspec = 16 if len(spec_map) > 1 else 1
            flux = flux.replace(
                lw_up_band=_band_sum_gfirst(lw.up, spec_map, nspec),
                lw_dn_band=_band_sum_gfirst(lw.dn, spec_map, nspec))
            if cfg.do_clear:
                flux = flux.replace(
                    lw_up_band_clear=_band_sum_gfirst(
                        lw_clear.up, spec_map, nspec),
                    lw_dn_band_clear=_band_sum_gfirst(
                        lw_clear.dn, spec_map, nspec))

    if cfg.do_sw:
        if cfg.i_solver_sw == Solver.CLOUDLESS or cloud_props is None:
            sw = solver_cloudless_sw(od_sw, ssa_sw, g_sw, go.incoming_sw,
                                     single_level.cos_sza, sw_alb_diff,
                                     sw_alb_dir)
            sw_clear = sw
        else:
            from .solvers.dispatch import solve_sw
            sw, sw_clear, extras_sw = solve_sw(
                setup, single_level, thermodynamics, cloud, cloud_props,
                od_sw, ssa_sw, g_sw, go.incoming_sw, sw_alb_diff,
                sw_alb_dir)
        band_g = setup.spec.band_from_reordered_g_sw
        flux = flux.replace(
            sw_up=_gsum(sw.up),
            sw_dn=_gsum(sw.dn_diffuse + sw.dn_direct),
            sw_dn_diffuse_surf_g=_surf_g(sw.dn_diffuse),
            sw_dn_direct_surf_g=_surf_g(sw.dn_direct),
        )
        if cfg.do_sw_direct:
            flux = flux.replace(sw_dn_direct=_gsum(sw.dn_direct))
        if cfg.do_clear:
            flux = flux.replace(
                sw_up_clear=_gsum(sw_clear.up),
                sw_dn_clear=_gsum(sw_clear.dn_diffuse
                                  + sw_clear.dn_direct))
            if cfg.do_sw_direct:
                flux = flux.replace(
                    sw_dn_direct_clear=_gsum(sw_clear.dn_direct))
        if cfg.do_surface_sw_spectral_flux:
            flux = flux.replace(
                sw_dn_surf_band=_indexed_band_sum(
                    _surf_g(sw.dn_diffuse) + _surf_g(sw.dn_direct),
                    band_g, 14),
                sw_dn_direct_surf_band=_indexed_band_sum(
                    _surf_g(sw.dn_direct), band_g, 14),
            )
            if cfg.do_clear:
                flux = flux.replace(
                    sw_dn_surf_clear_band=_indexed_band_sum(
                        _surf_g(sw_clear.dn_diffuse)
                        + _surf_g(sw_clear.dn_direct), band_g, 14),
                    sw_dn_direct_surf_clear_band=_indexed_band_sum(
                        _surf_g(sw_clear.dn_direct), band_g, 14),
                )
        if cfg.i_solver_sw != Solver.CLOUDLESS and cloud_props is not None:
            flux = flux.replace(**extras_sw)
        if cfg.do_canopy_fluxes_sw:
            if cfg.use_canopy_full_spectrum_sw:
                dif_canopy = _surf_g(sw.dn_diffuse)
                dir_canopy = _surf_g(sw.dn_direct)
            else:
                dif_canopy = _canopy_sum(
                    _surf_g(sw.dn_diffuse), band_g,
                    setup.sw_albedo_map, setup.sw_albedo_weights)
                dir_canopy = _canopy_sum(
                    _surf_g(sw.dn_direct), band_g,
                    setup.sw_albedo_map, setup.sw_albedo_weights)
            flux = flux.replace(sw_dn_diffuse_surf_canopy=dif_canopy,
                                sw_dn_direct_surf_canopy=dir_canopy)
        if cfg.do_save_spectral_flux:
            if cfg.do_save_gpoint_flux:
                spec_map = np.asarray(setup.spec.g_from_reordered_g_sw)
                nspec = len(spec_map)
            else:
                spec_map = setup.spec.band_from_reordered_g_sw
                nspec = 14 if len(spec_map) > 1 else 1
            flux = flux.replace(
                sw_up_band=_band_sum_gfirst(sw.up, spec_map, nspec),
                sw_dn_band=_band_sum_gfirst(
                    sw.dn_diffuse + sw.dn_direct, spec_map, nspec),
                sw_dn_direct_band=_band_sum_gfirst(
                    sw.dn_direct, spec_map, nspec))
            if cfg.do_clear:
                flux = flux.replace(
                    sw_up_band_clear=_band_sum_gfirst(
                        sw_clear.up, spec_map, nspec),
                    sw_dn_band_clear=_band_sum_gfirst(
                        sw_clear.dn_diffuse + sw_clear.dn_direct,
                        spec_map, nspec),
                    sw_dn_direct_band_clear=_band_sum_gfirst(
                        sw_clear.dn_direct, spec_map, nspec))

    return flux
