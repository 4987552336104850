"""Core data model: pytree dataclasses for atmospheric inputs and flux outputs.

These mirror the *capabilities* of the reference derived types
(radiation/radiation_{single_level,thermodynamics,gas,cloud,aerosol,
flux}.F90) as structure-of-arrays: columns are the leading (shardable)
batch dim, levels next, spectral (band/g) innermost.

All fields are jnp arrays (or None); every class is a JAX pytree and can be
passed through jit/vmap/pjit boundaries.
"""
from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
from .pytree import pytree_dataclass, static_field

from .constants import (
    ACCEL_DUE_TO_GRAVITY,
    GAS_INDEX,
    GAS_MOLAR_MASS,
    MOLAR_MASS_DRY_AIR,
    NUM_GASES,
)

# Gas concentration units (reference: radiation/radiation_gas.F90:60-66)
IMassMixingRatio = 0
IVolumeMixingRatio = 1


@pytree_dataclass
class SingleLevel:
    """Surface / single-level quantities.

    Reference parity: radiation/radiation_single_level.F90:29-90.
    """
    cos_sza: jnp.ndarray                      # (ncol,)
    skin_temperature: jnp.ndarray             # (ncol,)
    sw_albedo: jnp.ndarray                    # (ncol, n_albedo_bands)
    lw_emissivity: jnp.ndarray                # (ncol, n_emiss_bands)
    sw_albedo_direct: Optional[jnp.ndarray] = None   # (ncol, n_albedo_bands)
    # Pre-computed surface LW emission (W m-2) from a tiled/canopy surface
    # (radiation_single_level.F90:55; set by the radsurf-equivalent
    # boundary-condition pass). When present it overrides the
    # Planck(Tskin)x(1-albedo) emission inside gas optics
    # (radiation_ifs_rrtm.F90:436-443).
    lw_emission: Optional[jnp.ndarray] = None        # (ncol, n_emiss_bands)
    solar_irradiance: float = 1366.0
    spectral_solar_scaling: Optional[jnp.ndarray] = None  # (nbands_sw,)
    iseed: Optional[jnp.ndarray] = None       # (ncol,) int32 per-column seed

    @property
    def ncol(self) -> int:
        return self.cos_sza.shape[0]


@pytree_dataclass
class Thermodynamics:
    """Pressure/temperature on half-levels.

    Reference parity: radiation/radiation_thermodynamics.F90:29-47.
    """
    pressure_hl: jnp.ndarray      # (ncol, nlev+1)
    temperature_hl: jnp.ndarray   # (ncol, nlev+1)
    h2o_sat_liq: Optional[jnp.ndarray] = None  # (ncol, nlev) saturation MMR

    @property
    def nlev(self) -> int:
        return self.pressure_hl.shape[1] - 1

    def pressure_fl(self) -> jnp.ndarray:
        """Full-level pressure = mean of adjacent half-levels."""
        return 0.5 * (self.pressure_hl[:, :-1] + self.pressure_hl[:, 1:])

    def temperature_fl(self) -> jnp.ndarray:
        return 0.5 * (self.temperature_hl[:, :-1] + self.temperature_hl[:, 1:])

    def layer_mass(self) -> jnp.ndarray:
        """Mass of each layer (kg m-2) = dp/g.

        Reference parity: radiation_thermodynamics.F90:164 (get_layer_mass).
        """
        dp = self.pressure_hl[:, 1:] - self.pressure_hl[:, :-1]
        return jnp.abs(dp) * (1.0 / ACCEL_DUE_TO_GRAVITY)

    def calc_saturation_wrt_liquid(self) -> "Thermodynamics":
        """Simple Clausius-Clapeyron saturation MMR w.r.t. liquid water.

        Reference parity: radiation_thermodynamics.F90:118-161.
        """
        t = self.temperature_fl()
        p = self.pressure_fl()
        e_sat = 6.11e2 * jnp.exp(17.269 * (t - 273.16) / (t - 35.86))
        mmr = jnp.minimum(1.0, 0.622 * e_sat / jnp.maximum(p, 1.0))
        return self.replace(h2o_sat_liq=mmr)


@pytree_dataclass
class GasConcs:
    """Gas mixing ratios, (ncol, nlev, NUM_GASES) cube.

    Values are stored as *mass* mixing ratios internally (the reference
    tracks per-gas units and converts on demand; we normalize at ingest:
    radiation/radiation_gas.F90:382 set_units).
    """
    mixing_ratio: jnp.ndarray  # (ncol, nlev, NUM_GASES) MMR
    # static metadata: which gases are present (python bools; not traced)
    is_present: tuple = static_field((False,) * NUM_GASES)

    @classmethod
    def create(cls, ncol: int, nlev: int, dtype=jnp.float32) -> "GasConcs":
        return cls(mixing_ratio=jnp.zeros((ncol, nlev, NUM_GASES), dtype))

    def put(self, gas: str, mmr: jnp.ndarray) -> "GasConcs":
        """Set one gas from a (ncol, nlev) MMR field."""
        i = GAS_INDEX[gas]
        present = list(self.is_present)
        present[i] = True
        return self.replace(
            mixing_ratio=self.mixing_ratio.at[:, :, i].set(mmr),
            is_present=tuple(present),
        )

    def put_vmr(self, gas: str, vmr: jnp.ndarray) -> "GasConcs":
        """Set one gas from volume mixing ratio (mol/mol)."""
        scale = GAS_MOLAR_MASS[gas] / MOLAR_MASS_DRY_AIR
        return self.put(gas, vmr * scale)

    def put_well_mixed(self, gas: str, mmr: float, ncol: int, nlev: int
                       ) -> "GasConcs":
        return self.put(gas, jnp.full((ncol, nlev), mmr,
                                      self.mixing_ratio.dtype))

    def put_well_mixed_vmr(self, gas: str, vmr: float, ncol: int, nlev: int
                           ) -> "GasConcs":
        scale = GAS_MOLAR_MASS[gas] / MOLAR_MASS_DRY_AIR
        return self.put_well_mixed(gas, vmr * scale, ncol, nlev)

    def scale(self, gas: str, factor: float) -> "GasConcs":
        i = GAS_INDEX[gas]
        return self.replace(
            mixing_ratio=self.mixing_ratio.at[:, :, i].multiply(factor))

    def get(self, gas: str) -> jnp.ndarray:
        return self.mixing_ratio[:, :, GAS_INDEX[gas]]

    def get_vmr(self, gas: str) -> jnp.ndarray:
        scale = MOLAR_MASS_DRY_AIR / GAS_MOLAR_MASS[gas]
        return self.get(gas) * scale


@pytree_dataclass
class Cloud:
    """Cloud water/ice content, effective sizes, fraction & heterogeneity.

    Reference parity: radiation/radiation_cloud.F90:32-88.
    """
    q_liq: jnp.ndarray      # (ncol, nlev) liquid MMR
    q_ice: jnp.ndarray      # (ncol, nlev) ice MMR
    re_liq: jnp.ndarray     # (ncol, nlev) liquid effective radius (m)
    re_ice: jnp.ndarray     # (ncol, nlev) ice effective radius (m)
    fraction: jnp.ndarray   # (ncol, nlev)
    fractional_std: Optional[jnp.ndarray] = None        # (ncol, nlev)
    overlap_param: Optional[jnp.ndarray] = None         # (ncol, nlev-1)
    inv_cloud_effective_size: Optional[jnp.ndarray] = None  # (ncol, nlev) m-1
    inv_inhom_effective_size: Optional[jnp.ndarray] = None  # (ncol, nlev) m-1

    @classmethod
    def create_zero(cls, ncol: int, nlev: int, dtype=jnp.float32) -> "Cloud":
        z = jnp.zeros((ncol, nlev), dtype)
        return cls(q_liq=z, q_ice=z, re_liq=z + 1.0e-5, re_ice=z + 5.0e-5,
                   fraction=z)

    def set_overlap_param(self, thermodynamics: Thermodynamics,
                          decorrelation_length: float) -> "Cloud":
        """Exponential overlap parameter from decorrelation length (m).

        alpha = exp(-dz / L) with dz the separation of layer midpoints,
        computed hydrostatically from pressure & temperature.
        Reference parity: radiation_cloud.F90:166-252 (set_overlap_param).
        """
        p = thermodynamics.pressure_hl
        t = thermodynamics.temperature_hl
        r_over_g = 287.0 / ACCEL_DUE_TO_GRAVITY
        # Height of half-levels above the surface via hypsometric equation
        # integrated layer by layer (top = index 0, surface = index nlev).
        p_safe = jnp.maximum(p, 1.0)
        dz = r_over_g * 0.5 * (t[:, :-1] + t[:, 1:]) * jnp.log(
            p_safe[:, 1:] / p_safe[:, :-1])  # (ncol, nlev) layer thickness
        # Mid-point separation between adjacent layers:
        sep = 0.5 * (dz[:, :-1] + dz[:, 1:])
        alpha = jnp.exp(-jnp.abs(sep) / decorrelation_length)
        return self.replace(overlap_param=alpha)

    def create_inv_cloud_effective_size_eta(
            self, thermodynamics: Thermodynamics,
            inv_eff_size_low: float, inv_eff_size_mid: float,
            inv_eff_size_high: float, eta_low_mid: float,
            eta_mid_high: float) -> "Cloud":
        """Inverse effective cloud size by eta band
        (radiation_cloud.F90:398-460)."""
        p_hl = thermodynamics.pressure_hl
        eta = (p_hl[:, :-1] + p_hl[:, 1:]) * (0.5 / p_hl[:, -1:])
        inv = jnp.where(eta > eta_low_mid, inv_eff_size_low,
                        jnp.where(eta > eta_mid_high, inv_eff_size_mid,
                                  inv_eff_size_high))
        return self.replace(inv_cloud_effective_size=inv)

    def param_cloud_effective_separation_eta(
            self, thermodynamics: Thermodynamics, separation_surf: float,
            separation_toa: float, power: float = 1.0,
            inhom_separation_factor: float = 1.0) -> "Cloud":
        """Effective cloud separation parameterization in eta
        (radiation_cloud.F90:476-...; the CY47R1 driver's
        cloud_separation_scale_* namelist options)."""
        p_hl = thermodynamics.pressure_hl
        eta = (p_hl[:, :-1] + p_hl[:, 1:]) * (0.5 / p_hl[:, -1:])
        coeff_e = 1.0 - jnp.exp(-1.0)
        coeff_b = (separation_toa - separation_surf) / coeff_e
        coeff_a = separation_toa - coeff_b
        eff_sep = coeff_a + coeff_b * jnp.exp(-eta ** power)
        f = self.fraction
        inv_cloud = 1.0 / (eff_sep * jnp.sqrt(
            jnp.maximum(1.0e-5, f * (1.0 - f))))
        inv_inhom = 1.0 / (eff_sep * inhom_separation_factor * jnp.sqrt(
            jnp.maximum(1.0e-5, 0.5 * f * (1.0 - 0.5 * f))))
        return self.replace(inv_cloud_effective_size=inv_cloud,
                            inv_inhom_effective_size=inv_inhom)

    def crop_cloud_fraction(self, cloud_fraction_threshold: float = 1.0e-6,
                            cloud_mixing_ratio_threshold: float = 1.0e-9
                            ) -> "Cloud":
        """Zero-out negligible clouds (reference: radiation_cloud.F90:560+)."""
        total_q = self.q_liq + self.q_ice
        keep = ((self.fraction > cloud_fraction_threshold)
                & (total_q > cloud_mixing_ratio_threshold))
        return self.replace(
            fraction=jnp.where(keep, self.fraction, 0.0),
            q_liq=jnp.where(keep, self.q_liq, 0.0),
            q_ice=jnp.where(keep, self.q_ice, 0.0),
        )


@pytree_dataclass
class Aerosol:
    """Aerosol mass mixing ratios, (ncol, nlev, ntype).

    Reference parity: radiation/radiation_aerosol.F90:28-56. The reference
    stores a vertical slice [istartlev:iendlev]; we keep full nlev with
    zeros outside for static shapes, recording the active range statically.
    """
    mixing_ratio: jnp.ndarray  # (ncol, nlev, ntype)
    istartlev: int = static_field(0)
    iendlev: int = static_field(-1)

    # Optional direct optical-property input (od/ssa/g per band), the
    # reference's 'aerosol_optics direct' pathway.
    od_sw: Optional[jnp.ndarray] = None
    ssa_sw: Optional[jnp.ndarray] = None
    g_sw: Optional[jnp.ndarray] = None
    od_lw: Optional[jnp.ndarray] = None
    ssa_lw: Optional[jnp.ndarray] = None


@pytree_dataclass
class Flux:
    """Output fluxes on half-levels (W m-2).

    Reference parity: radiation/radiation_flux.F90:34-98.
    All arrays (ncol, nlev+1) unless noted.
    """
    lw_up: Optional[jnp.ndarray] = None
    lw_dn: Optional[jnp.ndarray] = None
    sw_up: Optional[jnp.ndarray] = None
    sw_dn: Optional[jnp.ndarray] = None
    sw_dn_direct: Optional[jnp.ndarray] = None
    lw_up_clear: Optional[jnp.ndarray] = None
    lw_dn_clear: Optional[jnp.ndarray] = None
    sw_up_clear: Optional[jnp.ndarray] = None
    sw_dn_clear: Optional[jnp.ndarray] = None
    sw_dn_direct_clear: Optional[jnp.ndarray] = None
    # Surface spectral (band-resolved) fluxes: (ncol, nbands)
    lw_dn_surf_band: Optional[jnp.ndarray] = None
    lw_dn_surf_clear_band: Optional[jnp.ndarray] = None
    sw_dn_surf_band: Optional[jnp.ndarray] = None
    sw_dn_direct_surf_band: Optional[jnp.ndarray] = None
    sw_dn_surf_clear_band: Optional[jnp.ndarray] = None
    sw_dn_direct_surf_clear_band: Optional[jnp.ndarray] = None
    # Per-g surface downwelling (needed by canopy / diagnostics): (ncol, ng)
    lw_dn_surf_g: Optional[jnp.ndarray] = None
    sw_dn_diffuse_surf_g: Optional[jnp.ndarray] = None
    sw_dn_direct_surf_g: Optional[jnp.ndarray] = None
    # Downwelling at canopy top at the spectral resolution of the canopy
    # scheme (per-g when use_canopy_full_spectrum_*, else albedo/emissivity
    # intervals; radiation_flux.F90:377-450): (ncol, n_canopy_bands)
    lw_dn_surf_canopy: Optional[jnp.ndarray] = None
    sw_dn_diffuse_surf_canopy: Optional[jnp.ndarray] = None
    sw_dn_direct_surf_canopy: Optional[jnp.ndarray] = None
    # Diagnostics
    cloud_cover_lw: Optional[jnp.ndarray] = None  # (ncol,)
    cloud_cover_sw: Optional[jnp.ndarray] = None  # (ncol,)
    lw_derivatives: Optional[jnp.ndarray] = None  # (ncol, nlev+1)
    # Band-resolved profile fluxes (optional diagnostics): (ncol,nlev+1,nb)
    lw_up_band: Optional[jnp.ndarray] = None
    lw_dn_band: Optional[jnp.ndarray] = None
    sw_up_band: Optional[jnp.ndarray] = None
    sw_dn_band: Optional[jnp.ndarray] = None
    sw_dn_direct_band: Optional[jnp.ndarray] = None
    # clear-sky counterparts (radiation_save.F90 spectral_flux_*_clear)
    lw_up_band_clear: Optional[jnp.ndarray] = None
    lw_dn_band_clear: Optional[jnp.ndarray] = None
    sw_up_band_clear: Optional[jnp.ndarray] = None
    sw_dn_band_clear: Optional[jnp.ndarray] = None
    sw_dn_direct_band_clear: Optional[jnp.ndarray] = None
    # SPARTACUS entrapment internals (do_print_entrapment_data; the
    # reference's PRINT_ENTRAPMENT_DATA compile flag, Makefile:54-60):
    # (x_direct, x_diffuse, direct_dn, flux_dn), each (nlev, nreg,
    # ncol) at g-point 1 (radiation_spartacus_sw.F90:1007-1020,
    # :1486-1497)
    entrapment_data: Optional[tuple] = None

    def net_lw(self) -> jnp.ndarray:
        return self.lw_dn - self.lw_up

    def net_sw(self) -> jnp.ndarray:
        return self.sw_dn - self.sw_up

    def heating_rate_lw(self, thermodynamics: Thermodynamics) -> jnp.ndarray:
        return _heating_rate(self.net_lw(), thermodynamics)

    def heating_rate_sw(self, thermodynamics: Thermodynamics) -> jnp.ndarray:
        return _heating_rate(self.net_sw(), thermodynamics)


def _heating_rate(net_flux: jnp.ndarray, thermo: Thermodynamics
                  ) -> jnp.ndarray:
    """Heating rate in K/day = -(g/cp) dFnet/dp.

    Reference parity: practical/ecradplot/io.py:73-78.
    """
    from .constants import SPECIFIC_HEAT_DRY_AIR
    dfnet = net_flux[:, 1:] - net_flux[:, :-1]
    dp = thermo.pressure_hl[:, 1:] - thermo.pressure_hl[:, :-1]
    g_over_cp = ACCEL_DUE_TO_GRAVITY / SPECIFIC_HEAT_DRY_AIR
    return -g_over_cp * dfnet / dp * 86400.0
