"""RRTMG-IFS gas optics bridge: od/planck/solar per g-point.

Mirrors radiation/radiation_ifs_rrtm.F90 (setup_gas_optics :34, gas_optics
:189, planck_function_atmos :570, planck_function_surf :704): prepares
column densities, runs setcoef + LW/SW taumol, computes Planck source
profiles from the TOTPLNK look-up table and PFRAC, normalizes the incoming
solar flux to the prescribed total solar irradiance, and flips levels back
to ecRad orientation (TOA first).

Outputs use the layout (ncol, nlev, ng) with g innermost.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from ...constants import GAS_INDEX, NG_LW, NG_SW
from .setcoef import prepare_gases, setcoef
from .tables import load_tables
from .taumol_lw import taumol_lw
from .taumol_sw import taumol_sw

FLUXFAC = np.pi * 1.0e4  # radiance->flux conversion (radiation_ifs_rrtm)

# SPARTACUS g-point reorderings by increasing optical depth
# (radiation_ifs_rrtm.F90:49-66), 1-based in the reference.
RRTM_GPOINT_REORDERING_LW = np.array([
    89, 90, 139, 77, 137, 69, 131, 97, 91, 70, 78, 71, 53, 72, 123, 54, 79,
    98, 92, 55, 80, 132, 124, 81, 73, 56, 99, 82, 57, 23, 125, 100, 24, 74,
    93, 58, 25, 83, 126, 75, 26, 11, 101, 133, 59, 27, 76, 140, 12, 84, 102,
    94, 28, 127, 85, 13, 39, 60, 86, 103, 87, 109, 14, 29, 115, 40, 95, 15,
    61, 88, 41, 110, 104, 1, 116, 42, 30, 134, 128, 138, 96, 62, 16, 43,
    117, 63, 111, 44, 2, 64, 31, 65, 105, 17, 45, 66, 118, 32, 3, 33, 67,
    18, 129, 135, 46, 112, 34, 106, 68, 35, 4, 119, 36, 47, 107, 19, 37, 38,
    113, 48, 130, 5, 120, 49, 108, 20, 50, 51, 114, 21, 121, 52, 136, 122,
    6, 22, 7, 8, 9, 10]) - 1
RRTM_GPOINT_REORDERING_SW = np.array([
    35, 45, 19, 27, 36, 57, 20, 46, 58, 21, 28, 67, 55, 68, 37, 1, 69, 22,
    29, 59, 78, 101, 79, 77, 70, 76, 47, 75, 30, 81, 60, 102, 80, 82, 23, 2,
    83, 84, 85, 86, 103, 61, 31, 87, 56, 38, 71, 48, 88, 3, 62, 89, 24, 7,
    49, 32, 104, 72, 90, 63, 39, 4, 8, 50, 91, 64, 40, 33, 25, 51, 95, 96,
    73, 65, 9, 41, 97, 92, 105, 52, 5, 98, 10, 42, 99, 100, 66, 11, 74, 34,
    53, 26, 6, 106, 12, 43, 13, 54, 93, 44, 107, 94, 14, 108, 15, 16, 109,
    17, 18, 110, 111, 112]) - 1

# Band bounds (cm-1), radiation_ifs_rrtm.F90:103-112
WAVENUM1_LW = np.array([10, 350, 500, 630, 700, 820, 980, 1080, 1180, 1390,
                        1480, 1800, 2080, 2250, 2380, 2600], dtype=float)
WAVENUM2_LW = np.array([350, 500, 630, 700, 820, 980, 1080, 1180, 1390,
                        1480, 1800, 2080, 2250, 2380, 2600, 3250],
                       dtype=float)
WAVENUM1_SW = np.array([2600, 3250, 4000, 4650, 5150, 6150, 7700, 8050,
                        12850, 16000, 22650, 29000, 38000, 820], dtype=float)
WAVENUM2_SW = np.array([3250, 4000, 4650, 5150, 6150, 7700, 8050, 12850,
                        16000, 22650, 29000, 38000, 50000, 2600],
                       dtype=float)


class GasOpticsSpec(NamedTuple):
    """Static spectral mapping info derived at setup."""
    band_from_g_lw: np.ndarray        # (140,) 0-based LW band per g
    band_from_g_sw: np.ndarray        # (112,) 0-based SW band per g
    g_from_reordered_g_lw: np.ndarray  # identity or SPARTACUS reordering
    g_from_reordered_g_sw: np.ndarray
    band_from_reordered_g_lw: np.ndarray
    band_from_reordered_g_sw: np.ndarray


def make_spec(reorder_lw: bool = False, reorder_sw: bool = False,
              tables: Optional[dict] = None) -> GasOpticsSpec:
    t = tables or load_tables()
    band_lw = np.asarray(t["lw_band_from_g"]).astype(int) - 1
    band_sw = np.asarray(t["sw_band_from_g"]).astype(int) - 1
    glw = (RRTM_GPOINT_REORDERING_LW if reorder_lw
           else np.arange(NG_LW))
    gsw = (RRTM_GPOINT_REORDERING_SW if reorder_sw
           else np.arange(NG_SW))
    return GasOpticsSpec(
        band_from_g_lw=band_lw, band_from_g_sw=band_sw,
        g_from_reordered_g_lw=glw, g_from_reordered_g_sw=gsw,
        band_from_reordered_g_lw=band_lw[glw],
        band_from_reordered_g_sw=band_sw[gsw],
    )


def _planck_store(temperature, totplnk, delwave):
    """Band-integrated Planck flux at given temperatures.

    temperature: (...,); returns (..., 16).
    Reference: radiation_ifs_rrtm.F90:570-699 (TOTPLNK interpolation).
    """
    t = temperature
    ind = jnp.where((t < 339.0) & (t >= 160.0),
                    jnp.floor(t - 159.0).astype(jnp.int32),
                    jnp.where(t >= 339.0, 180, 1))
    frac = jnp.where((t < 339.0) & (t >= 160.0),
                     t - jnp.floor(t),
                     jnp.where(t >= 339.0, t - 339.0, 0.0))
    tp0 = jnp.take(totplnk, ind - 1, axis=0)      # (..., 16)
    tp1 = jnp.take(totplnk, ind, axis=0)
    planck = tp0 + frac[..., None] * (tp1 - tp0)
    return FLUXFAC * delwave * planck


class GasOptics(NamedTuple):
    """Per-g optical properties, (ncol, nlev, ng), TOA-first levels."""
    od_lw: jnp.ndarray                 # (ncol, nlev, n_g_lw)
    od_sw: jnp.ndarray                 # (ncol, nlev, n_g_sw)
    ssa_sw: jnp.ndarray
    planck_hl: Optional[jnp.ndarray]   # (ncol, nlev+1, n_g_lw)
    lw_emission: Optional[jnp.ndarray]  # (ncol, n_g_lw) surface emission
    incoming_sw: Optional[jnp.ndarray]  # (ncol, n_g_sw) TOA solar per g


def gas_optics(pressure_hl, temperature_hl, gas_mmr, skin_temperature,
               cos_sza, solar_irradiance, spec: GasOpticsSpec,
               tables: Optional[dict] = None,
               lw_albedo: Optional[jnp.ndarray] = None,
               min_gas_od_lw: float = 1.0e-15,
               min_gas_od_sw: float = 0.0,
               spectral_solar_scaling: Optional[jnp.ndarray] = None,
               dtype=jnp.float32) -> GasOptics:
    """Full gas optics (radiation_ifs_rrtm.F90:189-565).

    pressure_hl/temperature_hl: (ncol, nlev+1), TOA first.
    gas_mmr: (ncol, nlev, NUM_GASES) mass mixing ratios.
    lw_albedo: (ncol, n_g_lw) for surface emission (1-albedo)*planck.
    """
    t = tables or load_tables()
    ncol, nlevp1 = pressure_hl.shape
    nlev = nlevp1 - 1

    p_fl = 0.5 * (pressure_hl[:, :-1] + pressure_hl[:, 1:])
    t_fl = 0.5 * (temperature_hl[:, :-1] + temperature_hl[:, 1:])

    def g(name):
        return gas_mmr[:, :, GAS_INDEX[name]]

    gc = prepare_gases(pressure_hl, p_fl, t_fl,
                       g("h2o"), g("co2"), g("ch4"), g("n2o"),
                       g("cfc11"), g("cfc12"), g("hcfc22"), g("ccl4"),
                       g("o3"), dtype=dtype)
    c = setcoef(gc, t["preflog"], t["tref"], t["chi_mls"])

    # ---- LW -------------------------------------------------------------
    # toa_first: outputs in ecRad (TOA-first) level order
    od_lw_rrtm, pfrac = taumol_lw(c, t, toa_first=True)
    od_lw = jnp.maximum(min_gas_od_lw, od_lw_rrtm)
    od_lw = od_lw[:, :, spec.g_from_reordered_g_lw]

    # Planck on half-levels: reference evaluates T at each half level and
    # multiplies by PFRAC of the adjacent layer *below* in its
    # surface-first indexing: planck_hl(g, jlev) uses PFRAC(lev = nlev+2-
    # jlev) for jlev>=2 and PFRAC(nlev) for jlev==1 — i.e. in TOA-first
    # terms, half-level i uses the pfrac of layer min(i, nlev-1).
    totplnk = jnp.asarray(t["totplnk"], dtype)
    delwave = jnp.asarray(t["delwave"], dtype)
    planck_bands = _planck_store(temperature_hl.astype(dtype),
                                 totplnk, delwave)  # (ncol, nlev+1, 16)
    pfrac_toa = pfrac                    # (ncol, nlev, 140) TOA-first
    # layer index per half level: [0, 0, 1, ..., nlev-1] (TOA-first):
    # reference jlev=1 (TOA in its reversed output) uses layer nlev
    # (surface-first) == TOA-first layer 0; others use the layer above.
    lay_idx = np.concatenate([[0], np.arange(nlev)])
    pfrac_hl = pfrac_toa[:, lay_idx, :]  # (ncol, nlev+1, 140)
    band_map = spec.band_from_g_lw
    planck_hl = (planck_bands[:, :, band_map[spec.g_from_reordered_g_lw]]
                 * pfrac_hl[:, :, spec.g_from_reordered_g_lw])

    # Surface emission: Planck(Tskin) x PFRAC(surface layer) x (1-albedo)
    planck_surf_bands = _planck_store(skin_temperature.astype(dtype),
                                      totplnk, delwave)  # (ncol, 16)
    pfrac_surf = pfrac[:, -1, :]         # surface layer (TOA-first)
    planck_surf = (planck_surf_bands[:, band_map[spec.g_from_reordered_g_lw]]
                   * pfrac_surf[:, spec.g_from_reordered_g_lw])
    if lw_albedo is not None:
        lw_emission = planck_surf * (1.0 - lw_albedo)
    else:
        lw_emission = planck_surf

    # ---- SW -------------------------------------------------------------
    taug, taur, sflux = taumol_sw(c, t, toa_first=True)
    od_sw_rrtm = taug + taur
    # clip: a reciprocal-based division can return values an ulp above 1
    ssa_sw_rrtm = jnp.clip(taur / jnp.maximum(od_sw_rrtm, 1e-30), 0.0, 1.0)
    od_sw = jnp.maximum(min_gas_od_sw, od_sw_rrtm)
    ssa_sw = ssa_sw_rrtm
    od_sw = od_sw[:, :, spec.g_from_reordered_g_sw]
    ssa_sw = ssa_sw[:, :, spec.g_from_reordered_g_sw]

    if spectral_solar_scaling is not None:
        sflux = sflux * jnp.asarray(spectral_solar_scaling, dtype)[
            spec.band_from_g_sw]

    # normalize to solar irradiance (radiation_ifs_rrtm.F90:519-526)
    total = sflux.sum(axis=-1)
    scale = jnp.where(cos_sza > 0.0,
                      solar_irradiance / jnp.maximum(total, 1e-10), 1.0)
    incoming_sw = (scale[:, None] * sflux)[:, spec.g_from_reordered_g_sw]

    return GasOptics(od_lw=od_lw, od_sw=od_sw, ssa_sw=ssa_sw,
                     planck_hl=planck_hl, lw_emission=lw_emission,
                     incoming_sw=incoming_sw)
