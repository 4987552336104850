"""Cloud optical properties: liquid & ice models + band-space assembly.

Reference parity:
  - driver/dispatch: radiation/radiation_cloud_optics.F90:200-491
  - SOCRATES liquid Pade fits: radiation_liquid_optics_socrates.F90:40-77
  - Slingo SW / Lindner-Li LW: radiation_liquid_optics_slingo.F90
  - Fu-IFS ice (incl. the deliberate do_fu_lw_ice_optics_bug switch):
    radiation_ice_optics_fu.F90
  - Baran / Baran2016 / Baran2017 ice: radiation_ice_optics_baran*.F90
  - Yi ice LUT: radiation_ice_optics_yi.F90
  - delta-Eddington: radiation_delta_eddington.h

Everything is vectorized over (ncol, nlev) with bands innermost. In-cloud
water paths use dp/(g * cloud_fraction) except for the Homogeneous solver
(dp/g).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax.numpy as jnp

import numpy as np

from ..config import IceModel, LiquidModel, RadiationConfig, Solver
from ..constants import ACCEL_DUE_TO_GRAVITY
from ..io.netcdf import NetcdfFile

MAX_ASYMMETRY = 1.0 - 1.2e-7
FU_MAX_EFFECTIVE_RADIUS = 100.0e-6
YI_NSINGLE = 23


@dataclass
class CloudOpticsTables:
    """LUT coefficients, numpy (nband, ncoeff)."""
    liq_coeff_lw: np.ndarray
    liq_coeff_sw: np.ndarray
    ice_coeff_lw: np.ndarray
    ice_coeff_sw: np.ndarray
    ice_coeff_gen: Optional[np.ndarray] = None


def setup_cloud_optics(config: RadiationConfig) -> CloudOpticsTables:
    """Load the droplet & ice scattering LUTs
    (radiation_cloud_optics_data.F90:48-108)."""
    with NetcdfFile(config.liq_optics_file) as f:
        liq_lw = f.read("coeff_lw")
        liq_sw = f.read("coeff_sw")
    with NetcdfFile(config.ice_optics_file) as f:
        ice_lw = f.read("coeff_lw")
        ice_sw = f.read("coeff_sw")
        gen = f.read("coeff_gen") if f.exists("coeff_gen") else None
    return CloudOpticsTables(liq_coeff_lw=liq_lw, liq_coeff_sw=liq_sw,
                             ice_coeff_lw=ice_lw, ice_coeff_sw=ice_sw,
                             ice_coeff_gen=gen)


# ---------------------------------------------------------------------------
# delta-Eddington (radiation_delta_eddington.h)
# ---------------------------------------------------------------------------

def delta_eddington(od, ssa, g):
    """Intensive form."""
    f = g * g
    od_new = od * (1.0 - ssa * f)
    ssa_new = ssa * (1.0 - f) / (1.0 - ssa * f)
    g_new = g / (1.0 + g)
    return od_new, ssa_new, g_new


def delta_eddington_scat_od(od, scat_od, g):
    """Extensive form on (od, scat_od, g)."""
    f = g * g
    od_new = od - scat_od * f
    scat_new = scat_od * (1.0 - f)
    g_new = g / (1.0 + g)
    return od_new, scat_new, g_new


def delta_eddington_extensive(od, scat_od, scat_od_g):
    g = jnp.where(scat_od > 0.0, scat_od_g / jnp.maximum(scat_od, 1e-30),
                  0.0)
    f = g * g
    od_new = od - scat_od * f
    scat_new = scat_od * (1.0 - f)
    scat_od_g_new = scat_new * g / (1.0 + g)
    return od_new, scat_new, scat_od_g_new


# ---------------------------------------------------------------------------
# per-model optics: wp/re/qi (..., 1) broadcasting against coeff (nb, k)
# ---------------------------------------------------------------------------

def _c(coeff, i, dtype):
    """1-based Fortran coefficient column -> (nb,) jnp array."""
    return jnp.asarray(coeff[:, i - 1], dtype)


def liq_socrates(coeff, lwp, re, dtype=jnp.float32):
    """SOCRATES Pade fits in re (radiation_liquid_optics_socrates.F90)."""
    lwp = lwp[..., None]
    re = re[..., None]
    c = lambda i: _c(coeff, i, dtype)
    od = lwp * (c(1) + re * (c(2) + re * c(3))) / (
        1.0 + re * (c(4) + re * (c(5) + re * c(6))))
    scat_od = od * (1.0 - (c(7) + re * (c(8) + re * c(9)))
                    / (1.0 + re * (c(10) + re * c(11))))
    g = (c(12) + re * (c(13) + re * c(14))) / (
        1.0 + re * (c(15) + re * c(16)))
    return od, scat_od, g


def liq_slingo_sw(coeff, lwp, re, dtype=jnp.float32):
    lwp_gm2 = lwp[..., None] * 1000.0
    re_um = jnp.clip(re[..., None] * 1.0e6, 4.2, 16.6)
    inv = 1.0 / re_um
    c = lambda i: _c(coeff, i, dtype)
    od = lwp_gm2 * (c(1) + inv * c(2))
    scat_od = od * (1.0 - c(3) - re_um * c(4))
    g = c(5) + re_um * c(6)
    return od, scat_od, g


def liq_lindner_li_lw(coeff, lwp, re, dtype=jnp.float32):
    lwp_gm2 = lwp[..., None] * 1000.0
    re_um = jnp.clip(re[..., None] * 1.0e6, 2.0, 40.0)
    inv = 1.0 / re_um
    c = lambda i: _c(coeff, i, dtype)
    od = lwp_gm2 * (c(1) + re_um * c(2)
                    + inv * (c(3) + inv * (c(4) + inv * c(5))))
    scat_od = od * (1.0 - (c(6) + inv * c(7)
                           + re_um * (c(8) + re_um * c(9))))
    g = c(10) + inv * c(11) + re_um * (c(12) + re_um * c(13))
    return od, scat_od, g


def ice_fu_sw(coeff, iwp, re, dtype=jnp.float32):
    de_um = jnp.minimum(re[..., None], FU_MAX_EFFECTIVE_RADIUS) * (
        1.0e6 / 0.64952)
    inv = 1.0 / de_um
    iwp_gm2 = iwp[..., None] * 1000.0
    c = lambda i: _c(coeff, i, dtype)
    od = iwp_gm2 * (c(1) + c(2) * inv)
    scat_od = od * (1.0 - (c(3) + de_um * (c(4) + de_um * (
        c(5) + de_um * c(6)))))
    g = jnp.minimum(c(7) + de_um * (c(8) + de_um * (c(9) + de_um * c(10))),
                    MAX_ASYMMETRY)
    return od, scat_od, g


def ice_fu_lw(coeff, iwp, re, dtype=jnp.float32):
    de_um = jnp.minimum(re[..., None], FU_MAX_EFFECTIVE_RADIUS) * (
        1.0e6 / 0.64952)
    inv = 1.0 / de_um
    iwp_gm2 = iwp[..., None] * 1000.0
    c = lambda i: _c(coeff, i, dtype)
    od = iwp_gm2 * (c(1) + inv * (c(2) + inv * c(3)))
    scat_od = od - iwp_gm2 * inv * (c(4) + de_um * (
        c(5) + de_um * (c(6) + de_um * c(7))))
    g = jnp.minimum(c(8) + de_um * (c(9) + de_um * (c(10)
                                                    + de_um * c(11))),
                    MAX_ASYMMETRY)
    return od, scat_od, g


def ice_baran(coeff, iwp, qi, dtype=jnp.float32):
    iwp = iwp[..., None]
    qi = qi[..., None]
    c = lambda i: _c(coeff, i, dtype)
    od = iwp * (c(1) + c(2) / (1.0 + qi * c(3)))
    scat_od = od * (c(4) + c(5) / (1.0 + qi * c(6)))
    g = c(7) + c(8) / (1.0 + qi * c(9))
    return od, scat_od, g


def ice_baran2016(coeff, iwp, qi, temperature, dtype=jnp.float32):
    iwp = iwp[..., None]
    t = temperature[..., None]
    qi_capped = jnp.minimum(qi[..., None], 1.0e-3)
    qi_t = qi_capped * t
    t2 = t * t
    qi_over_t4 = 1.0 / (t2 * t2)
    c = lambda i: _c(coeff, i, dtype)
    od = iwp * c(1) * qi_over_t4
    scat_od = od * (c(2) + c(3) * qi_t)
    g = c(4) + c(5) * qi_t
    return od, scat_od, g


def ice_baran2017(coeff_gen, coeff, iwp, qi, temperature,
                  dtype=jnp.float32):
    iwp = iwp[..., None]
    qi = qi[..., None]
    t = temperature[..., None]
    gen = np.asarray(coeff_gen)
    qi_mod = qi * jnp.exp(gen[0] * (t - gen[1]))
    qi_mod_od = qi_mod ** gen[2]
    qi_mod_ssa = qi_mod ** gen[3]
    qi_mod_g = qi_mod ** gen[4]
    c = lambda i: _c(coeff, i, dtype)
    od = iwp * (c(1) + c(2) / (1.0 + qi_mod_od * c(3)))
    scat_od = od * (c(4) + c(5) / (1.0 + qi_mod_ssa * c(6)))
    g = c(7) + c(8) / (1.0 + qi_mod_g * c(9))
    return od, scat_od, g


def ice_yi(coeff, iwp, re, dtype=jnp.float32):
    """Yi et al. LUT in effective diameter, 23 size bins
    (radiation_ice_optics_yi.F90)."""
    de_um = jnp.clip(re[..., None] * 2.0e6, 10.0, 119.99)
    iwp_gm2 = iwp[..., None] * 1000.0
    pos = de_um * 0.2 - 1.0
    idx = jnp.floor(pos).astype(jnp.int32)  # 1-based Fortran column
    w2 = pos - idx
    w1 = 1.0 - w2
    # gather along coeff axis: tabT is (69, nb); index rows
    tabT = jnp.asarray(coeff.T, dtype)

    def sample(base_off):
        i0 = jnp.clip(idx[..., 0] + base_off - 1, 0, tabT.shape[0] - 2)
        v1 = jnp.take(tabT, i0, axis=0)
        v2 = jnp.take(tabT, i0 + 1, axis=0)
        return w1 * v1 + w2 * v2

    od = 0.001 * iwp_gm2 * sample(0)
    scat_od = od * sample(YI_NSINGLE)
    g = sample(2 * YI_NSINGLE)
    return od, scat_od, g


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def cloud_optics(config: RadiationConfig, tables: CloudOpticsTables,
                 pressure_hl, temperature_hl, cloud,
                 dtype=jnp.float32) -> Tuple:
    """Per-band cloud optical properties.

    Returns (od_lw, ssa_lw, g_lw, od_sw, ssa_sw, g_sw), each
    (ncol, nlev, nbands). When do_lw_cloud_scattering is off, ssa_lw/g_lw
    are zeros and od_lw is the absorption optical depth.
    """
    frac = cloud.fraction
    is_homogeneous = (config.i_solver_sw == Solver.HOMOGENEOUS
                      and config.i_solver_lw == Solver.HOMOGENEOUS)
    dp = pressure_hl[:, 1:] - pressure_hl[:, :-1]
    denom = ACCEL_DUE_TO_GRAVITY * (
        jnp.ones_like(frac) if is_homogeneous
        else jnp.maximum(frac, 1e-12))
    factor = dp / denom
    incloud = frac > 0.0
    lwp = jnp.where(incloud, factor * cloud.q_liq, 0.0)
    iwp = jnp.where(incloud, factor * cloud.q_ice, 0.0)

    # ---- liquid ----------------------------------------------------------
    if config.i_liq_model == LiquidModel.SOCRATES:
        od_lw_liq, scat_lw_liq, g_lw_liq = liq_socrates(
            tables.liq_coeff_lw, lwp, cloud.re_liq, dtype)
        od_sw_liq, scat_sw_liq, g_sw_liq = liq_socrates(
            tables.liq_coeff_sw, lwp, cloud.re_liq, dtype)
    elif config.i_liq_model == LiquidModel.SLINGO:
        od_lw_liq, scat_lw_liq, g_lw_liq = liq_lindner_li_lw(
            tables.liq_coeff_lw, lwp, cloud.re_liq, dtype)
        od_sw_liq, scat_sw_liq, g_sw_liq = liq_slingo_sw(
            tables.liq_coeff_sw, lwp, cloud.re_liq, dtype)
    else:
        raise NotImplementedError(config.i_liq_model)
    has_liq = (lwp > 0.0)[..., None]
    od_lw_liq = jnp.where(has_liq, od_lw_liq, 0.0)
    scat_lw_liq = jnp.where(has_liq, scat_lw_liq, 0.0)
    g_lw_liq = jnp.where(has_liq, g_lw_liq, 0.0)
    od_sw_liq = jnp.where(has_liq, od_sw_liq, 0.0)
    scat_sw_liq = jnp.where(has_liq, scat_sw_liq, 0.0)
    g_sw_liq = jnp.where(has_liq, g_sw_liq, 0.0)
    if not config.do_sw_delta_scaling_with_gases:
        od_sw_liq, scat_sw_liq, g_sw_liq = delta_eddington_scat_od(
            od_sw_liq, scat_sw_liq, g_sw_liq)

    # ---- ice ---------------------------------------------------------------
    t_fl = 0.5 * (temperature_hl[:, :-1] + temperature_hl[:, 1:])
    if config.i_ice_model == IceModel.FU:
        od_lw_ice, scat_lw_ice, g_lw_ice = ice_fu_lw(
            tables.ice_coeff_lw, iwp, cloud.re_ice, dtype)
        if config.do_fu_lw_ice_optics_bug:
            scat_lw_ice = od_lw_ice - scat_lw_ice
        od_sw_ice, scat_sw_ice, g_sw_ice = ice_fu_sw(
            tables.ice_coeff_sw, iwp, cloud.re_ice, dtype)
    elif config.i_ice_model == IceModel.BARAN:
        od_lw_ice, scat_lw_ice, g_lw_ice = ice_baran(
            tables.ice_coeff_lw, iwp, cloud.q_ice, dtype)
        od_sw_ice, scat_sw_ice, g_sw_ice = ice_baran(
            tables.ice_coeff_sw, iwp, cloud.q_ice, dtype)
    elif config.i_ice_model == IceModel.BARAN2016:
        od_lw_ice, scat_lw_ice, g_lw_ice = ice_baran2016(
            tables.ice_coeff_lw, iwp, cloud.q_ice, t_fl, dtype)
        od_sw_ice, scat_sw_ice, g_sw_ice = ice_baran2016(
            tables.ice_coeff_sw, iwp, cloud.q_ice, t_fl, dtype)
    elif config.i_ice_model == IceModel.BARAN2017:
        od_lw_ice, scat_lw_ice, g_lw_ice = ice_baran2017(
            tables.ice_coeff_gen, tables.ice_coeff_lw, iwp, cloud.q_ice,
            t_fl, dtype)
        od_sw_ice, scat_sw_ice, g_sw_ice = ice_baran2017(
            tables.ice_coeff_gen, tables.ice_coeff_sw, iwp, cloud.q_ice,
            t_fl, dtype)
    elif config.i_ice_model == IceModel.YI:
        od_lw_ice, scat_lw_ice, g_lw_ice = ice_yi(
            tables.ice_coeff_lw, iwp, cloud.re_ice, dtype)
        od_sw_ice, scat_sw_ice, g_sw_ice = ice_yi(
            tables.ice_coeff_sw, iwp, cloud.re_ice, dtype)
    else:
        raise NotImplementedError(config.i_ice_model)
    has_ice = (iwp > 0.0)[..., None]
    od_lw_ice = jnp.where(has_ice, od_lw_ice, 0.0)
    scat_lw_ice = jnp.where(has_ice, scat_lw_ice, 0.0)
    g_lw_ice = jnp.where(has_ice, g_lw_ice, 0.0)
    od_sw_ice = jnp.where(has_ice, od_sw_ice, 0.0)
    scat_sw_ice = jnp.where(has_ice, scat_sw_ice, 0.0)
    g_sw_ice = jnp.where(has_ice, g_sw_ice, 0.0)
    if not config.do_sw_delta_scaling_with_gases:
        od_sw_ice, scat_sw_ice, g_sw_ice = delta_eddington_scat_od(
            od_sw_ice, scat_sw_ice, g_sw_ice)
    od_lw_ice, scat_lw_ice, g_lw_ice = delta_eddington_scat_od(
        od_lw_ice, scat_lw_ice, g_lw_ice)

    # ---- combine liquid + ice --------------------------------------------
    cloudy = incloud[..., None]
    od_sw = jnp.where(cloudy, od_sw_liq + od_sw_ice, 0.0)
    scat_sw = scat_sw_liq + scat_sw_ice
    g_sw = jnp.where(cloudy & (scat_sw > 0.0),
                     (g_sw_liq * scat_sw_liq + g_sw_ice * scat_sw_ice)
                     / jnp.maximum(scat_sw, 1e-30), 0.0)
    ssa_sw = jnp.where(cloudy & (od_sw > 0.0),
                       scat_sw / jnp.maximum(od_sw, 1e-30), 0.0)

    if config.do_lw_cloud_scattering:
        od_lw = jnp.where(cloudy, od_lw_liq + od_lw_ice, 0.0)
        scat_lw = scat_lw_liq + scat_lw_ice
        g_lw = jnp.where(cloudy & (scat_lw > 0.0),
                         (g_lw_liq * scat_lw_liq + g_lw_ice * scat_lw_ice)
                         / jnp.maximum(scat_lw, 1e-30), 0.0)
        ssa_lw = jnp.where(cloudy & (od_lw > 0.0),
                           scat_lw / jnp.maximum(od_lw, 1e-30), 0.0)
    else:
        od_lw = jnp.where(cloudy, od_lw_liq - scat_lw_liq
                          + od_lw_ice - scat_lw_ice, 0.0)
        ssa_lw = jnp.zeros_like(od_lw)
        g_lw = jnp.zeros_like(od_lw)

    return od_lw, ssa_lw, g_lw, od_sw, ssa_sw, g_sw
