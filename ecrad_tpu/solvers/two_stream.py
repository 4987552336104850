"""Two-stream coefficients and layer reflectance/transmittance.

Reference parity: radiation/radiation_two_stream.F90 — LW Fu et al. (1997)
gammas with diffusivity 1.66 (:79-117), SW Zdunkowski PIFM gammas
(:123-164), Meador & Weaver (1980) reflectance/transmittance with
linear-in-tau Planck sources (:173-409), classic (non-RTE) SW variant
(:461-560). Everything is elementwise over (..., ng) arrays, which XLA
fuses into few kernels.
"""
from __future__ import annotations

import jax.numpy as jnp


LW_DIFFUSIVITY = 1.66
SW_DIFFUSIVITY = 2.0
KMIN = 1.0e-4  # single-precision value (radiation_two_stream.F90:46)


def lw_gammas(ssa, g):
    """Fu et al. (1997) Eq 2.9/2.10."""
    factor = (LW_DIFFUSIVITY * 0.5) * ssa
    gamma1 = LW_DIFFUSIVITY - factor * (1.0 + g)
    gamma2 = factor * (1.0 - g)
    return gamma1, gamma2


def sw_gammas(mu0, ssa, g):
    """Zdunkowski PIFM (practical improved flux method)."""
    factor = 0.75 * g
    gamma1 = 2.0 - ssa * (1.25 + factor)
    gamma2 = ssa * (0.75 - factor)
    gamma3 = 0.5 - mu0 * factor
    return gamma1, gamma2, gamma3


def _k_exponent(gamma1, gamma2):
    return jnp.sqrt(jnp.maximum((gamma1 - gamma2) * (gamma1 + gamma2),
                                KMIN))


def lw_reftrans(od, gamma1, gamma2, planck_top, planck_bot):
    """LW Meador-Weaver reflectance/transmittance + linear-in-tau sources.

    Reference: calc_reflectance_transmittance_lw (:173-257), including the
    od<=1e-3 series expansion branch. Returns (ref, trans, src_up, src_dn).
    """
    k = _k_exponent(gamma1, gamma2)
    # --- full branch
    expo = jnp.exp(-k * od)
    expo2 = expo * expo
    rt_factor = 1.0 / (k + gamma1 + (k - gamma1) * expo2)
    ref_full = gamma2 * (1.0 - expo2) * rt_factor
    trans_full = 2.0 * k * expo * rt_factor
    coeff = (planck_bot - planck_top) / jnp.maximum(
        od * (gamma1 + gamma2), 1e-30)
    up_top = coeff + planck_top
    up_bot = coeff + planck_bot
    dn_top = -coeff + planck_top
    dn_bot = -coeff + planck_bot
    src_up_full = up_top - ref_full * dn_top - trans_full * up_bot
    src_dn_full = dn_bot - ref_full * up_bot - trans_full * dn_top
    # --- thin branch (od <= 1e-3)
    ref_thin = gamma2 * od
    trans_thin = (1.0 - k * od) / (1.0 + od * (gamma1 - k))
    src_thin = ((1.0 - ref_thin - trans_thin)
                * 0.5 * (planck_top + planck_bot))
    thin = od <= 1.0e-3
    ref = jnp.where(thin, ref_thin, ref_full)
    trans = jnp.where(thin, trans_thin, trans_full)
    src_up = jnp.where(thin, src_thin, src_up_full)
    src_dn = jnp.where(thin, src_thin, src_dn_full)
    return ref, trans, src_up, src_dn


def lw_no_scattering_transmittance(od, planck_top, planck_bot):
    """No-scattering LW: trans = exp(-1.66 od) + linear-in-tau sources.

    Reference: calc_no_scattering_transmittance_lw (:337-409)."""
    coeff0 = LW_DIFFUSIVITY * od
    trans_full = jnp.exp(-coeff0)
    coeff = (planck_bot - planck_top) / jnp.maximum(coeff0, 1e-30)
    src_up_full = (coeff + planck_top) - trans_full * (coeff + planck_bot)
    src_dn_full = (-coeff + planck_bot) - trans_full * (-coeff + planck_top)
    trans_thin = 1.0 - coeff0
    src_thin = coeff0 * 0.5 * (planck_top + planck_bot)
    thin = od <= 1.0e-3
    trans = jnp.where(thin, trans_thin, trans_full)
    src_up = jnp.where(thin, src_thin, src_up_full)
    src_dn = jnp.where(thin, src_thin, src_dn_full)
    return trans, src_up, src_dn


def sw_reftrans(mu0, od, ssa, gamma1, gamma2, gamma3):
    """SW Meador-Weaver + direct-beam terms (classic variant,
    radiation_two_stream.F90:461-560).

    mu0 broadcasts against od/ssa/gammas. Returns
    (ref_diff, trans_diff, ref_dir, trans_dir_diff, trans_dir_dir).
    """
    od_over_mu0 = jnp.maximum(od / mu0, 0.0)
    gamma4 = 1.0 - gamma3
    alpha1 = gamma1 * gamma4 + gamma2 * gamma3
    alpha2 = gamma1 * gamma3 + gamma2 * gamma4
    k = _k_exponent(gamma1, gamma2)
    k_mu0 = k * mu0
    # avoid the k*mu0 == 1 resonance (reference nudges by 10*eps; we use
    # a float32-appropriate nudge)
    k_mu0 = jnp.where(jnp.abs(k_mu0 - 1.0) < 1e-6,
                      1.0 - 1e-6, k_mu0)
    k_gamma3 = k * gamma3
    k_gamma4 = k * gamma4
    e0 = jnp.exp(-od_over_mu0)
    trans_dir_dir = e0
    expo = jnp.exp(-k * od)
    expo2 = expo * expo
    k2e = 2.0 * k * expo
    rt = 1.0 / (k + gamma1 + (k - gamma1) * expo2)
    ref_diff = gamma2 * (1.0 - expo2) * rt
    trans_diff = k2e * rt
    rt_dir = mu0 * ssa * rt / (1.0 - k_mu0 * k_mu0)
    ref_dir = rt_dir * ((1.0 - k_mu0) * (alpha2 + k_gamma3)
                        - (1.0 + k_mu0) * (alpha2 - k_gamma3) * expo2
                        - k2e * (gamma3 - alpha2 * mu0) * e0)
    trans_dir_diff = rt_dir * (
        k2e * (gamma4 + alpha1 * mu0)
        - e0 * ((1.0 + k_mu0) * (alpha1 + k_gamma4)
                - (1.0 - k_mu0) * (alpha1 - k_gamma4) * expo2))
    return ref_diff, trans_diff, ref_dir, trans_dir_diff, trans_dir_dir


def lw_reftrans_isothermal(od, gamma1, gamma2, planck):
    """Isothermal-layer LW Meador-Weaver reflectance/transmittance.

    Reference: calc_reflectance_transmittance_isothermal_lw
    (radiation_two_stream.F90:263-327). Used by the surface/canopy scheme
    where the canopy temperature is constant with height. Returns
    (reflectance, transmittance, source) with source the emission from
    within the layer (same up and down)."""
    k = _k_exponent(gamma1, gamma2)
    expo = jnp.exp(-k * od)
    expo2 = expo * expo
    rt = 1.0 / (k + gamma1 + (k - gamma1) * expo2)
    ref = gamma2 * (1.0 - expo2) * rt
    trans = 2.0 * k * expo * rt
    source = planck * (1.0 - ref - trans)
    return ref, trans, source


def sw_reftrans_z(mu0, depth, gamma0, gamma1, gamma2, gamma3, gamma4):
    """SW Meador-Weaver in physical (z) coordinates.

    Reference: calc_reflectance_transmittance_z_sw
    (radiation_two_stream.F90:648-774). The gammas here are *per-metre
    rates* (they may include wall-exchange terms for urban canopies, so
    the scattering coefficients gamma3/gamma4 are supplied pre-scaled
    rather than derived from ssa); gamma0 is the attenuation rate of the
    unscattered direct beam such that dFdir/dz = -gamma0 Fdir.
    """
    od_over_mu0 = jnp.maximum(gamma0 * depth, 0.0)
    alpha1 = gamma1 * gamma4 + gamma2 * gamma3
    alpha2 = gamma1 * gamma3 + gamma2 * gamma4
    k = _k_exponent(gamma1, gamma2)
    k_mu0 = k * mu0
    k_mu0 = jnp.where(jnp.abs(k_mu0 - 1.0) < 1e-6, 1.0 - 1e-6, k_mu0)
    k_gamma3 = k * gamma3
    k_gamma4 = k * gamma4
    e0 = jnp.exp(-od_over_mu0)
    trans_dir_dir = e0
    expo = jnp.exp(-k * depth)
    expo2 = expo * expo
    k2e = 2.0 * k * expo
    rt = 1.0 / (k + gamma1 + (k - gamma1) * expo2)
    ref_diff = gamma2 * (1.0 - expo2) * rt
    trans_diff = k2e * rt
    rt_dir = mu0 * rt / (1.0 - k_mu0 * k_mu0)
    ref_dir = rt_dir * ((1.0 - k_mu0) * (alpha2 + k_gamma3)
                        - (1.0 + k_mu0) * (alpha2 - k_gamma3) * expo2
                        - k2e * (gamma3 - alpha2 * mu0) * e0)
    trans_dir_diff = rt_dir * (
        k2e * (gamma4 + alpha1 * mu0)
        - e0 * ((1.0 + k_mu0) * (alpha1 + k_gamma4)
                - (1.0 - k_mu0) * (alpha1 - k_gamma4) * expo2))
    return ref_diff, trans_diff, ref_dir, trans_dir_diff, trans_dir_dir


def sw_frac_scattered_diffuse(od, gamma1, gamma2):
    """Fraction of beam extinction that scatters into the diffuse streams
    (radiation_two_stream.F90:781-839, used by SPARTACUS)."""
    k = _k_exponent(gamma1, gamma2)
    expo = jnp.exp(-k * od)
    expo2 = expo * expo
    rt = 1.0 / (k + gamma1 + (k - gamma1) * expo2)
    ref = gamma2 * (1.0 - expo2) * rt
    trans = 2.0 * k * expo * rt
    one_minus = 1.0 - ref - trans
    denom = 1.0 - jnp.exp(-SW_DIFFUSIVITY * od)
    return jnp.where(denom > 1e-12,
                     jnp.clip(one_minus / jnp.maximum(denom, 1e-12),
                              0.0, 1.0),
                     1.0)
