"""McICA (Monte Carlo Independent Column Approximation) solvers.

Reference parity: radiation/radiation_mcica_sw.F90:39-346 and
radiation_mcica_lw.F90:39-361 — clear-sky pass, stochastic cloud
generator producing per-g optical-depth scalings, total-sky pass on the
combined properties, and the cloud-cover-weighted blend of the overcast
and clear profiles (noise reduction). The LW uses the per-column seed
offset +997 (radiation_mcica_lw.F90:203) and chooses between scattering
adding / no-scattering source propagation.

Vectorization: all columns and g-points at once; the reference's
per-layer clear/cloudy branch becomes a where-select of layer
reflectances.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

from ..config import RadiationConfig
from ..optics.cloud import delta_eddington
from ..optics.combine import combine_cloud_gas_lw, combine_cloud_gas_sw
from . import two_stream as ts
from .adding import adding_lw, adding_sw, lw_no_scattering_fluxes
from .cloud_generator import cloud_generator
from .cloudless import LwFluxes, SwFluxes, _gf
from .pdf_sampler import PdfSampler


def _sw_reftrans(mu0, od, ssa, g, delta_scale_all):
    if delta_scale_all:
        od, ssa, g = delta_eddington(od, ssa, g)
    g1, g2, g3 = ts.sw_gammas(mu0, ssa, g)
    return ts.sw_reftrans(mu0, od, ssa, g1, g2, g3)


def solver_mcica_sw(config: RadiationConfig, pdf_sampler: PdfSampler,
                    band_from_g, iseed, cos_sza, cloud,
                    od, ssa, g, od_cloud, ssa_cloud, g_cloud,
                    incoming_sw, albedo_diffuse, albedo_direct):
    """Returns (total SwFluxes, clear SwFluxes, cloud_cover (ncol,))."""
    ncol, nlev, ng = od.shape
    mu0 = jnp.maximum(cos_sza, 1e-10)[None, :]     # (1, ncol) g-first

    # ---- cloud generator ---------------------------------------------------
    od_scaling, tcc = cloud_generator(
        ng, iseed, config.i_overlap_scheme,
        config.cloud_fraction_threshold, cloud.fraction,
        cloud.overlap_param, config.cloud_inhom_decorr_scaling,
        cloud.fractional_std, pdf_sampler,
        is_beta_overlap=config.use_beta_overlap)

    # ---- clear + total-sky layer properties ----------------------------
    frac_mask = cloud.fraction >= config.cloud_fraction_threshold
    (r_c, t_c, rd_c, tdd_c, tdir_c, r, t, rd, tdd, tdir) = \
        _sw_clear_total_reftrans(
            od, ssa, g, od_cloud, ssa_cloud, g_cloud, band_from_g,
            od_scaling, frac_mask, cos_sza,
            config.do_sw_delta_scaling_with_gases)
    up_c, dnd_c, dndir_c = adding_sw(
        r_c, t_c, rd_c, tdd_c, tdir_c, incoming_sw.T,
        albedo_diffuse.T, albedo_direct.T, jnp.maximum(cos_sza, 1e-10),
        gfirst=True)
    up, dnd, dndir = adding_sw(
        r, t, rd, tdd, tdir, incoming_sw.T, albedo_diffuse.T,
        albedo_direct.T, jnp.maximum(cos_sza, 1e-10), gfirst=True)

    # ---- blend: tcc*overcast + (1-tcc)*clear ------------------------------
    has_cloud = (tcc >= config.cloud_fraction_threshold)[None, None, :]
    w = tcc[None, None, :]
    up_tot = jnp.where(has_cloud, w * up + (1 - w) * up_c, up_c)
    dnd_tot = jnp.where(has_cloud, w * dnd + (1 - w) * dnd_c, dnd_c)
    dndir_tot = jnp.where(has_cloud, w * dndir + (1 - w) * dndir_c,
                          dndir_c)

    daylight = (cos_sza > 0.0)[None, None, :]
    zero = jnp.zeros_like(up_tot)
    total = SwFluxes(up=jnp.where(daylight, up_tot, 0.0),
                     dn_diffuse=jnp.where(daylight, dnd_tot, 0.0),
                     dn_direct=jnp.where(daylight, dndir_tot, 0.0))
    clear = SwFluxes(up=jnp.where(daylight, up_c, 0.0),
                     dn_diffuse=jnp.where(daylight, dnd_c, 0.0),
                     dn_direct=jnp.where(daylight, dndir_c, 0.0))
    # night columns: reference leaves cloud_cover_sw at its -1 init
    tcc = jnp.where(cos_sza > 0.0, tcc, -1.0)
    return total, clear, tcc


def solver_mcica_lw(config: RadiationConfig, pdf_sampler: PdfSampler,
                    band_from_g, iseed, cloud,
                    od, ssa, g, od_cloud, ssa_cloud, g_cloud,
                    planck_hl, emission, albedo):
    """Returns (total LwFluxes, clear LwFluxes, cloud_cover (ncol,))."""
    ncol, nlev, ng = od.shape
    planck_g = _gf(planck_hl)
    planck_top = planck_g[:-1]
    planck_bot = planck_g[1:]
    emis_g, alb_g = emission.T, albedo.T
    do_clear_scat = (config.do_lw_aerosol_scattering)

    # ---- cloud generator (seed offset 997: radiation_mcica_lw.F90) -------
    od_scaling, tcc = cloud_generator(
        ng, iseed + 997, config.i_overlap_scheme,
        config.cloud_fraction_threshold, cloud.fraction,
        cloud.overlap_param, config.cloud_inhom_decorr_scaling,
        cloud.fractional_std, pdf_sampler,
        is_beta_overlap=config.use_beta_overlap)

    if not do_clear_scat and not config.do_lw_cloud_scattering:
        # clear + total no-scattering pass
        frac_mask = cloud.fraction >= config.cloud_fraction_threshold
        t_c, su_c, sd_c, t, su, sd = _lw_clear_total_noscat(
            od, od_cloud, band_from_g, od_scaling, frac_mask, planck_hl)
        up_c, dn_c = lw_no_scattering_fluxes(t_c, su_c, sd_c, emis_g,
                                             alb_g, gfirst=True)
        up, dn = lw_no_scattering_fluxes(t, su, sd, emis_g, alb_g,
                                         gfirst=True)
    else:
        # ---- clear sky (g-first layout; see cloudless.py) -----------
        if do_clear_scat:
            g1, g2 = ts.lw_gammas(_gf(ssa), _gf(g))
            r_c, t_c, su_c, sd_c = ts.lw_reftrans(_gf(od), g1, g2,
                                                  planck_top,
                                                  planck_bot)
            up_c, dn_c = adding_lw(r_c, t_c, su_c, sd_c, emis_g,
                                   alb_g, gfirst=True)
        else:
            t_c, su_c, sd_c = ts.lw_no_scattering_transmittance(
                _gf(od), planck_top, planck_bot)
            r_c = jnp.zeros_like(t_c)
            up_c, dn_c = lw_no_scattering_fluxes(t_c, su_c, sd_c,
                                                 emis_g, alb_g,
                                                 gfirst=True)

        # ---- total sky ----------------------------------------------
        cloud_mask = (cloud.fraction
                      >= config.cloud_fraction_threshold)[..., None]
        od_t, ssa_t, g_t = combine_cloud_gas_lw(
            od, ssa, g, od_cloud, ssa_cloud, g_cloud, band_from_g,
            config.do_lw_cloud_scattering, od_scaling=od_scaling,
            cloud_mask=cloud_mask)
        mask_g = (cloud.fraction.T[:, None, :]
                  >= config.cloud_fraction_threshold)
        if config.do_lw_cloud_scattering:
            g1, g2 = ts.lw_gammas(_gf(ssa_t), _gf(g_t))
            r, t, su, sd = ts.lw_reftrans(_gf(od_t), g1, g2,
                                          planck_top, planck_bot)
            # clear layers reuse the clear-sky properties (incl. R=0
            # when the clear path is no-scattering: fast_adding
            # equivalence)
            r = jnp.where(mask_g, r, r_c)
            t = jnp.where(mask_g, t, t_c)
            su = jnp.where(mask_g, su, su_c)
            sd = jnp.where(mask_g, sd, sd_c)
            up, dn = adding_lw(r, t, su, sd, emis_g, alb_g,
                               gfirst=True)
        else:
            t, su, sd = ts.lw_no_scattering_transmittance(
                _gf(od_t), planck_top, planck_bot)
            t = jnp.where(mask_g, t, t_c)
            su = jnp.where(mask_g, su, su_c)
            sd = jnp.where(mask_g, sd, sd_c)
            up, dn = lw_no_scattering_fluxes(t, su, sd, emis_g, alb_g,
                                             gfirst=True)

    # ---- blend -------------------------------------------------------------
    has_cloud = (tcc >= config.cloud_fraction_threshold)[None, None, :]
    w = tcc[None, None, :]
    up_tot = jnp.where(has_cloud, w * up + (1 - w) * up_c, up_c)
    dn_tot = jnp.where(has_cloud, w * dn + (1 - w) * dn_c, dn_c)

    extras = {}
    if config.do_lw_derivatives:
        from .lw_derivatives import lw_derivatives_ica
        deriv_cloudy = lw_derivatives_ica(t, up[-1].T, gfirst=True)
        deriv_clear = lw_derivatives_ica(t_c, up_c[-1].T, gfirst=True)
        wcol = tcc[:, None]
        hc2 = (tcc >= config.cloud_fraction_threshold)[:, None]
        blendable = (tcc < 1.0 - config.cloud_fraction_threshold)[:, None]
        deriv = jnp.where(
            hc2,
            jnp.where(blendable,
                      wcol * deriv_cloudy + (1 - wcol) * deriv_clear,
                      deriv_cloudy),
            deriv_clear)
        extras["lw_derivatives"] = deriv

    return (LwFluxes(up=up_tot, dn=dn_tot),
            LwFluxes(up=up_c, dn=dn_c), tcc, extras)


def _sw_clear_total_reftrans(od, ssa, g, od_cloud, ssa_cloud, g_cloud,
                             band_from_g, od_scaling, frac_mask, mu0,
                             delta_all):
    """Clear + masked-total SW layer reflectances.

    od/ssa/g/od_scaling: (ncol, nlev, ng); *_cloud (ncol, nlev, nb);
    frac_mask (ncol, nlev) bool (layer cloudy); mu0 (ncol,). Returns 10
    g-first (nlev, ng, ncol) arrays: (r_c, t_c, rd_c, tdd_c, tdir_c, r,
    t, rd, tdd, tdir) with the total-sky family equal to the clear one
    where ~frac_mask (radiation_mcica_sw.F90:220-274)."""
    mu = jnp.maximum(mu0, 1e-10)[None, :]
    clear = _sw_reftrans(mu, _gf(od), _gf(ssa), _gf(g), delta_all)
    od_t, ssa_t, g_t = combine_cloud_gas_sw(
        od, ssa, g, od_cloud, ssa_cloud, g_cloud, band_from_g,
        od_scaling=od_scaling, cloud_mask=frac_mask[..., None])
    tot = _sw_reftrans(mu, _gf(od_t), _gf(ssa_t), _gf(g_t), delta_all)
    mg = jnp.moveaxis(frac_mask, 1, 0)[:, None, :]
    tot = tuple(jnp.where(mg, x, c) for x, c in zip(tot, clear))
    return clear + tot


def _lw_clear_total_noscat(od, od_cloud, band_from_g, od_scaling,
                           frac_mask, planck_hl):
    """Clear + masked-total LW no-scattering transmittance/sources
    (do_lw_cloud_scattering=False: cloud od is absorption-only,
    radiation_mcica_lw.F90). od/od_scaling (ncol, nlev, ng); od_cloud
    (ncol, nlev, nb); planck_hl (ncol, nlev+1, ng); frac_mask (ncol,
    nlev) bool. Returns 6 g-first (nlev, ng, ncol): (t_c, su_c, sd_c,
    t, su, sd) with the total family equal to the clear one where
    ~frac_mask."""
    pt = _gf(planck_hl[:, :-1, :])
    pb = _gf(planck_hl[:, 1:, :])
    tc, suc, sdc = ts.lw_no_scattering_transmittance(_gf(od), pt, pb)
    odc = od_cloud[:, :, band_from_g] * od_scaling
    od_t = jnp.where(frac_mask[..., None], od + odc, od)
    t, su, sd = ts.lw_no_scattering_transmittance(_gf(od_t), pt, pb)
    mg = jnp.moveaxis(frac_mask, 1, 0)[:, None, :]
    return (tc, suc, sdc, jnp.where(mg, t, tc), jnp.where(mg, su, suc),
            jnp.where(mg, sd, sdc))
