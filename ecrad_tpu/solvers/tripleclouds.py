"""Tripleclouds solvers: 1 clear + 2 cloudy regions per layer.

Reference parity:
  - region properties: radiation/radiation_regions.F90:35-199 (gamma or
    lognormal optical-depth scalings for the two cloudy regions)
  - overlap matrices: radiation_overlap.F90:64-632 (directional U/V
    matrices from the alpha/beta overlap parameter)
  - solvers: radiation_tripleclouds_sw.F90:100-608 and
    radiation_tripleclouds_lw.F90 (upward albedo/source accumulation
    with V/U region exchange at interfaces, then downward flux pass)

State layout: region-leading g-first (nreg, ng, ncol), the big dims
minor, so the region exchange is elementwise over the batch. Level
recurrences are jax.lax.scan (region coupling at interfaces makes the
recurrence matrix-valued, so the Moebius-scan trick of the ICA adding
does not apply); per-level arrays are indexed by the scan counter.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


from ..config import PdfShape, RadiationConfig
from ..optics.cloud import delta_eddington
from . import two_stream as ts
from .cloud_cover import beta2alpha
from .cloudless import LwFluxes, SwFluxes

# radiation_regions.F90 constants
MIN_GAMMA_OD_SCALING = 0.025
MIN_LOWER_FRAC = 0.5
MAX_LOWER_FRAC = 0.9
FSD_AT_MIN = 1.5
FSD_AT_MAX = 3.725
LOWER_FRAC_GRAD = (MAX_LOWER_FRAC - MIN_LOWER_FRAC) / (FSD_AT_MAX
                                                       - FSD_AT_MIN)
LOWER_FRAC_INTERCEPT = MIN_LOWER_FRAC - FSD_AT_MIN * LOWER_FRAC_GRAD


def calc_region_properties(nreg: int, do_gamma: bool, cloud_fraction,
                           frac_std, frac_threshold=1.0e-20):
    """Region fractions + od scalings (radiation_regions.F90:35-199).

    Returns (reg_fracs (ncol, nlev, nreg), od_scaling (ncol, nlev, nreg))
    with od_scaling[..., 0] = 1 (clear region, unused)."""
    cf = cloud_fraction
    fsd = frac_std
    cloudy = cf >= frac_threshold
    if nreg == 2:
        f1 = 1.0 - cf
        fracs = jnp.stack([f1, cf], axis=-1)
        scal = jnp.stack([jnp.ones_like(cf), jnp.ones_like(cf)], axis=-1)
        return fracs, scal
    if nreg != 3:
        raise ValueError("only 2 or 3 regions supported")
    if not do_gamma:
        # lognormal split
        s2 = jnp.exp(-jnp.sqrt(jnp.log(fsd ** 2 + 1.0))) / jnp.sqrt(
            fsd ** 2 + 1.0)
        f2 = 0.5 * cf
        f3 = 0.5 * cf
        s3 = 2.0 - s2
    else:
        f2 = cf * jnp.clip(LOWER_FRAC_INTERCEPT + fsd * LOWER_FRAC_GRAD,
                           MIN_LOWER_FRAC, MAX_LOWER_FRAC)
        s2 = MIN_GAMMA_OD_SCALING + (1.0 - MIN_GAMMA_OD_SCALING) * jnp.exp(
            -fsd * (1.0 + 0.5 * fsd * (1.0 + 0.5 * fsd)))
        f3 = cf - f2
        s3 = (cf - f2 * s2) / jnp.maximum(f3, 1e-12)
    f1 = jnp.where(cloudy, 1.0 - cf, 1.0)
    f2 = jnp.where(cloudy, f2, 0.0)
    f3 = jnp.where(cloudy, f3, 0.0)
    s2 = jnp.where(cloudy, s2, 1.0)
    s3 = jnp.where(cloudy, s3, 1.0)
    return (jnp.stack([f1, f2, f3], axis=-1),
            jnp.stack([jnp.ones_like(cf), s2, s3], axis=-1))


def calc_overlap_matrices(reg_fracs, overlap_param, decorr_scaling,
                          frac_threshold, use_beta=False):
    """Directional U/V matrices per interface
    (radiation_overlap.F90:280-632, alpha form :130).

    reg_fracs: (ncol, nlev, nreg); overlap_param (ncol, nlev-1).
    Returns u, v: (ncol, nlev+1, nreg, nreg) with
    u[jupper, jlower] = overlap(jupper, jlower)/frac_lower and
    v[jlower, jupper] = overlap(jupper, jlower)/frac_upper, plus
    cloud_cover (ncol,)."""
    ncol, nlev, nreg = reg_fracs.shape
    dtype = reg_fracs.dtype
    ones = jnp.ones((ncol, 1, nreg), dtype).at[:, :, 1:].set(0.0)
    # frac_upper at interface i = region fracs of layer i-1 (or clear-sky
    # boundary at TOA), frac_lower = layer i (or surface boundary)
    frac_upper = jnp.concatenate([ones, reg_fracs], axis=1)  # (ncol,nlev+1,nreg)
    frac_lower = jnp.concatenate([reg_fracs, ones], axis=1)
    # op at interface i: overlap_param(i-1) for 2 <= i <= nlev, else 1
    op1 = jnp.concatenate([jnp.ones((ncol, 1), dtype), overlap_param,
                           jnp.ones((ncol, 1), dtype)], axis=1)
    op_inhom = jnp.where(op1 >= 0.0, op1 ** (1.0 / decorr_scaling), op1)

    cf_upper = frac_upper[:, :, 1:].sum(-1)
    cf_lower = frac_lower[:, :, 1:].sum(-1)
    if use_beta:
        op_eff = beta2alpha(op1, cf_upper, cf_lower)
        opi_eff = beta2alpha(op_inhom, cf_upper, cf_lower)
    else:
        op_eff, opi_eff = op1, op_inhom

    pcc = (op_eff * jnp.maximum(cf_upper, cf_lower)
           + (1.0 - op_eff) * (cf_upper + cf_lower - cf_upper * cf_lower))

    # overlap matrix entries (radiation_overlap.F90 calc_alpha_overlap)
    m = jnp.zeros((ncol, nlev + 1, nreg, nreg), dtype)
    m = m.at[:, :, 0, 0].set(1.0 - pcc)
    if nreg == 2:
        m = m.at[:, :, 0, 1].set(pcc - cf_upper)
        m = m.at[:, :, 1, 0].set(pcc - cf_lower)
        m = m.at[:, :, 1, 1].set(cf_upper + cf_lower - pcc)
    else:
        inv_low = 1.0 / jnp.maximum(cf_lower, 1e-6)
        inv_up = 1.0 / jnp.maximum(cf_upper, 1e-6)
        m = m.at[:, :, 0, 1].set((pcc - cf_upper) * frac_lower[:, :, 1]
                                 * inv_low)
        m = m.at[:, :, 0, 2].set((pcc - cf_upper) * frac_lower[:, :, 2]
                                 * inv_low)
        m = m.at[:, :, 1, 0].set((pcc - cf_lower) * frac_upper[:, :, 1]
                                 * inv_up)
        m = m.at[:, :, 2, 0].set((pcc - cf_lower) * frac_upper[:, :, 2]
                                 * inv_up)
        frac_both = cf_upper + cf_lower - pcc
        cu = frac_upper[:, :, 2] * inv_up
        clo = frac_lower[:, :, 2] * inv_low
        pcc2 = (opi_eff * jnp.maximum(cu, clo)
                + (1.0 - opi_eff) * (cu + clo - cu * clo))
        m = m.at[:, :, 1, 1].set(frac_both * (1.0 - pcc2))
        m = m.at[:, :, 1, 2].set(frac_both * (pcc2 - cu))
        m = m.at[:, :, 2, 1].set(frac_both * (pcc2 - clo))
        m = m.at[:, :, 2, 2].set(frac_both * (cu + clo - pcc2))

    u = jnp.where(frac_lower[:, :, None, :] >= frac_threshold,
                  m / jnp.maximum(frac_lower[:, :, None, :], 1e-30), 0.0)
    v = jnp.where(frac_upper[:, :, None, :] >= frac_threshold,
                  jnp.swapaxes(m, -1, -2)
                  / jnp.maximum(frac_upper[:, :, None, :], 1e-30), 0.0)
    cloud_cover = 1.0 - jnp.prod(v[:, :, 0, 0], axis=1)
    return u, v, cloud_cover


def _region_props_sw_g(cfg, band_from_g, od_g, ssa_g, g_g, odc_g,
                       ssac_g, gc_g, sc_g, cmask_g):
    """Per-region SW optical properties in the g-first layout:
    inputs (nlev, ng, ncol) [cloud fields band-expanded], sc_g
    (nlev, nreg, ncol), cmask_g (nlev, 1, ncol); returns stacks
    (nlev, nreg, ng, ncol). Computing region properties (and the
    Meador-Weaver reftrans after them) directly g-first removes the
    5 big output transposes the level sweeps would otherwise need —
    only the 3 gas-optics inputs are transposed."""
    nreg = sc_g.shape[1]
    outs_od, outs_ssa, outs_g = [od_g], [ssa_g], [g_g]
    for r in range(1, nreg):
        s = sc_g[:, r][:, None, :]
        odc_r = odc_g * s
        od_t = od_g + odc_r
        scat = ssa_g * od_g + ssac_g * odc_r
        ssa_t = jnp.where(od_t > 0, scat / jnp.maximum(od_t, 1e-30),
                          0.0)
        g_t = jnp.where(scat > 0,
                        (g_g * ssa_g * od_g + gc_g * ssac_g * odc_r)
                        / jnp.maximum(scat, 1e-30), 0.0)
        od_t = jnp.where(cmask_g, od_t, od_g)
        ssa_t = jnp.where(cmask_g, ssa_t, ssa_g)
        g_t = jnp.where(cmask_g, g_t, g_g)
        outs_od.append(od_t)
        outs_ssa.append(ssa_t)
        outs_g.append(g_t)
    return (jnp.stack(outs_od, axis=1), jnp.stack(outs_ssa, axis=1),
            jnp.stack(outs_g, axis=1))


def solver_tripleclouds_sw(setup, single_level, cloud, od, ssa, g,
                           od_cloud, ssa_cloud, g_cloud, incoming_sw,
                           albedo_diffuse, albedo_direct):
    cfg: RadiationConfig = setup.config
    band_from_g = setup.spec.band_from_reordered_g_sw
    ncol, nlev, ng = od.shape
    nreg = cfg.nregions
    dtype = od.dtype
    mu0 = jnp.maximum(single_level.cos_sza, 1e-10)

    reg_fracs, od_scaling = calc_region_properties(
        nreg, cfg.i_cloud_pdf_shape == PdfShape.GAMMA, cloud.fraction,
        cloud.fractional_std, cfg.cloud_fraction_threshold)
    u_mat, v_mat, tcc = calc_overlap_matrices(
        reg_fracs, cloud.overlap_param, cfg.cloud_inhom_decorr_scaling,
        cfg.cloud_fraction_threshold, cfg.use_beta_overlap)

    # region-leading g-first layout throughout (per-level slices are
    # (nreg, ng, ncol): regions leading, columns minor — see
    # solvers/adding.py _to_gfirst). Only the gas-optics inputs are
    # transposed; region props + Meador-Weaver run natively g-first.
    gT = lambda x: jnp.transpose(x, (1, 2, 0))     # (nlev, ng, ncol)
    bandx = lambda x: gT(x)[:, band_from_g, :]
    cmask_g = jnp.moveaxis(cloud.fraction > 0.0, 1, 0)[:, None, :]
    od_r, ssa_r, g_r = _region_props_sw_g(
        cfg, band_from_g, gT(od), gT(ssa), gT(g), bandx(od_cloud),
        bandx(ssa_cloud), bandx(g_cloud),
        jnp.moveaxis(od_scaling, (1, 2), (0, 1)), cmask_g)
    if cfg.do_sw_delta_scaling_with_gases:
        od_r, ssa_r, g_r = delta_eddington(od_r, ssa_r, g_r)
    mu0_b = mu0[None, None, None, :]
    g1, g2, g3 = ts.sw_gammas(mu0_b, ssa_r, g_r)
    ref, trans, ref_dir, tdd, tdir = ts.sw_reftrans(
        mu0_b, od_r, ssa_r, g1, g2, g3)   # (nlev, nreg, ng, ncol)
    # overlap matrices per interface: (nlev+1, nreg, nreg, 1, ncol)
    vm_g = jnp.transpose(v_mat, (1, 2, 3, 0))[..., None, :]

    def mix(vm_l, x):
        """(nreg, nreg, 1, ncol) applied to (nreg, ng, ncol)."""
        return (vm_l * x[None]).sum(axis=1)

    clear_lay = ~(cloud.fraction > 0.0)           # (ncol, nlev)
    # clear layers: region 1 only (others zeroed in the passes)

    # ---------------- upward pass: total albedo -------------------------
    alb_surf = jnp.broadcast_to(albedo_diffuse.T[None],
                                (nreg, ng, ncol))
    albdir_surf = jnp.broadcast_to(
        (mu0[None, :] * albedo_direct.T)[None], (nreg, ng, ncol))
    # reference: surface albedo only in region 1 if bottom layer clear
    bottom_cloudy = (~clear_lay[:, -1])[None, None, :]
    reg0 = (jnp.arange(nreg) == 0)[:, None, None]
    alb_surf = jnp.where(bottom_cloudy | reg0, alb_surf, 0.0)
    albdir_surf = jnp.where(bottom_cloudy | reg0, albdir_surf, 0.0)

    clear_prev = jnp.concatenate(
        [jnp.ones((ncol, 1), bool), clear_lay[:, :-1]], axis=1)

    init_dir = incoming_sw.T[None] * reg_fracs[:, 0, :].T[:, None, :]

    def up_body(carry, lev):
        alb, albdir = carry                    # (nreg, ng, ncol)
        r = ref[lev]
        t = trans[lev]
        rd = ref_dir[lev]
        td = tdd[lev]
        tdir_l = tdir[lev]
        inv = 1.0 / (1.0 - alb * r)
        alb_below = r + t * t * alb * inv
        albdir_below = rd + (tdir_l * albdir + td * alb) * t * inv
        is_clear = clear_lay[:, lev][None, None, :]
        alb_below = jnp.where(is_clear & (~reg0), 0.0, alb_below)
        albdir_below = jnp.where(is_clear & (~reg0), 0.0,
                                 albdir_below)
        # mix through V at this interface unless this & above clear
        both_clear = (clear_lay[:, lev]
                      & clear_prev[:, lev])[None, None, :]
        vm_t = jnp.swapaxes(vm_g[lev], 0, 1)
        alb_mixed = mix(vm_t, alb_below)
        albdir_mixed = mix(vm_t, albdir_below)
        alb_new = jnp.where(both_clear, alb_below, alb_mixed)
        albdir_new = jnp.where(both_clear, albdir_below,
                               albdir_mixed)
        return (alb_new, albdir_new), (alb, albdir)

    levels_rev = jnp.arange(nlev - 1, -1, -1)
    (alb_top, albdir_top), (alb_hist, albdir_hist) = jax.lax.scan(
        up_body, (alb_surf, albdir_surf), levels_rev)
    # alb_hist[k] = albedo at half-level below layer levels_rev[k];
    # flip to (nlev, nreg, ng, ncol) indexed by layer
    alb_below_layer = jnp.flip(alb_hist, 0)
    albdir_below_layer = jnp.flip(albdir_hist, 0)

    # ---------------- downward pass ------------------------------
    flux_dn0 = jnp.zeros((nreg, ng, ncol), dtype)
    flux_up0 = init_dir * albdir_top

    def dn_body(carry, lev):
        flux_dn, direct_dn = carry
        r = ref[lev]
        t = trans[lev]
        rd = ref_dir[lev]
        td = tdd[lev]
        tdir_l = tdir[lev]
        alb_b = alb_below_layer[lev]      # at half-level lev+1
        albdir_b = albdir_below_layer[lev]
        inv = 1.0 / (1.0 - r * alb_b)
        fdn_new = (t * flux_dn
                   + direct_dn * (tdir_l * albdir_b * r + td)) * inv
        ddn_new = tdir_l * direct_dn
        is_clear = clear_lay[:, lev][None, None, :]
        fdn_new = jnp.where(is_clear & (~reg0), 0.0, fdn_new)
        ddn_new = jnp.where(is_clear & (~reg0), 0.0, ddn_new)
        fup_new = ddn_new * albdir_b + fdn_new * alb_b
        # mix through V at interface lev+1 unless this & next clear
        next_clear = jnp.where(lev + 1 < nlev,
                               clear_lay[:, jnp.minimum(lev + 1,
                                                        nlev - 1)],
                               True)
        both_clear = (clear_lay[:, lev] & next_clear)[None, None, :]
        vm_l = vm_g[lev + 1]
        fdn_mixed = mix(vm_l, fdn_new)
        ddn_mixed = mix(vm_l, ddn_new)
        fdn_out = jnp.where(both_clear, fdn_new, fdn_mixed)
        ddn_out = jnp.where(both_clear, ddn_new, ddn_mixed)
        return (fdn_out, ddn_out), (fup_new, fdn_out, ddn_out)

    (_, _), (fup_hist, fdn_hist, ddn_hist) = jax.lax.scan(
        dn_body, (flux_dn0, init_dir), jnp.arange(nlev))
    # assemble g-first half-level fluxes (nlev+1, ng, ncol)
    prof = lambda top, hist: jnp.concatenate(
        [top[None], hist.sum(1)], axis=0)
    up_prof = prof(flux_up0.sum(0), fup_hist)
    dn_diff_prof = prof(jnp.zeros((ng, ncol), dtype), fdn_hist)
    dn_dir_prof = prof(init_dir.sum(0), ddn_hist) * mu0[None, None, :]

    total = SwFluxes(up=up_prof, dn_diffuse=dn_diff_prof,
                     dn_direct=dn_dir_prof)

    # ---------------- clear sky (standard ICA, g-first) -------------------
    from .adding import adding_sw
    from .cloudless import _gf
    od_g, ssa_g, g_g = _gf(od), _gf(ssa), _gf(g)
    g1c, g2c, g3c = ts.sw_gammas(mu0[None, :], ssa_g, g_g)
    rc, tc, rdc, tddc, tdirc = ts.sw_reftrans(mu0[None, :], od_g, ssa_g,
                                              g1c, g2c, g3c)
    up_c, dnd_c, dndir_c = adding_sw(rc, tc, rdc, tddc, tdirc,
                                     incoming_sw.T, albedo_diffuse.T,
                                     albedo_direct.T, mu0, gfirst=True)
    clear = SwFluxes(up=up_c, dn_diffuse=dnd_c, dn_direct=dndir_c)

    daylight = (single_level.cos_sza > 0.0)[None, None, :]
    total = SwFluxes(*(jnp.where(daylight, f, 0.0) for f in total))
    clear = SwFluxes(*(jnp.where(daylight, f, 0.0) for f in clear))
    # night columns: reference leaves cloud_cover_sw at its -1 init
    tcc = jnp.where(single_level.cos_sza > 0.0, tcc, -1.0)
    return total, clear, tcc


def solver_tripleclouds_lw(setup, single_level, cloud, od, ssa, g,
                           od_cloud, ssa_cloud, g_cloud, planck_hl,
                           emission, albedo):
    cfg: RadiationConfig = setup.config
    band_from_g = setup.spec.band_from_reordered_g_lw
    ncol, nlev, ng = od.shape
    nreg = cfg.nregions
    dtype = od.dtype

    reg_fracs, od_scaling = calc_region_properties(
        nreg, cfg.i_cloud_pdf_shape == PdfShape.GAMMA, cloud.fraction,
        cloud.fractional_std, cfg.cloud_fraction_threshold)
    u_mat, v_mat, tcc = calc_overlap_matrices(
        reg_fracs, cloud.overlap_param, cfg.cloud_inhom_decorr_scaling,
        cfg.cloud_fraction_threshold, cfg.use_beta_overlap)

    # g-first inputs (nlev, ng, ncol): the whole per-region loop runs
    # in the scan layout so no per-region output transposes are needed
    # (see _region_props_sw_g)
    gT = lambda x: jnp.transpose(x, (1, 2, 0))
    od_g, ssa_g, g_g = gT(od), gT(ssa), gT(g)
    planck_top = gT(planck_hl[:, :-1, :])
    planck_bot = gT(planck_hl[:, 1:, :])
    odc = gT(od_cloud)[:, band_from_g, :]
    ssac = gT(ssa_cloud)[:, band_from_g, :]
    gc = gT(g_cloud)[:, band_from_g, :]
    sc_g = jnp.moveaxis(od_scaling, (1, 2), (0, 1))  # (nlev, nreg, ncol)
    cloud_mask = jnp.moveaxis(cloud.fraction > 0.0, 1, 0)[:, None, :]
    clear_lay = ~(cloud.fraction > 0.0)

    # per-region reftrans + sources, all (nlev, ng, ncol)
    refs, transs, sups, sdns = [], [], [], []
    for r in range(nreg):
        if r == 0:
            od_t, ssa_t, g_t = od_g, ssa_g, g_g
        else:
            s = sc_g[:, r][:, None, :]
            odc_r = odc * s
            od_t = od_g + odc_r
            if cfg.do_lw_cloud_scattering:
                if cfg.do_lw_aerosol_scattering:
                    scat = ssa_g * od_g + ssac * odc_r
                else:
                    scat = ssac * odc_r
                ssa_t = jnp.where(od_t > 0,
                                  scat / jnp.maximum(od_t, 1e-30), 0.0)
                if cfg.do_lw_aerosol_scattering:
                    g_t = jnp.where(
                        scat > 0,
                        (g_g * ssa_g * od_g + gc * ssac * odc_r)
                        / jnp.maximum(scat, 1e-30), 0.0)
                else:
                    g_t = jnp.where(scat > 0,
                                    gc * ssac * odc_r
                                    / jnp.maximum(scat, 1e-30), 0.0)
            else:
                ssa_t = jnp.zeros_like(od_t)
                g_t = jnp.zeros_like(od_t)
            od_t = jnp.where(cloud_mask, od_t, od_g)
            ssa_t = jnp.where(cloud_mask, ssa_t, 0.0)
            g_t = jnp.where(cloud_mask, g_t, 0.0)
        scattering = (cfg.do_lw_aerosol_scattering if r == 0
                      else cfg.do_lw_cloud_scattering)
        if scattering:
            g1, g2 = ts.lw_gammas(ssa_t, g_t)
            rr, tt, su, sd = ts.lw_reftrans(od_t, g1, g2, planck_top,
                                            planck_bot)
        else:
            tt, su, sd = ts.lw_no_scattering_transmittance(
                od_t, planck_top, planck_bot)
            rr = jnp.zeros_like(tt)
        refs.append(rr), transs.append(tt), sups.append(su), sdns.append(sd)
    ref = jnp.stack(refs, axis=1)        # (nlev, nreg, ng, ncol)
    trans = jnp.stack(transs, axis=1)
    sup = jnp.stack(sups, axis=1)
    sdn = jnp.stack(sdns, axis=1)
    # clear-sky layer properties stay g-first (nlev, ng, ncol)
    sup_clear = sup[:, 0]
    sdn_clear = sdn[:, 0]
    trans_clear = trans[:, 0]
    ref_clear = ref[:, 0]

    # scale sources by region fraction (cloudy layers)
    # (nlev, nreg, 1, ncol)
    fr = jnp.transpose(reg_fracs, (1, 2, 0))[:, :, None, :]
    not_clear = jnp.moveaxis(~clear_lay, 1, 0)[:, None, None, :]
    sup = jnp.where(not_clear, fr * sup, sup)
    sdn = jnp.where(not_clear, fr * sdn, sdn)
    reg0 = (jnp.arange(nreg) == 0)[:, None, None]
    # clear layers: zero regions 2..3
    sup = jnp.where(not_clear | reg0[None], sup, 0.0)
    sdn = jnp.where(not_clear | reg0[None], sdn, 0.0)
    ref = jnp.where(not_clear | reg0[None], ref, 0.0)
    trans = jnp.where(not_clear | reg0[None], trans, 0.0)
    vm_g = jnp.transpose(v_mat, (1, 2, 3, 0))[..., None, :]
    um_g = jnp.transpose(u_mat, (1, 2, 3, 0))[..., None, :]

    def mix(vm_l, x):
        return (vm_l * x[None]).sum(axis=1)

    # ---------------- upward pass -----------------------------------------
    src_surf = reg_fracs[:, -1, :].T[:, None, :] * emission.T[None]
    alb_surf = jnp.broadcast_to(albedo.T[None], (nreg, ng, ncol))
    clear_prev = jnp.concatenate(
        [jnp.ones((ncol, 1), bool), clear_lay[:, :-1]], axis=1)

    def up_body(carry, lev):
        alb, src = carry                       # (nreg, ng, ncol)
        r = ref[lev]
        t = trans[lev]
        su = sup[lev]
        sd = sdn[lev]
        inv = 1.0 / (1.0 - alb * r)
        alb_below = r + t * t * alb * inv
        src_below = su + t * (src + alb * sd) * inv
        is_clear = clear_lay[:, lev][None, None, :]
        alb_below = jnp.where(is_clear & (~reg0), 0.0, alb_below)
        src_below = jnp.where(is_clear & (~reg0), 0.0, src_below)
        both_clear = (clear_lay[:, lev]
                      & clear_prev[:, lev])[None, None, :]
        alb_mixed = mix(jnp.swapaxes(vm_g[lev], 0, 1), alb_below)
        src_mixed = mix(um_g[lev], src_below)
        alb_new = jnp.where(both_clear, alb_below, alb_mixed)
        src_new = jnp.where(both_clear, src_below, src_mixed)
        return (alb_new, src_new), (alb, src)

    levels_rev = jnp.arange(nlev - 1, -1, -1)
    (alb_top, src_top), (alb_hist, src_hist) = jax.lax.scan(
        up_body, (alb_surf, src_surf), levels_rev)
    alb_below_layer = jnp.flip(alb_hist, 0)  # (nlev,nreg,ng,ncol)
    src_below_layer = jnp.flip(src_hist, 0)

    # ---------------- downward pass ------------------------------
    flux_dn0 = jnp.zeros((nreg, ng, ncol), dtype)

    def dn_body(carry, lev):
        flux_dn = carry
        r = ref[lev]
        t = trans[lev]
        sd = sdn[lev]
        alb_b = alb_below_layer[lev]
        src_b = src_below_layer[lev]
        inv = 1.0 / (1.0 - r * alb_b)
        fdn_new = (t * flux_dn + r * src_b + sd) * inv
        is_clear = clear_lay[:, lev][None, None, :]
        fdn_new = jnp.where(is_clear & (~reg0), 0.0, fdn_new)
        fup_new = src_b + fdn_new * alb_b
        next_clear = jnp.where(lev + 1 < nlev,
                               clear_lay[:, jnp.minimum(lev + 1,
                                                        nlev - 1)],
                               True)
        both_clear = (clear_lay[:, lev] & next_clear)[None, None, :]
        fdn_mixed = mix(vm_g[lev + 1], fdn_new)
        fdn_out = jnp.where(both_clear, fdn_new, fdn_mixed)
        return fdn_out, (fup_new, fdn_out)

    _, (fup_hist, fdn_hist) = jax.lax.scan(dn_body, flux_dn0,
                                           jnp.arange(nlev))
    prof = lambda top, hist: jnp.concatenate(
        [top[None], hist.sum(1)], axis=0)        # g-first (nlev+1,ng,ncol)
    up_prof = prof(src_top.sum(0), fup_hist)
    dn_prof = prof(jnp.zeros((ng, ncol), dtype), fdn_hist)
    total = LwFluxes(up=up_prof, dn=dn_prof)

    extras = {}
    if cfg.do_lw_derivatives:
        # region form (radiation_tripleclouds_lw.F90:519-528): surface
        # spectral flux is the region sum of the lowest-interface up-flux
        from .lw_derivatives import lw_derivatives_region
        extras["lw_derivatives"] = lw_derivatives_region(
            trans, um_g, up_prof[-1].T, gfirst=True)

    # ---------------- clear sky (g-first) ---------------------------------
    from .adding import adding_lw, lw_no_scattering_fluxes
    if cfg.do_lw_aerosol_scattering:
        up_c, dn_c = adding_lw(ref_clear, trans_clear, sup_clear,
                               sdn_clear, emission.T, albedo.T,
                               gfirst=True)
    else:
        up_c, dn_c = lw_no_scattering_fluxes(trans_clear, sup_clear,
                                             sdn_clear, emission.T,
                                             albedo.T, gfirst=True)
    clear = LwFluxes(up=up_c, dn=dn_c)
    return total, clear, tcc, extras
