"""SPARTACUS longwave solver.

Reference parity: radiation/radiation_spartacus_lw.F90:50-1083 — the
2*nreg Gamma matrix (diffuse up/dn blocks) with lateral exchange scaled
by the cloud-side effective emissivity (:636-670), emission via the
particular solution of the inhomogeneous two-stream system (:674-712),
matrix exponential -> reflectance/transmittance/source matrices, then
upward albedo/source accumulation (diagonal or full-matrix depending on
do_3d_effects / do_3d_lw_multilayer_effects) and the downward flux pass.

Like the shortwave solver, all matrix algebra keeps the small matrix
dims LEADING with the per-level Gamma exponential evaluated inside a
level scan (see spartacus_sw.py). The per-level batch layout is (ng,
ncol), the column batch minor, as in solvers/adding.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PdfShape, RadiationConfig
from . import two_stream as ts
from .cloudless import LwFluxes
from ..ops.spartacus_reftrans import lw_reftrans_levels
from .matrix import mm_g, mv_g, solve_g, solve_vec_g
from .spartacus_sw import (TAN_DIFFUSE_ANGLE_3D, _diag_g, _diagonal_g,
                           _edge_length, _layer_depth,
                           _zero_cloudy_vec, _zero_offdiag_clear)
from .tripleclouds import calc_overlap_matrices, calc_region_properties

SIDE_EMISS_THIN = 1.4107
LW_DIFFUSIVITY = 1.66


def solver_spartacus_lw(setup, single_level, thermodynamics, cloud,
                        od, ssa, g, od_cloud, ssa_cloud, g_cloud,
                        planck_hl, emission, albedo):
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
    # (nlev+1, nreg, nreg, 1, ncol): batch dims are (ng, ncol) g-first
    um_g = jnp.moveaxis(u_mat, (1, 2, 3), (0, 1, 2))[..., None, :]
    vm_g = jnp.moveaxis(v_mat, (1, 2, 3), (0, 1, 2))[..., None, :]

    dz = _layer_depth(thermodynamics)
    if cloud.inv_cloud_effective_size is not None and cfg.do_3d_effects:
        edge_len = _edge_length(cfg, cloud, reg_fracs)
    else:
        edge_len = jnp.zeros((ncol, nlev, 3), dtype)

    cloudy = cloud.fraction > 0.0
    clear_lay = ~cloudy
    has_3d = cloudy & (edge_len[:, :, 0] > 0.0)

    # --- per-region optical properties, natively g-first ------------------
    # (nlev, ng, ncol) inputs; no output transposes (see the SW solver)
    gf = lambda x: jnp.transpose(x, (1, 2, 0))
    od_g, ssa_g, g_g = gf(od), gf(ssa), gf(g)
    odc = gf(od_cloud)[:, band_from_g, :]
    ssac = gf(ssa_cloud)[:, band_from_g, :]
    gc = gf(g_cloud)[:, band_from_g, :]
    sc_g = jnp.moveaxis(od_scaling, (1, 2), (0, 1))
    cloud_mask = jnp.moveaxis(cloudy, 1, 0)[:, None, :]
    od_list, ssa_list, g_list = [od_g], [ssa_g], [g_g]
    for r in range(1, nreg):
        s = sc_g[:, r][:, None, :]
        odc_r = odc * s
        od_t = jnp.minimum(od_g + odc_r, cfg.max_cloud_od)
        if cfg.do_lw_cloud_scattering:
            scat = ssa_g * od_g + ssac * odc_r
            ssa_t = jnp.where(od_g + odc_r > 0,
                              scat / jnp.maximum(od_g + odc_r, 1e-30),
                              0.0)
            g_t = jnp.where(scat > 0,
                            (g_g * ssa_g * od_g + gc * ssac * odc_r)
                            / jnp.maximum(scat, 1e-30), 0.0)
        else:
            ssa_t = jnp.zeros_like(od_t)
            g_t = jnp.zeros_like(od_t)
        od_list.append(jnp.where(cloud_mask, od_t, od_g))
        ssa_list.append(jnp.where(cloud_mask, ssa_t, 0.0))
        g_list.append(jnp.where(cloud_mask, g_t, 0.0))
    # (nlev, nreg, ng, ncol)
    od_r = jnp.stack(od_list, axis=1)
    ssa_r = jnp.stack(ssa_list, axis=1)
    g_r = jnp.stack(g_list, axis=1)

    # --- lateral transfer rates + side emissivity -------------------------
    eps = 1.2e-7
    tr = jnp.zeros((ncol, nlev, nreg, nreg), dtype)
    for jreg in range(nreg - 1):
        f_up = reg_fracs[:, :, jreg]
        f_dn = reg_fracs[:, :, jreg + 1]
        base = dz * edge_len[:, :, jreg] * TAN_DIFFUSE_ANGLE_3D
        tr = tr.at[:, :, jreg, jreg + 1].set(
            jnp.where(f_up > eps, base / jnp.maximum(f_up, eps), 0.0))
        tr = tr.at[:, :, jreg + 1, jreg].set(
            jnp.where(f_dn > eps, base / jnp.maximum(f_dn, eps), 0.0))
    base3 = dz * edge_len[:, :, 2] * TAN_DIFFUSE_ANGLE_3D
    has3 = edge_len[:, :, 2] > 0.0
    tr = tr.at[:, :, 0, 2].set(
        jnp.where(has3 & (reg_fracs[:, :, 0] > eps),
                  base3 / jnp.maximum(reg_fracs[:, :, 0], eps), 0.0))
    tr = tr.at[:, :, 2, 0].set(
        jnp.where(has3 & (reg_fracs[:, :, 2] > eps),
                  base3 / jnp.maximum(reg_fracs[:, :, 2], eps), 0.0))
    tr = jnp.minimum(tr, cfg.max_3d_transfer_rate)
    tr = jnp.where(has_3d[:, :, None, None], tr, 0.0)
    # (nlev, 3, 3, 1, ncol)
    tr_g = jnp.transpose(tr, (1, 2, 3, 0))[..., None, :]

    # side emissivity in the g-first layout (nlev, ng, ncol);
    # reference :636-655
    if cfg.do_lw_side_emissivity and cfg.do_3d_effects and \
            cloud.inv_cloud_effective_size is not None:
        inv_size = jnp.minimum(cloud.inv_cloud_effective_size,
                               1.0 / cfg.min_cloud_effective_size)
        aspect = 1.0 / jnp.maximum(
            inv_size * reg_fracs[:, :, 0] * dz, 1e-12)     # (ncol, nlev)
        ssa_c = ssa_r[:, 1]                        # region 2 (nlev,ng,ncol)
        g_c = g_r[:, 1]
        abs_od = (od_r[:, 1:] * (1.0 - ssa_r[:, 1:])).sum(axis=1)
        lateral_od = (aspect.T / (nreg - 1.0))[:, None, :] * abs_od
        s1ms = jnp.sqrt(jnp.maximum(1.0 - ssa_c, 0.0))
        thick = 2.0 * s1ms / jnp.maximum(
            s1ms + jnp.sqrt(jnp.maximum(1.0 - ssa_c * g_c, 0.0)), 1e-12)
        side_emiss = (SIDE_EMISS_THIN - thick) / (lateral_od + 1.0) + thick
        active = (has_3d & (reg_fracs[:, :, 0] > 0.0)
                  & (reg_fracs[:, :, 1] > 0.0)).T[:, None, :]
        se_g = jnp.where(active, side_emiss, 1.0)
    else:
        se_g = jnp.ones((nlev, ng, ncol), dtype)

    # planck per level (nlev, ng, ncol)
    planck_top_g = jnp.transpose(planck_hl[:, :-1, :], (1, 2, 0))
    planck_bot_g = jnp.transpose(planck_hl[:, 1:, :], (1, 2, 0))
    # (nlev, nreg, 1, ncol)
    frac_g = jnp.transpose(reg_fracs, (1, 2, 0))[:, :, None, :]

    g_ok_g = od_g <= cfg.max_gas_od_3d
    has_3d_g = jnp.moveaxis(has_3d, 1, 0)[:, None, :]
    use3d_g = ((has_3d_g | cfg.use_expm_everywhere)
               & g_ok_g)                           # (nlev, ng, ncol)
    clear_g = jnp.moveaxis(clear_lay, 1, 0)        # (nlev, ncol)

    # clear-sky per-layer properties
    g1c, g2c = ts.lw_gammas(ssa, g)
    if cfg.do_lw_aerosol_scattering:
        rc, tc, suc, sdc = ts.lw_reftrans(od, g1c, g2c,
                                          planck_hl[:, :-1, :],
                                          planck_hl[:, 1:, :])
    else:
        tc, suc, sdc = ts.lw_no_scattering_transmittance(
            od, planck_hl[:, :-1, :], planck_hl[:, 1:, :])
        rc = jnp.zeros_like(tc)

    clear_prev = jnp.concatenate(
        [jnp.ones((ncol, 1), bool), clear_lay[:, :-1]], axis=1)
    clear_prev_g = jnp.moveaxis(clear_prev, 1, 0)
    use_matrix = cfg.do_3d_effects or cfg.do_3d_lw_multilayer_effects

    # Per-level reflectance/transmittance/sources for ALL levels at
    # once (ops/spartacus_reftrans.py)
    hist = lw_reftrans_levels(
        cfg, nreg, od_r, ssa_r, g_r, tr_g, se_g, planck_top_g,
        planck_bot_g, frac_g, use3d_g, clear_g)

    # ---------------- upward pass -----------------------------------------
    alb0 = _diag_g(jnp.stack([albedo.T] * nreg, 0), nreg)
    # (nreg, ng, ncol)
    src0 = emission.T[None] * reg_fracs[:, -1].T[:, None, :]
    clear_next = jnp.concatenate(
        [clear_lay[:, 1:], jnp.ones((ncol, 1), bool)], axis=1)

    R_h, T_h, SU_h, SD_h = hist

    fields_up = (R_h, T_h, SU_h, SD_h, clear_g,
                 clear_prev_g, um_g[:nlev], vm_g[:nlev])

    def up_body(carry, xs):
        alb, src = carry
        (R, T, SU, SD, cl_l, cl_prev, um, vm) = xs
        if use_matrix:
            denom = -mm_g(alb, R)
            for i in range(nreg):
                denom = denom.at[i, i].add(1.0)
            alb_below = R + mm_g(T, solve_g(denom, mm_g(alb, T)))
            src_below = SU + mv_g(T, solve_vec_g(
                denom, src + mv_g(alb, SD)))
        else:
            Rd = _diagonal_g(R)
            Td = _diagonal_g(T)
            Ad = _diagonal_g(alb)
            inv = 1.0 / (1.0 - Ad * Rd)
            alb_below = _diag_g(Rd + Td * Td * Ad * inv, nreg)
            src_below = SU + Td * (src + Ad * SD) * inv
        is_clear = cl_l[None, :]
        alb_below = _zero_offdiag_clear(alb_below, is_clear)
        src_below = _zero_cloudy_vec(src_below, is_clear)

        both_clear = (cl_l & cl_prev)[None, :]
        src_mixed = mv_g(um, src_below)
        if cfg.do_3d_lw_multilayer_effects:
            alb_mixed = mm_g(mm_g(um, alb_below), vm)
        else:
            diag_vals = mv_g(jnp.swapaxes(vm, 0, 1),
                             _diagonal_g(alb_below))
            alb_mixed = _diag_g(diag_vals, nreg)
        alb_new = jnp.where(both_clear, alb_below, alb_mixed)
        src_new = jnp.where(both_clear, src_below, src_mixed)
        return (alb_new, src_new), (R, T, SD, alb, src)

    # reverse=True sweeps surface->TOA with ys[i] landing at layer i:
    # alb_hist[i] is the albedo below layer i, already in the order the
    # downward pass consumes (no flip copies)
    (alb_top, src_top), (ref, trans, sdn, alb_below_layer,
                         src_below_layer) = jax.lax.scan(
        up_body, (alb0, src0), fields_up, reverse=True)

    # ---------------- downward pass ---------------------------------------
    fdn0 = jnp.zeros((nreg, ng, ncol), dtype)
    clear_next = jnp.concatenate(
        [clear_lay[:, 1:], jnp.ones((ncol, 1), bool)], axis=1)
    fields_dn = (ref, trans, sdn, alb_below_layer, src_below_layer,
                 clear_g, jnp.moveaxis(clear_next, 1, 0), vm_g[1:])

    def dn_body(carry, xs):
        flux_dn = carry
        R, T, SD, alb_b, src_b, cl_l, cl_next, vm = xs
        if use_matrix:
            denom = -mm_g(R, alb_b)
            for i in range(nreg):
                denom = denom.at[i, i].add(1.0)
            rhs = mv_g(T, flux_dn) + mv_g(R, src_b) + SD
            fdn_above = solve_vec_g(denom, rhs)
            fup_above = mv_g(alb_b, fdn_above) + src_b
        else:
            Rd = _diagonal_g(R)
            Td = _diagonal_g(T)
            Ad = _diagonal_g(alb_b)
            fdn_above = (Td * flux_dn + Rd * src_b + SD) / (
                1.0 - Rd * Ad)
            fup_above = src_b + Ad * fdn_above
        is_clear = cl_l[None, :]
        fdn_above = _zero_cloudy_vec(fdn_above, is_clear)
        fup_above = _zero_cloudy_vec(fup_above, is_clear)
        both_clear = (cl_l & cl_next)[None, :]
        fdn_mixed = mv_g(vm, fdn_above)
        fdn_out = jnp.where(both_clear, fdn_above, fdn_mixed)
        return fdn_out, (fup_above, fdn_out)

    _, (fup_hist, fdn_hist) = jax.lax.scan(dn_body, fdn0, fields_dn)

    # g-first (nlev+1, ng, ncol)
    up_prof = jnp.concatenate([src_top.sum(0)[None], fup_hist.sum(1)],
                              axis=0)
    dn_prof = jnp.concatenate([jnp.zeros((1, ng, ncol), dtype),
                               fdn_hist.sum(1)], axis=0)
    return _lw_finish(cfg, up_prof, dn_prof, trans, um_g, rc, tc, suc,
                      sdc, emission, albedo, tcc)


def _lw_finish(cfg, up_prof, dn_prof, trans, um_g, rc, tc, suc, sdc,
               emission, albedo, tcc):
    """LW derivatives + clear-sky adding after the sweeps."""
    total = LwFluxes(up=up_prof, dn=dn_prof)

    extras = {}
    if cfg.do_lw_derivatives:
        # matrix form (radiation_spartacus_lw.F90:1057-1066): propagate
        # the normalized surface spectral flux up through the full layer
        # transmittance matrices and the U overlap at each interface
        from .lw_derivatives import lw_derivatives_matrix
        extras["lw_derivatives"] = lw_derivatives_matrix(
            trans, um_g, up_prof[-1].T, gfirst=True)

    # ---------------- clear sky (g-first) ---------------------------------
    from .adding import adding_lw, lw_no_scattering_fluxes
    from .cloudless import _gf
    if cfg.do_lw_aerosol_scattering:
        up_c, dn_c = adding_lw(_gf(rc), _gf(tc), _gf(suc), _gf(sdc),
                               emission.T, albedo.T, gfirst=True)
    else:
        up_c, dn_c = lw_no_scattering_fluxes(_gf(tc), _gf(suc), _gf(sdc),
                                             emission.T, albedo.T,
                                             gfirst=True)
    clear = LwFluxes(up=up_c, dn=dn_c)
    return total, clear, tcc, extras
