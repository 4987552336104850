"""SPARTACUS shortwave solver: 3-D radiative transfer via matrix
exponentials of region-coupled two-stream operators.

Reference parity: radiation/radiation_spartacus_sw.F90:65-1779 —
cloud edge length from effective size (:434-478), lateral transfer rates
(:560-600), Gamma-matrix assembly over (diffuse up/dn, direct) blocks
(:708-792), matrix exponential -> layer reflectance/transmittance
matrices (:793-830), upward total-albedo accumulation with entrapment
treatments Zero/Edge-only/Explicit/Non-fractal/Maximum (:930-1430
incl. step_migrations for horizontal migration distances), downward flux
pass (:1484-1650).

Mapping: all columns/g-points batched; levels via lax.scan. All
matrix algebra uses the "g-minor" layout (m, n, ng, ncol) — matrix dims
leading, batch dims minor — so every matrix operation is elementwise
over the batch (see solvers/matrix.py mm_g/expm_g/solve_g). The per-layer Gamma
exponentials are evaluated inside the level scan so only one level's
(3*nreg)^2 operator is ever resident. The reference's per-layer ng3D
prefix (g-points ordered by od) becomes a per-(col,g) mask selecting
the matrix-exponential result vs the Meador-Weaver fallback.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Entrapment, PdfShape, RadiationConfig
from ..ops.spartacus_reftrans import (_diag_g, _zero_cloudy_vec,
                                      _zero_offdiag_clear,
                                      sw_reftrans_levels)
from . import two_stream as ts
from .cloudless import SwFluxes
from .matrix import mm_g, mv_g, solve_g, solve_vec_g
from .tripleclouds import calc_overlap_matrices, calc_region_properties

FOUR_OVER_PI = 4.0 / np.pi
R_OVER_G = 287.0 / 9.80665
MIN_MU0_3D = 0.06
# tan of the effective diffuse zenith angle (reference: diffusivity 2 ->
# tan(acos(1/2)) = sqrt(3); radiation_spartacus_sw.F90 tan_diffuse_angle_3d)
# float(): np scalars are STRONG-typed f64 under jax_enable_x64 and
# would promote the f32 scan carries (f64 validation runs)
TAN_DIFFUSE_ANGLE_3D = float(np.sqrt(3.0))


def _edge_length(cfg: RadiationConfig, cloud, reg_fracs):
    """Cloud edge length per interface type (ncol, nlev, 3)
    (radiation_spartacus_sw.F90:434-478)."""
    inv_size = jnp.minimum(cloud.inv_cloud_effective_size,
                           1.0 / cfg.min_cloud_effective_size)
    f1 = reg_fracs[:, :, 0]
    e1 = FOUR_OVER_PI * f1 * (1.0 - f1) * inv_size
    if cloud.inv_inhom_effective_size is not None:
        inv_inhom = jnp.minimum(cloud.inv_inhom_effective_size,
                                1.0 / cfg.min_cloud_effective_size)
    else:
        inv_inhom = inv_size
    f3 = reg_fracs[:, :, 2]
    e2 = FOUR_OVER_PI * f3 * (1.0 - f3) * inv_inhom
    if cfg.clear_to_thick_fraction > 0.0:
        e3 = cfg.clear_to_thick_fraction * jnp.minimum(e1, e2)
        e1 = e1 - e3
        e2 = e2 - e3
    else:
        e3 = jnp.zeros_like(e1)
    active = cloud.inv_cloud_effective_size > 0.0
    zero = jnp.zeros_like(e1)
    return jnp.stack([jnp.where(active, e1, zero),
                      jnp.where(active, e2, zero),
                      jnp.where(active, e3, zero)], axis=-1)


def _layer_depth(thermo):
    p = thermo.pressure_hl
    t = thermo.temperature_hl
    return (R_OVER_G * (p[:, 1:] - p[:, :-1]) * (t[:, :-1] + t[:, 1:])
            / jnp.maximum(p[:, :-1] + p[:, 1:], 1e-3))


def _transfer_rates(cfg, reg_fracs, edge_len, dz, tan_sza):
    """Lateral transfer rates (ncol, nlev, 3, 3) for direct & diffuse
    (radiation_spartacus_sw.F90:560-600). tan_sza: (ncol,)."""
    ncol, nlev, nreg = reg_fracs.shape
    eps = 1.2e-7

    def rates(tan_angle):
        tr = jnp.zeros((ncol, nlev, nreg, nreg), reg_fracs.dtype)
        for jreg in range(nreg - 1):
            f_up = reg_fracs[:, :, jreg]
            f_dn = reg_fracs[:, :, jreg + 1]
            base = dz * edge_len[:, :, jreg] * tan_angle
            tr = tr.at[:, :, jreg, jreg + 1].set(
                jnp.where(f_up > eps, base / jnp.maximum(f_up, eps), 0.0))
            tr = tr.at[:, :, jreg + 1, jreg].set(
                jnp.where(f_dn > eps, base / jnp.maximum(f_dn, eps), 0.0))
        # direct clear<->thick interface
        base3 = dz * edge_len[:, :, 2] * tan_angle
        has3 = edge_len[:, :, 2] > 0.0
        f1 = reg_fracs[:, :, 0]
        f3 = reg_fracs[:, :, 2]
        tr = tr.at[:, :, 0, 2].set(
            jnp.where(has3 & (f1 > eps), base3 / jnp.maximum(f1, eps),
                      0.0))
        tr = tr.at[:, :, 2, 0].set(
            jnp.where(has3 & (f3 > eps), base3 / jnp.maximum(f3, eps),
                      0.0))
        return jnp.minimum(tr, cfg.max_3d_transfer_rate)

    tr_dir = rates(tan_sza[:, None, None, None]
                   if tan_sza.ndim == 1 else tan_sza)
    tr_diff = rates(TAN_DIFFUSE_ANGLE_3D)
    return tr_dir, tr_diff


def _diagonal_g(M):
    """(m, m, *batch) -> (m, *batch) main diagonal."""
    return jnp.stack([M[i, i] for i in range(M.shape[0])], axis=0)


def solver_spartacus_sw(setup, single_level, thermodynamics, cloud,
                        od, ssa, g, od_cloud, ssa_cloud, g_cloud,
                        incoming_sw, albedo_diffuse, albedo_direct):
    cfg: RadiationConfig = setup.config
    band_from_g = setup.spec.band_from_reordered_g_sw
    ncol, nlev, ng = od.shape
    nreg = cfg.nregions
    dtype = od.dtype
    cos_sza = single_level.cos_sza
    mu0 = jnp.maximum(cos_sza, 1e-10)
    one_over_mu0 = 1.0 / mu0
    tan_sza = jnp.where(
        mu0 < MIN_MU0_3D,
        float(np.sqrt(1.0 / (MIN_MU0_3D * MIN_MU0_3D) - 1.0)),
        jnp.where(one_over_mu0 > 1.0,
                  jnp.sqrt(jnp.maximum(one_over_mu0 ** 2 - 1.0
                                       + cfg.overhead_sun_factor, 0.0)),
                  jnp.sqrt(jnp.asarray(cfg.overhead_sun_factor,
                                       dtype))))

    reg_fracs, od_scaling = calc_region_properties(
        nreg, cfg.i_cloud_pdf_shape == PdfShape.GAMMA, cloud.fraction,
        cloud.fractional_std, cfg.cloud_fraction_threshold)
    u_mat, v_mat, tcc = calc_overlap_matrices(
        reg_fracs, cloud.overlap_param, cfg.cloud_inhom_decorr_scaling,
        cfg.cloud_fraction_threshold, cfg.use_beta_overlap)
    # copies for the scans: (nlev+1, nreg, nreg, 1, ncol) — batch dims
    # are (ng, ncol) g-first throughout (see spartacus_lw.py docstring)
    um_g = jnp.moveaxis(u_mat, (1, 2, 3), (0, 1, 2))[..., None, :]
    vm_g = jnp.moveaxis(v_mat, (1, 2, 3), (0, 1, 2))[..., None, :]

    dz = _layer_depth(thermodynamics)             # (ncol, nlev)
    if cloud.inv_cloud_effective_size is not None and cfg.do_3d_effects:
        edge_len = _edge_length(cfg, cloud, reg_fracs)
    else:
        edge_len = jnp.zeros((ncol, nlev, 3), dtype)
    tr_dir, tr_diff = _transfer_rates(cfg, reg_fracs, edge_len, dz,
                                      tan_sza[:, None])
    # no 3D transfer in effectively-overcast 2-region layers
    cloudy = cloud.fraction > 0.0
    has_3d = cloudy & (edge_len[:, :, 0] > 0.0)
    tr_dir = jnp.where(has_3d[:, :, None, None], tr_dir, 0.0)
    tr_diff = jnp.where(has_3d[:, :, None, None], tr_diff, 0.0)
    # (nlev, nreg, nreg, 1, ncol)
    trd_g = jnp.transpose(tr_dir, (1, 2, 3, 0))[..., None, :]
    trf_g = jnp.transpose(tr_diff, (1, 2, 3, 0))[..., None, :]

    # --- per-region optical properties, natively g-first ------------------
    # only the gas-optics inputs are transposed; the per-region loop
    # and the 3D-selection masks run in the (nlev, ng, ncol) layout so
    # no (nlev, nreg, ng, ncol) output transposes are needed (the
    # Tripleclouds rationale, ~10 ms at 2048 columns)
    gfx = lambda x: jnp.transpose(x, (1, 2, 0))    # (nlev, ng, ncol)
    od_g, ssa_g, g_g = gfx(od), gfx(ssa), gfx(g)
    odc = gfx(od_cloud)[:, band_from_g, :]
    ssac = gfx(ssa_cloud)[:, band_from_g, :]
    gc = gfx(g_cloud)[:, band_from_g, :]
    sc_g = jnp.moveaxis(od_scaling, (1, 2), (0, 1))  # (nlev, nreg, ncol)
    cloud_mask = jnp.moveaxis(cloudy, 1, 0)[:, None, :]
    od_list, ssa_list, g_list = [od_g], [ssa_g], [g_g]
    for r in range(1, nreg):
        s = sc_g[:, r][:, None, :]
        odc_r = odc * s
        od_t = jnp.minimum(od_g + odc_r, cfg.max_cloud_od)
        scat = ssa_g * od_g + ssac * odc_r
        ssa_t = jnp.where(od_g + odc_r > 0,
                          scat / jnp.maximum(od_g + odc_r, 1e-30), 0.0)
        g_t = jnp.where(scat > 0,
                        (g_g * ssa_g * od_g + gc * ssac * odc_r)
                        / jnp.maximum(scat, 1e-30), 0.0)
        od_list.append(jnp.where(cloud_mask, od_t, od_g))
        ssa_list.append(jnp.where(cloud_mask, ssa_t, ssa_g))
        g_list.append(jnp.where(cloud_mask, g_t, g_g))
    # (nlev, nreg, ng, ncol)
    od_r = jnp.stack(od_list, axis=1)
    ssa_r = jnp.stack(ssa_list, axis=1)
    g_r = jnp.stack(g_list, axis=1)

    # 3D-selection mask, g-first (nlev, ng, ncol).
    # Sub-horizon columns are excluded like the reference's early
    # cycle (radiation_spartacus_sw.F90:360): their fluxes are zeroed
    # at the end, and running them through expm would put od/mu0 ~
    # 1e11 diagonals into Gamma (mu0 clamped at 1e-10), forcing the
    # max squaring count on every cloudy level's whole batch.
    g_ok_g = od_g <= cfg.max_gas_od_3d
    daylit_g = (cos_sza > 1.0e-10)[None, None, :]
    has_3d_g = jnp.moveaxis(has_3d, 1, 0)[:, None, :]
    use3d_g = ((has_3d_g | cfg.use_expm_everywhere) & g_ok_g
               & daylit_g)                         # (nlev, ng, ncol)
    clear_lay = ~cloudy
    clear_g = jnp.moveaxis(clear_lay, 1, 0)        # (nlev, ncol)

    # clear-sky Meador-Weaver reftrans, vectorized over all levels
    # (elementwise; no scan needed): (ncol, nlev, ng)
    g1c, g2c, g3c = ts.sw_gammas(mu0[:, None, None], ssa, g)
    rc, tc, rdc, tdc, tddc = ts.sw_reftrans(
        mu0[:, None, None], od, ssa, g1c, g2c, g3c)

    clear_prev = jnp.concatenate(
        [jnp.ones((ncol, 1), bool), clear_lay[:, :-1]], axis=1)
    clear_prev_g = jnp.moveaxis(clear_prev, 1, 0)
    inv_eff_prev = jnp.concatenate(
        [cloud.inv_cloud_effective_size[:, :1],
         cloud.inv_cloud_effective_size[:, :-1]], axis=1) \
        if cloud.inv_cloud_effective_size is not None else \
        jnp.zeros((ncol, nlev), dtype)
    overlap_prev = jnp.concatenate(
        [jnp.ones((ncol, 1), dtype), cloud.overlap_param], axis=1)

    entrap = cfg.i_3d_sw_entrapment

    # ---------------- upward pass -----------------------------------------
    alb0 = _diag_g(jnp.stack([albedo_diffuse.T] * nreg, 0), nreg)
    albdir0 = _diag_g(jnp.stack([mu0[None, :] * albedo_direct.T] * nreg,
                                0), nreg)
    x0 = jnp.zeros((nreg, ng, ncol), dtype)

    x_layer_diffuse = dz * TAN_DIFFUSE_ANGLE_3D / float(np.sqrt(2.0))
    x_layer_direct = dz * jnp.sqrt(tan_sza[:, None] ** 2
                                   + TAN_DIFFUSE_ANGLE_3D ** 2) * 0.5

    edge_prev = jnp.concatenate([edge_len[:, :1], edge_len[:, :-1]],
                                axis=1)
    not_top = jnp.arange(nlev) > 0

    # Per-level reflectance/transmittance for ALL levels at once
    # (ops/spartacus_reftrans.py). The five histories cost
    # 45 * nlev * ng * ncol * 4 B of device memory.
    hist = sw_reftrans_levels(
        cfg, nreg, od_r, ssa_r, g_r, trd_g, trf_g, mu0, use3d_g, clear_g)

    clear_next = jnp.concatenate(
        [clear_lay[:, 1:], jnp.ones((ncol, 1), bool)], axis=1)
    # direct0: (nreg, ng, ncol)
    direct0 = incoming_sw.T[None] * reg_fracs[:, 0].T[:, None, :]

    R_h, T_h, RD_h, TD_h, TDD_h = hist

    # Per-level inputs in natural TOA->surface order; the upward scan
    # runs with reverse=True (surface first), so no flip copies are
    # ever materialized, and its per-level outputs land at the right
    # index for the downward pass directly.
    fields_up = (R_h, T_h, RD_h, TD_h, TDD_h,
                 clear_g, clear_prev_g,
                 um_g[:nlev], vm_g[:nlev],
                 jnp.moveaxis(cloud.fraction, 1, 0),
                 jnp.moveaxis(dz, 1, 0),
                 jnp.moveaxis(x_layer_diffuse, 1, 0),
                 jnp.moveaxis(x_layer_direct, 1, 0),
                 jnp.moveaxis(edge_prev, 1, 0),
                 jnp.moveaxis(inv_eff_prev, 1, 0),
                 jnp.moveaxis(overlap_prev, 1, 0),
                 jnp.moveaxis(reg_fracs, 1, 0),
                 jnp.moveaxis(
                     jnp.concatenate([reg_fracs[:, :1], reg_fracs[:, :-1]],
                                     axis=1), 1, 0),
                 not_top)

    def up_body(carry, xs):
        alb, albdir, x_diff, x_dir = carry
        (R, T, RD, TD, TDD, cl_l, cl_prev, um, vm,
         cf_l, dz_l, xld, xldir,
         el_prev_lev, inv_eff_l, ovp_l, rf_l, rf_prev, not_top_l) = xs
        is_clear = cl_l[None, :]
        if entrap in (Entrapment.EXPLICIT,
                      Entrapment.EXPLICIT_NON_FRACTAL):
            x_diff, x_dir = _step_migrations(
                cfg, nreg, cf_l, dz_l, tan_sza, R, T, RD, TDD, TD,
                alb, albdir, x_diff, x_dir, xld, xldir)
        # reference prints migration distances immediately after the
        # step-migration update and BEFORE the overlap conversion
        # (radiation_spartacus_sw.F90:1007-1020)
        x_dir_dump, x_diff_dump = x_dir, x_diff

        both_clear = (cl_l & cl_prev)[None, :]

        # --- accumulate the below-interface albedos -------------------
        denom = -mm_g(alb, R)
        for i in range(nreg):
            denom = denom.at[i, i].add(1.0)
        # one LU for both diffuse and direct right-hand sides
        rhs = jnp.concatenate(
            [mm_g(alb, T), mm_g(albdir, TDD) + mm_g(alb, TD)], axis=1)
        X = mm_g(T, solve_g(denom, rhs))
        alb_below = R + X[:, :nreg]
        albdir_below = RD + X[:, nreg:]
        alb_below = _zero_offdiag_clear(alb_below, is_clear)
        albdir_below = _zero_offdiag_clear(albdir_below, is_clear)

        if entrap == Entrapment.MAXIMUM:
            mixed = mm_g(mm_g(um, alb_below), vm)
            mixed_dir = mm_g(mm_g(um, albdir_below), vm)
        elif entrap == Entrapment.ZERO:
            col_sum = alb_below.sum(axis=0)         # (nreg, ng, ncol)
            mixed = _diag_g(mv_g(jnp.swapaxes(vm, 0, 1), col_sum), nreg)
            col_sum_d = albdir_below.sum(axis=0)
            mixed_dir = _diag_g(mv_g(jnp.swapaxes(vm, 0, 1), col_sum_d),
                                nreg)
        else:
            offdiag = alb_below - _diag_g(_diagonal_g(alb_below), nreg)
            mixed = mm_g(mm_g(um, offdiag), vm)
            offdiag_d = albdir_below - _diag_g(_diagonal_g(albdir_below),
                                               nreg)
            mixed_dir = mm_g(mm_g(um, offdiag_d), vm)
            if entrap == Entrapment.EDGE_ONLY or not cfg.do_3d_effects:
                diag_vals = mv_g(jnp.swapaxes(vm, 0, 1),
                                 _diagonal_g(alb_below))
                mixed = mixed + _diag_g(diag_vals, nreg)
                diag_vals_d = mv_g(jnp.swapaxes(vm, 0, 1),
                                   _diagonal_g(albdir_below))
                mixed_dir = mixed_dir + _diag_g(diag_vals_d, nreg)
            else:
                mixed = mixed + _explicit_entrapment(
                    cfg, nreg, alb_below, x_diff, vm, um, el_prev_lev,
                    inv_eff_l, ovp_l, rf_l, rf_prev, not_top_l, dtype)
                mixed_dir = mixed_dir + _explicit_entrapment(
                    cfg, nreg, albdir_below, x_dir, vm, um, el_prev_lev,
                    inv_eff_l, ovp_l, rf_l, rf_prev, not_top_l, dtype)

        alb_keep = jnp.where(both_clear, alb_below, mixed)
        albdir_keep = jnp.where(both_clear, albdir_below, mixed_dir)

        if entrap in (Entrapment.EXPLICIT,
                      Entrapment.EXPLICIT_NON_FRACTAL):
            x_diff_m = mv_g(jnp.swapaxes(vm, 0, 1), x_diff)
            x_dir_m = mv_g(jnp.swapaxes(vm, 0, 1), x_dir)
            x_diff = jnp.where(both_clear, x_diff, x_diff_m)
            x_dir = jnp.where(both_clear, x_dir, x_dir_m)

        # R/T/TD/TDD are NOT re-emitted: the down pass reads the
        # reftrans histories directly — scan ys are materialized
        # buffers, so re-emitting unchanged xs doubles their HBM writes
        ys = (alb, albdir)
        if cfg.do_print_entrapment_data:
            # migration distances at the top of this layer, g-point 1
            # (PRINT_ENTRAPMENT_DATA fort.101,
            # radiation_spartacus_sw.F90:1007-1020)
            ys = ys + (x_dir_dump[:, 0, :], x_diff_dump[:, 0, :])
        return ((alb_keep, albdir_keep, x_diff, x_dir), ys)

    # reverse=True: sweeps surface->TOA; ys[i] still lands at layer i,
    # so alb_hist[i] IS the albedo below layer i — no flips needed
    (alb_top, albdir_top, _, _), ys_up = jax.lax.scan(
        up_body, (alb0, albdir0, x0, x0), fields_up, reverse=True)
    (alb_below_layer, albdir_below_layer) = ys_up[:2]
    entrap_hist = ys_up[2:]            # (x_dir, x_diff) when captured

    # ---------------- downward pass ---------------------------------------
    fup0 = mv_g(albdir_top, direct0)

    fields_dn = (R_h, T_h, TD_h, TDD_h,
                 alb_below_layer, albdir_below_layer,
                 clear_g, jnp.moveaxis(clear_next, 1, 0), vm_g[1:])

    def dn_body(carry, xs):
        flux_dn, direct_dn = carry     # (nreg, ng, ncol)
        (R, T, TD, TDD, alb_b, albdir_b, cl_l, cl_next, vm) = xs
        # fluxes entering the top of this layer, g-point 1
        # (PRINT_ENTRAPMENT_DATA fort.102, :1486-1497)
        dn_at_top = ((direct_dn[:, 0, :], flux_dn[:, 0, :])
                     if cfg.do_print_entrapment_data else ())
        source_dn = mv_g(TD, direct_dn)
        direct_above = mv_g(TDD, direct_dn)
        denom = -mm_g(R, alb_b)
        for i in range(nreg):
            denom = denom.at[i, i].add(1.0)
        total_source = mv_g(albdir_b, direct_above)
        rhs = mv_g(T, flux_dn) + mv_g(R, total_source) + source_dn
        fdn_above = solve_vec_g(denom, rhs)
        fup_above = mv_g(alb_b, fdn_above) + total_source
        is_clear = cl_l[None, :]
        fdn_above = _zero_cloudy_vec(fdn_above, is_clear)
        fup_above = _zero_cloudy_vec(fup_above, is_clear)
        direct_above = _zero_cloudy_vec(direct_above, is_clear)
        both_clear = (cl_l & cl_next)[None, :]
        fdn_mixed = mv_g(vm, fdn_above)
        ddn_mixed = mv_g(vm, direct_above)
        fdn_out = jnp.where(both_clear, fdn_above, fdn_mixed)
        ddn_out = jnp.where(both_clear, direct_above, ddn_mixed)
        return ((fdn_out, ddn_out),
                (fup_above, fdn_above, direct_above) + dn_at_top)

    (_, _), ys_dn = jax.lax.scan(
        dn_body, (jnp.zeros_like(direct0), direct0), fields_dn)
    (fup_hist, fdn_hist, ddn_hist) = ys_dn[:3]
    entrap_hist = entrap_hist + ys_dn[3:]

    total, clear, tcc = _sw_finish(
        cfg, fup0, fup_hist, fdn_hist, ddn_hist, direct0, mu0, cos_sza,
        incoming_sw, albedo_diffuse, albedo_direct, rc, tc, rdc, tdc,
        tddc, tcc)
    extras = {}
    if cfg.do_print_entrapment_data:
        # (x_direct, x_diffuse, direct_dn, flux_dn), each (nlev, nreg,
        # ncol) at g-point 1 — the reference's fort.101/fort.102 data
        extras["entrapment_data"] = tuple(entrap_hist)
    return total, clear, tcc, extras


def _sw_finish(cfg, fup0, fup_hist, fdn_hist, ddn_hist, direct0, mu0,
               cos_sza, incoming_sw, albedo_diffuse, albedo_direct,
               rc, tc, rdc, tdc, tddc, tcc):
    """Flux profiles + clear-sky adding + daylight masking after the
    sweeps."""
    def profile(top, hist):
        # top (nreg, ng, ncol); hist (nlev, nreg, ng, ncol)
        # -> g-first (nlev+1, ng, ncol)
        return jnp.concatenate([top.sum(0)[None], hist.sum(1)], axis=0)

    up_prof = profile(fup0, fup_hist)
    dn_diff_prof = profile(jnp.zeros_like(fup0), fdn_hist)
    dn_dir_prof = profile(direct0, ddn_hist) * mu0[None, None, :]
    total = SwFluxes(up=up_prof, dn_diffuse=dn_diff_prof,
                     dn_direct=dn_dir_prof)

    # ---------------- clear sky (g-first) ---------------------------------
    from .adding import adding_sw
    from .cloudless import _gf
    up_c, dnd_c, dndir_c = adding_sw(
        _gf(rc), _gf(tc), _gf(rdc), _gf(tdc), _gf(tddc), incoming_sw.T,
        albedo_diffuse.T, albedo_direct.T, mu0, gfirst=True)
    clear = SwFluxes(up=up_c, dn_diffuse=dnd_c, dn_direct=dndir_c)

    daylight = (cos_sza > 1.0e-10)[None, None, :]
    total = SwFluxes(*(jnp.where(daylight, f, 0.0) for f in total))
    clear = SwFluxes(*(jnp.where(daylight, f, 0.0) for f in clear))
    tcc = jnp.where(cos_sza > 1.0e-10, tcc, -1.0)
    return total, clear, tcc


def _step_migrations(cfg, nreg, cloud_frac, dz, tan_sza, R, T, RD, TDD,
                     TD, alb, albdir, x_diffuse, x_direct,
                     x_layer_diffuse, x_layer_direct):
    """Update horizontal migration distances
    (radiation_spartacus_sw.F90 step_migrations). All matrices g-first
    (nreg, nreg, ng, ncol); vectors (nreg, ng, ncol); per-level scalars
    cloud_frac/dz/x_layer_* (ncol,)."""
    xl_diff = x_layer_diffuse[None, None, :]   # (1, 1, ncol)
    xl_dir = x_layer_direct[None, None, :]
    Rd = _diagonal_g(R)
    Td = _diagonal_g(T)
    RDd = _diagonal_g(RD)
    TDDd = _diagonal_g(TDD)
    TDd = _diagonal_g(TD)
    Ad = _diagonal_g(alb)
    ADd = _diagonal_g(albdir)

    ms = Td / jnp.maximum(1.0 - Rd * Ad, 1e-12)
    x_enh = jnp.maximum(1.0 - Rd * Ad, 1e-12) ** (-1.5)

    top_alb_dir = jnp.maximum(1e-8, RDd + ms * (TDd * Ad + TDDd * ADd))
    x_dir_new = jnp.maximum(0.0, xl_dir + (
        (TDd * Ad * x_enh + TDDd * ADd * (x_enh - 1.0))
        * (x_diffuse + xl_diff)
        + TDDd * ADd * (x_direct + xl_dir)) * Td / top_alb_dir)

    top_alb = jnp.maximum(1e-8, Rd + ms * Td * Ad)
    x_diff_new = xl_diff + x_enh * Ad * Td * Td * (
        x_diffuse + xl_diff) / top_alb

    # region activity per reference (cloud_frac bounds)
    frac = cloud_frac[None, None, :]
    act_first = frac < 1.0
    act_cloudy = frac > 0.0
    reg_idx = jnp.arange(nreg)[:, None, None]
    active = jnp.where(reg_idx == 0, act_first, act_cloudy)
    x_dir_new = jnp.where(active, x_dir_new, 0.0)
    x_diff_new = jnp.where(active, x_diff_new, 0.0)
    return x_diff_new, x_dir_new


def _explicit_entrapment(cfg, nreg, alb_below, x_migration, vm, um,
                         edge_prev, inv_eff_lev, overlap_lev, rf_l,
                         rf_prev, not_top, dtype):
    """Explicit/Non-fractal entrapment contribution to the total albedo
    (radiation_spartacus_sw.F90:1160-1330), g-first layout.

    alb_below (nreg, nreg, ng, ncol); x_migration (nreg, ng, ncol);
    vm/um (nreg, nreg, 1, ncol); edge_prev (ncol, 3); inv_eff_lev /
    overlap_lev (ncol,); rf_l/rf_prev (ncol, nreg)."""
    from .matrix import fast_expm_exchange_2_g, fast_expm_exchange_3_g
    entrap_total = 0.0
    inv_eff = jnp.minimum(inv_eff_lev, 1.0 / cfg.min_cloud_effective_size)
    for jreg2 in range(nreg):
        f_this = rf_l[:, jreg2]
        f_prev = rf_prev[:, jreg2]
        transfer_scaling = 1.0 - (1.0 - cfg.overhang_factor) \
            * overlap_lev * jnp.minimum(f_this, f_prev) \
            / jnp.maximum(cfg.cloud_fraction_threshold, f_this)
        transfer_scaling = jnp.where(not_top, transfer_scaling, 0.0)

        rates = []
        for jreg in range(nreg - 1):
            r_fwd = transfer_scaling * edge_prev[:, jreg] \
                / jnp.maximum(um[jreg, jreg2, 0], 1e-5)
            r_bwd = transfer_scaling * edge_prev[:, jreg] \
                / jnp.maximum(um[jreg + 1, jreg2, 0], 1e-5)
            rates.append((r_fwd, r_bwd))

        x2 = x_migration[jreg2]          # (ng, ncol)
        if cfg.i_3d_sw_entrapment == Entrapment.EXPLICIT:
            fractal = 1.0 / jnp.sqrt(jnp.maximum(
                1.0, 2.5 * x2 * inv_eff[None, :]))
        else:
            fractal = 1.0
        a = rates[0][0][None, :] * x2 * fractal   # entrapment(2,1)
        b = rates[0][1][None, :] * x2 * fractal   # entrapment(1,2)
        if nreg == 3:
            c = rates[1][0][None, :] * x2 * fractal
            d = rates[1][1][None, :] * x2 * fractal
            max_entr = jnp.maximum(a, b + c)
            scale = jnp.where(max_entr > cfg.max_cloud_od,
                              cfg.max_cloud_od
                              / jnp.maximum(max_entr, 1e-12), 1.0)
            a, b, c, d = a * scale, b * scale, c * scale, d * scale
            Pg = fast_expm_exchange_3_g(a, b, c, d)  # (3, 3, ng, ncol)
        else:
            max_entr = jnp.maximum(a, b)
            scale = jnp.where(max_entr > cfg.max_cloud_od,
                              cfg.max_cloud_od
                              / jnp.maximum(max_entr, 1e-12), 1.0)
            a, b = a * scale, b * scale
            Pg = fast_expm_exchange_2_g(a, b)

        # albedo_part(j3, j) = P(j3, j) * v(jreg2, j) * alb(jreg2, jreg2)
        albdiag = alb_below[jreg2, jreg2]          # (ng, ncol)
        contrib = Pg * vm[jreg2][None] * albdiag[None, None]
        entrap_total = entrap_total + contrib
    return entrap_total
