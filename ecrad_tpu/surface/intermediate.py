"""Surface boundary conditions and flux partitioning for tiled surfaces.

Reference parity: radsurf/radsurf_intermediate.F90 —
calc_boundary_conditions_sw (:277-562), calc_boundary_conditions_lw
(:567-925), calc_boundary_conditions (:955-1038), partition_fluxes
(:1042-1314). The physics: each tile contributes an effective albedo /
emissivity / emission to the single-level boundary condition seen by the
atmospheric solver (vegetation canopies via a Sellers-like one-layer
two-stream + adding step; urban canyons via SPARTACUS-style wall-exchange
rates folded into two-stream coefficients in physical (z) coordinates),
and after the atmosphere is solved, the downwelling fluxes at canopy top
are partitioned back onto ground / roof / wall facets and canopy
absorption.

All columns are processed at once (the reference loops per
column); the tile loop is a static python loop over the (small, static)
tuple of tile representations, so each tile type's branch is traced once
with masked math instead of `select case` control flow.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np
from ..pytree import pytree_dataclass

from ..constants import STEFAN_BOLTZMANN
from ..solvers.two_stream import (LW_DIFFUSIVITY, lw_gammas,
                                  lw_reftrans_isothermal, sw_gammas,
                                  sw_reftrans, sw_reftrans_z)
from .flux import SurfaceFlux
from .properties import (ITileFlat, ITileUrban3D, ITileVegetation,
                         SurfaceDescription)


@pytree_dataclass
class SurfaceIntermediate:
    """Facet/region radiative properties stored between the boundary-
    condition and partitioning stages (radsurf_intermediate.F90:27-106).

    Facet arrays are (ncol, nfacet, nbands); region arrays are
    (ncol, nregion, nbands) with the spectral dimension innermost.
    """
    # facet properties
    planck_facet: Optional[jnp.ndarray] = None
    lw_emissivity: Optional[jnp.ndarray] = None
    sw_albedo_direct: Optional[jnp.ndarray] = None
    sw_albedo_diffuse: Optional[jnp.ndarray] = None
    # region (canopy volume) properties
    planck_region: Optional[jnp.ndarray] = None
    sw_ref_dif: Optional[jnp.ndarray] = None
    sw_tra_dif: Optional[jnp.ndarray] = None
    sw_ref_dir: Optional[jnp.ndarray] = None
    sw_tra_dir_dif: Optional[jnp.ndarray] = None
    sw_tra_dir_dir: Optional[jnp.ndarray] = None
    sw_wall_abs_dir: Optional[jnp.ndarray] = None
    sw_air_abs_dir: Optional[jnp.ndarray] = None
    sw_wall_abs_frac_dif: Optional[jnp.ndarray] = None
    sw_albedo_diffuse_reg: Optional[jnp.ndarray] = None
    sw_albedo_direct_reg: Optional[jnp.ndarray] = None
    lw_reflectance: Optional[jnp.ndarray] = None
    lw_transmittance: Optional[jnp.ndarray] = None
    lw_source: Optional[jnp.ndarray] = None
    lw_wall_abs_frac: Optional[jnp.ndarray] = None
    lw_total_wall_emission: Optional[jnp.ndarray] = None
    lw_total_canopy_emission: Optional[jnp.ndarray] = None


def _facet_albedos_sw(setup, surface: SurfaceDescription):
    """Per-facet SW albedo at canopy spectral resolution.

    Returns (diffuse, direct), each (ncol, nfacet, nswbands).
    Reference: radsurf_intermediate.F90:356-377.
    """
    cfg = setup.config
    alb = surface.sw_albedo                      # (ncol, nfacet, nalb)
    alb_dir = (surface.sw_albedo_direct
               if surface.sw_albedo_direct is not None else alb)
    if cfg.use_canopy_full_spectrum_sw:
        from ..optics.spectral_mapping import expand_to_g
        band_g = setup.spec.band_from_reordered_g_sw
        ncol, nfacet, nalb = alb.shape
        diffuse = expand_to_g(alb.reshape(ncol * nfacet, nalb),
                              setup.sw_albedo_map, setup.sw_albedo_weights,
                              band_g).reshape(ncol, nfacet, -1)
        direct = expand_to_g(alb_dir.reshape(ncol * nfacet, nalb),
                             setup.sw_albedo_map, setup.sw_albedo_weights,
                             band_g).reshape(ncol, nfacet, -1)
        return diffuse, direct
    return alb, alb_dir


def _facet_emissivity_planck_lw(setup, surface: SurfaceDescription):
    """Per-facet LW emissivity and Planck emission, plus per-tile canopy
    (region) Planck, at canopy spectral resolution.

    Returns (emissivity (ncol,nfacet,nlw), planck_facet (ncol,nfacet,nlw),
    planck_canopy_tile (ncol,ntile,nlw)).
    Reference: radsurf_intermediate.F90:646-696. In the broadband branch
    the reference computes the region Planck as sigma*T (a missing **4,
    radsurf_intermediate.F90:692); we use sigma*T^4.
    """
    cfg = setup.config
    emiss = surface.lw_emissivity                      # (ncol,nfacet,nem)
    skin_t = surface.skin_temperature                  # (ncol, nfacet)
    canopy_t = (surface.canopy_temperature
                if surface.canopy_temperature is not None
                else skin_t[:, :1] * jnp.ones((1, surface.ntile)))
    if cfg.use_canopy_full_spectrum_lw:
        from ..optics.rrtmg.gas_optics import _planck_store
        from ..optics.spectral_mapping import expand_to_g
        t = setup.tables
        band_g = setup.spec.band_from_reordered_g_lw
        ncol, nfacet, nem = emiss.shape
        emiss_g = expand_to_g(emiss.reshape(ncol * nfacet, nem),
                              setup.lw_emiss_map, setup.lw_emiss_weights,
                              band_g).reshape(ncol, nfacet, -1)
        totplnk = jnp.asarray(t["totplnk"], emiss.dtype)
        delwave = jnp.asarray(t["delwave"], emiss.dtype)
        # Fixed per-g Planck fractions for surfaces without a gas profile
        # (radiation_ifs_rrtm.F90:809-849), in reordered-g space.
        pfrac = jnp.asarray(
            np.asarray(t["lw_fixed_pfrac"])[
                np.asarray(setup.spec.g_from_reordered_g_lw)],
            emiss.dtype)
        pb_facet = _planck_store(skin_t, totplnk, delwave)  # (ncol,nf,16)
        planck_facet = pb_facet[:, :, band_g] * pfrac
        pb_can = _planck_store(canopy_t, totplnk, delwave)
        planck_canopy = pb_can[:, :, band_g] * pfrac
        return emiss_g, planck_facet, planck_canopy
    if surface.nemissbands != 1:
        raise ValueError("broadband canopy LW requires one emissivity band"
                         " (radsurf_intermediate.F90:674-677)")
    planck_facet = (STEFAN_BOLTZMANN * skin_t ** 4)[:, :, None]
    planck_canopy = (STEFAN_BOLTZMANN * canopy_t ** 4)[:, :, None]
    return emiss, planck_facet, planck_canopy


class BoundaryConditions(NamedTuple):
    """Effective single-level boundary condition from the tiled surface."""
    sw_albedo_diffuse: jnp.ndarray   # (ncol, nswbands)
    sw_albedo_direct: jnp.ndarray    # (ncol, nswbands)
    lw_emissivity: jnp.ndarray       # (ncol, nlwbands)
    lw_emission: jnp.ndarray         # (ncol, nlwbands) W m-2
    intermediate: SurfaceIntermediate


def calc_boundary_conditions(setup, surface: SurfaceDescription,
                             cos_sza: jnp.ndarray,
                             ext_sw_air: Optional[jnp.ndarray] = None,
                             ssa_sw_air: Optional[jnp.ndarray] = None,
                             g_sw_air: Optional[jnp.ndarray] = None,
                             ext_lw_air: Optional[jnp.ndarray] = None,
                             ) -> BoundaryConditions:
    """Fold the tiled surface into an effective albedo/emissivity/emission.

    Reference: radsurf_intermediate.F90:277-925. The optional *_air
    arguments are lowest-model-level extinction properties (m-1) at
    canopy spectral resolution, (ncol, nbands), enabling gas absorption
    inside canopies (do_canopy_gases_*).
    """
    alb_diff, alb_dir = _facet_albedos_sw(setup, surface)
    emiss, planck_facet, planck_canopy_t = _facet_emissivity_planck_lw(
        setup, surface)
    ncol = surface.ncol
    n_sw = alb_diff.shape[-1]
    n_lw = emiss.shape[-1]
    dtype = alb_diff.dtype
    nregion = max(surface.nregion, 1)

    ground_i, roof_i, wall_i, region_i = surface.indices()

    if surface.is_simple:
        inter = SurfaceIntermediate(
            planck_facet=planck_facet, lw_emissivity=emiss,
            sw_albedo_direct=alb_dir, sw_albedo_diffuse=alb_diff)
        return BoundaryConditions(
            sw_albedo_diffuse=alb_diff[:, 0, :],
            sw_albedo_direct=alb_dir[:, 0, :],
            lw_emissivity=emiss[:, 0, :],
            lw_emission=emiss[:, 0, :] * planck_facet[:, 0, :],
            intermediate=inter)

    # accumulated boundary condition
    sw_albedo = jnp.zeros((ncol, n_sw), dtype)
    sw_albedo_dir = jnp.zeros((ncol, n_sw), dtype)
    lw_emissivity = jnp.zeros((ncol, n_lw), dtype)
    lw_emission = jnp.zeros((ncol, n_lw), dtype)

    # region-indexed intermediate fields
    def zr(n):
        return jnp.zeros((ncol, nregion, n), dtype)

    sw_ref_dif, sw_tra_dif = zr(n_sw), zr(n_sw)
    sw_ref_dir, sw_tra_dir_dif, sw_tra_dir_dir = zr(n_sw), zr(n_sw), zr(n_sw)
    sw_wall_abs_dir, sw_air_abs_dir = zr(n_sw), zr(n_sw)
    sw_wall_abs_frac_dif = zr(n_sw)
    sw_alb_dif_reg, sw_alb_dir_reg = zr(n_sw), zr(n_sw)
    lw_ref, lw_tra, lw_src = zr(n_lw), zr(n_lw), zr(n_lw)
    lw_wall_abs_frac = zr(n_lw)
    lw_wall_emis_tot, lw_can_emis_tot = zr(n_lw), zr(n_lw)
    planck_region = zr(n_lw)

    mu0 = jnp.maximum(cos_sza, 1.0e-6)[:, None]     # guard sun-down cols

    for jtile, rep in enumerate(surface.representation):
        frac = surface.tile_fraction[:, jtile][:, None]   # (ncol, 1)
        ig = ground_i[jtile]

        if rep == ITileFlat:
            sw_albedo = sw_albedo + frac * alb_diff[:, ig, :]
            sw_albedo_dir = sw_albedo_dir + frac * alb_dir[:, ig, :]
            lw_emissivity = lw_emissivity + frac * emiss[:, ig, :]
            lw_emission = lw_emission + frac * (
                planck_facet[:, ig, :] * emiss[:, ig, :])
            continue

        ir = region_i[jtile]
        depth = surface.canopy_depth[:, jtile][:, None]

        if rep == ITileVegetation:
            # --- SW: Sellers-like one-layer canopy + adding -------------
            veg_od = surface.vegetation_optical_depth[:, jtile][:, None]
            veg_alb = surface.vegetation_sw_albedo[:, jtile, :]
            if veg_alb.shape[-1] != n_sw:
                veg_alb = _expand_sw(setup, veg_alb, n_sw)
            if ext_sw_air is not None:
                od_air = depth * ext_sw_air
                od_reg = od_air + veg_od
                ssa_reg = (ssa_sw_air * od_air + veg_od * veg_alb) \
                    / jnp.maximum(od_reg, 1e-12)
                g_reg = (g_sw_air * ssa_sw_air * od_air
                         / jnp.maximum(ssa_reg * od_reg, 1e-12))
            else:
                od_reg = veg_od * jnp.ones((1, n_sw), dtype)
                ssa_reg = veg_alb * jnp.ones_like(od_reg)
                g_reg = jnp.zeros_like(od_reg)
            ssa_reg = jnp.clip(ssa_reg, 0.0, 1.0)
            g1, g2, g3 = sw_gammas(mu0, ssa_reg, g_reg)
            rdif, tdif, rdir, tdirdif, tdirdir = sw_reftrans(
                mu0, od_reg, ssa_reg, g1, g2, g3)
            inv_den = 1.0 / (1.0 - alb_diff[:, ig, :] * rdif)
            alb_dif_r = rdif + tdif ** 2 * alb_diff[:, ig, :] * inv_den
            alb_dir_r = rdir + (tdirdir * alb_dir[:, ig, :]
                                + tdirdif * alb_diff[:, ig, :]) \
                * tdif * inv_den
            sw_albedo = sw_albedo + frac * alb_dif_r
            sw_albedo_dir = sw_albedo_dir + frac * alb_dir_r

            sw_ref_dif = sw_ref_dif.at[:, ir, :].set(rdif)
            sw_tra_dif = sw_tra_dif.at[:, ir, :].set(tdif)
            sw_ref_dir = sw_ref_dir.at[:, ir, :].set(rdir)
            sw_tra_dir_dif = sw_tra_dir_dif.at[:, ir, :].set(tdirdif)
            sw_tra_dir_dir = sw_tra_dir_dir.at[:, ir, :].set(tdirdir)
            sw_alb_dif_reg = sw_alb_dif_reg.at[:, ir, :].set(alb_dif_r)
            sw_alb_dir_reg = sw_alb_dir_reg.at[:, ir, :].set(alb_dir_r)

            # --- LW ------------------------------------------------------
            veg_emiss = surface.vegetation_lw_emissivity[:, jtile, :]
            if veg_emiss.shape[-1] != n_lw:
                veg_emiss = _expand_lw(setup, veg_emiss, n_lw)
            if ext_lw_air is not None:
                od_air_lw = depth * ext_lw_air
                od_reg_lw = od_air_lw + veg_od
                ssa_reg_lw = veg_od * (1.0 - veg_emiss) \
                    / jnp.maximum(od_reg_lw, 1e-12)
            else:
                od_reg_lw = veg_od * jnp.ones((1, n_lw), dtype)
                ssa_reg_lw = 1.0 - veg_emiss
            g_reg_lw = jnp.zeros_like(ssa_reg_lw)
            pl_canopy = planck_canopy_t[:, jtile, :]
            g1l, g2l = lw_gammas(jnp.clip(ssa_reg_lw, 0.0, 1.0), g_reg_lw)
            ref_l, tra_l, src_l = lw_reftrans_isothermal(
                od_reg_lw, g1l, g2l, pl_canopy)
            inv_den_lw = 1.0 / (1.0 - (1.0 - emiss[:, ig, :]) * ref_l)
            lw_emissivity = lw_emissivity + frac * (
                1.0 - (ref_l + tra_l ** 2 * (1.0 - emiss[:, ig, :])
                       * inv_den_lw))
            lw_emission = lw_emission + frac * (
                src_l * (1.0 + inv_den_lw * (1.0 - emiss[:, ig, :]) * tra_l)
                + planck_facet[:, ig, :] * emiss[:, ig, :] * tra_l
                * inv_den_lw)
            lw_ref = lw_ref.at[:, ir, :].set(ref_l)
            lw_tra = lw_tra.at[:, ir, :].set(tra_l)
            lw_src = lw_src.at[:, ir, :].set(src_l)
            planck_region = planck_region.at[:, ir, :].set(pl_canopy)
            continue

        # ---- ITileUrban3D: SPARTACUS-style street canyon ----------------
        iw, irf = wall_i[jtile], roof_i[jtile]
        bfrac = surface.building_fraction[:, jtile][:, None]
        bperim = surface.building_normalized_perimeter[:, jtile][:, None]
        canyon = jnp.maximum(1.0 - bfrac, 1.0e-6)
        fdiff = 0.5 * bperim / canyon
        tan_sza = jnp.sqrt(jnp.maximum(1.0 / (mu0 * mu0) - 1.0, 0.0))
        fdir = bperim * tan_sza / (math.pi * canyon)

        # --- SW: wall-exchange rates folded into z-coordinate two-stream
        # (radsurf_intermediate.F90:478-528)
        if ext_sw_air is not None:
            ext_r, ssa_r, g_r = ext_sw_air, ssa_sw_air, g_sw_air
        else:
            z = jnp.zeros((ncol, n_sw), dtype)
            ext_r, ssa_r, g_r = z, z, z
        g1, g2, g3 = sw_gammas(mu0, ssa_r, g_r)
        wall_dif = fdiff * (1.0 - alb_diff[:, iw, :])
        wall_abs_frac_dif = wall_dif / jnp.maximum(
            1.0e-8, ext_r * (g1 - g2) + wall_dif)
        gamma0 = ext_r / mu0 + fdir
        gamma1 = ext_r * g1 + fdiff * (1.0 - 0.5 * alb_diff[:, iw, :])
        gamma2 = ext_r * g2 + fdiff * 0.5 * alb_diff[:, iw, :]
        gamma3 = ext_r * ssa_r * g3 + 0.5 * fdir * alb_dir[:, iw, :]
        # The reference passes gamma3 for both the gamma3 and gamma4
        # arguments (radsurf_intermediate.F90:513-515); replicated here.
        rdif, tdif, rdir, tdirdif, tdirdir = sw_reftrans_z(
            mu0, depth, gamma0, gamma1, gamma2, gamma3, gamma3)
        rdif = jnp.clip(rdif, 0.0, 1.0)
        tdif = jnp.clip(tdif, 0.0, 1.0)
        rdir = jnp.clip(rdir, 0.0, 1.0)
        tdirdif = jnp.clip(tdirdif, 0.0, 1.0)

        wall_abs_dir = ((1.0 - tdirdir) * fdir
                        * (1.0 - alb_dir[:, iw, :]) * mu0
                        / jnp.maximum(1.0e-8, fdir * mu0 + ext_r))
        air_abs_dir = ((1.0 - tdirdir) * ext_r * (1.0 - ssa_r)
                       / jnp.maximum(1.0e-8, fdir * mu0 + ext_r))

        # roof contribution
        sw_albedo = sw_albedo + frac * bfrac * alb_diff[:, irf, :]
        sw_albedo_dir = sw_albedo_dir + frac * bfrac * alb_dir[:, irf, :]
        # canyon contribution via single-layer adding
        inv_den = 1.0 / (1.0 - alb_diff[:, ig, :] * rdif)
        alb_dif_r = rdif + tdif ** 2 * alb_diff[:, ig, :] * inv_den
        alb_dir_r = rdir + (tdirdir * alb_dir[:, ig, :]
                            + tdirdif * alb_diff[:, ig, :]) * tdif * inv_den
        sw_albedo = sw_albedo + frac * canyon * alb_dif_r
        sw_albedo_dir = sw_albedo_dir + frac * canyon * alb_dir_r

        sw_ref_dif = sw_ref_dif.at[:, ir, :].set(rdif)
        sw_tra_dif = sw_tra_dif.at[:, ir, :].set(tdif)
        sw_ref_dir = sw_ref_dir.at[:, ir, :].set(rdir)
        sw_tra_dir_dif = sw_tra_dir_dif.at[:, ir, :].set(tdirdif)
        sw_tra_dir_dir = sw_tra_dir_dir.at[:, ir, :].set(tdirdir)
        sw_wall_abs_dir = sw_wall_abs_dir.at[:, ir, :].set(wall_abs_dir)
        sw_air_abs_dir = sw_air_abs_dir.at[:, ir, :].set(air_abs_dir)
        sw_wall_abs_frac_dif = sw_wall_abs_frac_dif.at[:, ir, :].set(
            wall_abs_frac_dif)
        sw_alb_dif_reg = sw_alb_dif_reg.at[:, ir, :].set(alb_dif_r)
        sw_alb_dir_reg = sw_alb_dir_reg.at[:, ir, :].set(alb_dir_r)

        # --- LW: canyon as isothermal layer with wall optical depth
        # from the Harman et al. (2004) street-to-sky transmittance
        # (radsurf_intermediate.F90:816-823)
        hw = 0.5 * bperim * depth / canyon
        od_wall = -jnp.log(jnp.sqrt(hw * hw + 1.0) - hw) / LW_DIFFUSIVITY
        if ext_lw_air is not None:
            od_air_lw = ext_lw_air * depth
            od_reg_lw = od_air_lw + od_wall
            ssa_reg_lw = od_wall * (1.0 - emiss[:, iw, :]) \
                / jnp.maximum(od_reg_lw, 1.0e-6)
            wall_emis_tot = (LW_DIFFUSIVITY * od_wall * emiss[:, iw, :]
                             * planck_facet[:, iw, :])
            can_emis_tot = (LW_DIFFUSIVITY * od_air_lw
                            * planck_canopy_t[:, jtile, :])
            pl_canopy = (wall_emis_tot + can_emis_tot) / jnp.maximum(
                od_reg_lw * (1.0 - ssa_reg_lw) * LW_DIFFUSIVITY, 1.0e-6)
            wall_abs_frac = od_wall * emiss[:, iw, :] / jnp.maximum(
                od_reg_lw * (1.0 - ssa_reg_lw), 1.0e-6)
        else:
            od_reg_lw = od_wall * jnp.ones((1, n_lw), dtype)
            ssa_reg_lw = 1.0 - emiss[:, iw, :]
            wall_abs_frac = jnp.ones((ncol, n_lw), dtype)
            wall_emis_tot = (LW_DIFFUSIVITY * od_wall * emiss[:, iw, :]
                             * planck_facet[:, iw, :])
            can_emis_tot = jnp.zeros((ncol, n_lw), dtype)
            pl_canopy = planck_facet[:, iw, :]
        g1l, g2l = lw_gammas(jnp.clip(ssa_reg_lw, 0.0, 1.0),
                             jnp.zeros_like(ssa_reg_lw))
        ref_l, tra_l, src_l = lw_reftrans_isothermal(
            od_reg_lw, g1l, g2l, pl_canopy)

        # roof contribution
        lw_emissivity = lw_emissivity + frac * bfrac * emiss[:, irf, :]
        lw_emission = lw_emission + frac * bfrac * (
            emiss[:, irf, :] * planck_facet[:, irf, :])
        # canyon contribution
        inv_den_lw = 1.0 / (1.0 - (1.0 - emiss[:, ig, :]) * ref_l)
        emiss_region = 1.0 - (ref_l + tra_l ** 2 * (1.0 - emiss[:, ig, :])
                              * inv_den_lw)
        emission_region = (
            src_l * (1.0 + inv_den_lw * (1.0 - emiss[:, ig, :]) * tra_l)
            + planck_facet[:, ig, :] * emiss[:, ig, :] * tra_l * inv_den_lw)
        lw_emissivity = lw_emissivity + frac * canyon * emiss_region
        lw_emission = lw_emission + frac * canyon * emission_region

        lw_ref = lw_ref.at[:, ir, :].set(ref_l)
        lw_tra = lw_tra.at[:, ir, :].set(tra_l)
        lw_src = lw_src.at[:, ir, :].set(src_l)
        lw_wall_abs_frac = lw_wall_abs_frac.at[:, ir, :].set(wall_abs_frac)
        lw_wall_emis_tot = lw_wall_emis_tot.at[:, ir, :].set(wall_emis_tot)
        lw_can_emis_tot = lw_can_emis_tot.at[:, ir, :].set(can_emis_tot)
        planck_region = planck_region.at[:, ir, :].set(pl_canopy)

    inter = SurfaceIntermediate(
        planck_facet=planck_facet, lw_emissivity=emiss,
        sw_albedo_direct=alb_dir, sw_albedo_diffuse=alb_diff,
        planck_region=planck_region,
        sw_ref_dif=sw_ref_dif, sw_tra_dif=sw_tra_dif, sw_ref_dir=sw_ref_dir,
        sw_tra_dir_dif=sw_tra_dir_dif, sw_tra_dir_dir=sw_tra_dir_dir,
        sw_wall_abs_dir=sw_wall_abs_dir, sw_air_abs_dir=sw_air_abs_dir,
        sw_wall_abs_frac_dif=sw_wall_abs_frac_dif,
        sw_albedo_diffuse_reg=sw_alb_dif_reg,
        sw_albedo_direct_reg=sw_alb_dir_reg,
        lw_reflectance=lw_ref, lw_transmittance=lw_tra, lw_source=lw_src,
        lw_wall_abs_frac=lw_wall_abs_frac,
        lw_total_wall_emission=lw_wall_emis_tot,
        lw_total_canopy_emission=lw_can_emis_tot)
    return BoundaryConditions(
        sw_albedo_diffuse=jnp.clip(sw_albedo, 0.0, 1.0),
        sw_albedo_direct=jnp.clip(sw_albedo_dir, 0.0, 1.0),
        lw_emissivity=jnp.clip(lw_emissivity, 0.0, 1.0),
        lw_emission=lw_emission, intermediate=inter)


def _expand_sw(setup, values, n_sw):
    from ..optics.spectral_mapping import expand_to_g
    return expand_to_g(values, setup.sw_albedo_map, setup.sw_albedo_weights,
                       setup.spec.band_from_reordered_g_sw)


def _expand_lw(setup, values, n_lw):
    from ..optics.spectral_mapping import expand_to_g
    return expand_to_g(values, setup.lw_emiss_map, setup.lw_emiss_weights,
                       setup.spec.band_from_reordered_g_lw)


def partition_fluxes(surface: SurfaceDescription,
                     inter: SurfaceIntermediate,
                     flux) -> SurfaceFlux:
    """Distribute canopy-top downwelling fluxes onto facets.

    Reference: radsurf_intermediate.F90:1042-1314. `flux` must carry the
    canopy-resolution surface downwelling fields lw_dn_surf_canopy,
    sw_dn_diffuse_surf_canopy, sw_dn_direct_surf_canopy plus the broadband
    lw_dn/lw_up/sw_dn/sw_dn_direct/sw_up profiles.
    """
    ncol = surface.ncol
    nfacet, ntile = surface.nfacet, surface.ntile
    dtype = inter.sw_albedo_diffuse.dtype
    ground_i, roof_i, wall_i, region_i = surface.indices()

    lw_dn_f = jnp.zeros((ncol, nfacet), dtype)
    lw_up_f = jnp.zeros((ncol, nfacet), dtype)
    lw_abs_c = jnp.zeros((ncol, ntile), dtype)
    sw_dn_f = jnp.zeros((ncol, nfacet), dtype)
    sw_dn_dir_f = jnp.zeros((ncol, nfacet), dtype)
    sw_up_f = jnp.zeros((ncol, nfacet), dtype)
    sw_abs_c = jnp.zeros((ncol, ntile), dtype)

    lw_dn_surf = flux.lw_dn[:, -1] if flux.lw_dn is not None else None
    lw_up_surf = flux.lw_up[:, -1] if flux.lw_up is not None else None
    sw_dn_surf = flux.sw_dn[:, -1] if flux.sw_dn is not None else None
    sw_dn_dir_surf = (flux.sw_dn_direct[:, -1]
                      if flux.sw_dn_direct is not None else None)
    sw_up_surf = flux.sw_up[:, -1] if flux.sw_up is not None else None
    lw_dn_can = flux.lw_dn_surf_canopy          # (ncol, nlwbands)
    sw_dn_dif_can = flux.sw_dn_diffuse_surf_canopy
    sw_dn_dir_can = flux.sw_dn_direct_surf_canopy
    do_lw = lw_dn_can is not None
    do_sw = sw_dn_dif_can is not None

    for jtile, rep in enumerate(surface.representation):
        ig = ground_i[jtile]
        if rep == ITileFlat:
            if do_lw:
                lw_dn_f = lw_dn_f.at[:, ig].set(lw_dn_surf)
                lw_up_f = lw_up_f.at[:, ig].set((
                    inter.lw_emissivity[:, ig, :]
                    * inter.planck_facet[:, ig, :]
                    + (1.0 - inter.lw_emissivity[:, ig, :]) * lw_dn_can
                ).sum(-1))
            if do_sw:
                sw_dn_f = sw_dn_f.at[:, ig].set(sw_dn_surf)
                sw_dn_dir_f = sw_dn_dir_f.at[:, ig].set(sw_dn_dir_surf)
                sw_up_f = sw_up_f.at[:, ig].set((
                    inter.sw_albedo_diffuse[:, ig, :] * sw_dn_dif_can
                    + inter.sw_albedo_direct[:, ig, :] * sw_dn_dir_can
                ).sum(-1))
            continue

        ir = region_i[jtile]
        if do_lw:
            # downwelling below the canopy at each spectral point
            lw_dn_g = ((inter.lw_transmittance[:, ir, :] * lw_dn_can
                        + inter.lw_reflectance[:, ir, :]
                        * inter.lw_emissivity[:, ig, :]
                        * inter.planck_facet[:, ig, :]
                        + inter.lw_source[:, ir, :])
                       / (1.0 - (1.0 - inter.lw_emissivity[:, ig, :])
                          * inter.lw_reflectance[:, ir, :]))
            lw_up_g = ((1.0 - inter.lw_emissivity[:, ig, :]) * lw_dn_g
                       + inter.lw_emissivity[:, ig, :]
                       * inter.planck_facet[:, ig, :])
            lw_dn_f = lw_dn_f.at[:, ig].set(lw_dn_g.sum(-1))
            lw_up_f = lw_up_f.at[:, ig].set(lw_up_g.sum(-1))
        if do_sw:
            sw_dn_direct_g = (inter.sw_tra_dir_dir[:, ir, :]
                              * sw_dn_dir_can)
            sw_up_g = sw_dn_direct_g * inter.sw_albedo_direct[:, ig, :]
            sw_dn_diffuse_g = ((inter.sw_tra_dif[:, ir, :] * sw_dn_dif_can
                                + inter.sw_ref_dif[:, ir, :] * sw_up_g
                                + inter.sw_tra_dir_dif[:, ir, :]
                                * sw_dn_dir_can)
                               / (1.0 - inter.sw_albedo_diffuse[:, ig, :]
                                  * inter.sw_ref_dif[:, ir, :]))
            sw_up_g = sw_up_g + sw_dn_diffuse_g \
                * inter.sw_albedo_diffuse[:, ig, :]
            sw_dn_dir_f = sw_dn_dir_f.at[:, ig].set(sw_dn_direct_g.sum(-1))
            sw_dn_f = sw_dn_f.at[:, ig].set(
                sw_dn_direct_g.sum(-1) + sw_dn_diffuse_g.sum(-1))
            sw_up_f = sw_up_f.at[:, ig].set(sw_up_g.sum(-1))

        if rep == ITileVegetation:
            if do_lw:
                lw_abs_c = lw_abs_c.at[:, jtile].set(
                    lw_dn_surf - lw_up_surf
                    - lw_dn_f[:, ig] + lw_up_f[:, ig])
            if do_sw:
                sw_abs_c = sw_abs_c.at[:, jtile].set(
                    sw_dn_surf - sw_up_surf
                    - sw_dn_f[:, ig] + sw_up_f[:, ig])
            continue

        # ---- Urban3D roof and wall fluxes -------------------------------
        irf, iw = roof_i[jtile], wall_i[jtile]
        wall_scaling = (1.0 - surface.building_fraction[:, jtile]) \
            / jnp.maximum(1.0e-4,
                          surface.building_normalized_perimeter[:, jtile]
                          * surface.canopy_depth[:, jtile])
        if do_sw:
            sw_dn_f = sw_dn_f.at[:, irf].set(sw_dn_surf)
            sw_dn_dir_f = sw_dn_dir_f.at[:, irf].set(sw_dn_dir_surf)
            sw_up_f = sw_up_f.at[:, irf].set((
                inter.sw_albedo_diffuse[:, irf, :] * sw_dn_dif_can
                + inter.sw_albedo_direct[:, irf, :] * sw_dn_dir_can
            ).sum(-1))
            # wall: direct interception
            denom_dir = 1.0 - inter.sw_albedo_direct[:, iw, :]
            sw_abs_g = sw_dn_dir_can * inter.sw_wall_abs_dir[:, ir, :]
            sw_dn_dir_f = sw_dn_dir_f.at[:, iw].set(
                wall_scaling * (sw_abs_g
                                / jnp.maximum(denom_dir, 1e-6)).sum(-1))
            sw_up_f = sw_up_f.at[:, iw].set(
                wall_scaling * (sw_abs_g * inter.sw_albedo_direct[:, iw, :]
                                / jnp.maximum(denom_dir, 1e-6)).sum(-1))
            sw_abs_c = sw_abs_c.at[:, jtile].set(
                (sw_dn_dir_can * inter.sw_air_abs_dir[:, ir, :]).sum(-1))
            # diffuse absorption within the canyon
            sw_abs_dif_g = (
                sw_dn_dir_can * (1.0 - inter.sw_albedo_direct_reg[:, ir, :])
                + sw_dn_dif_can
                * (1.0 - inter.sw_albedo_diffuse_reg[:, ir, :])
                - sw_dn_direct_g - sw_dn_diffuse_g + sw_up_g - sw_abs_g)
            sw_abs_c = sw_abs_c.at[:, jtile].add(
                (sw_abs_dif_g
                 * (1.0 - inter.sw_wall_abs_frac_dif[:, ir, :])).sum(-1))
            denom_dif = jnp.maximum(
                1.0 - inter.sw_albedo_diffuse[:, iw, :], 1e-6)
            sw_up_f = sw_up_f.at[:, iw].add(
                wall_scaling * (sw_abs_dif_g
                                * inter.sw_wall_abs_frac_dif[:, ir, :]
                                * inter.sw_albedo_diffuse[:, iw, :]
                                / denom_dif).sum(-1))
            sw_dn_f = sw_dn_f.at[:, iw].set(
                sw_dn_dir_f[:, iw]
                + wall_scaling * (sw_abs_dif_g
                                  * inter.sw_wall_abs_frac_dif[:, ir, :]
                                  / denom_dif).sum(-1))
        if do_lw:
            lw_dn_f = lw_dn_f.at[:, irf].set(lw_dn_surf)
            lw_up_f = lw_up_f.at[:, irf].set((
                inter.lw_emissivity[:, irf, :] * inter.planck_facet[:, irf, :]
                + (1.0 - inter.lw_emissivity[:, irf, :]) * lw_dn_can
            ).sum(-1))
            lw_abs_g = ((lw_dn_can + lw_up_g)
                        * (1.0 - inter.lw_reflectance[:, ir, :]
                           - inter.lw_transmittance[:, ir, :])
                        + inter.lw_total_wall_emission[:, ir, :]
                        + inter.lw_total_canopy_emission[:, ir, :]
                        - 2.0 * inter.lw_source[:, ir, :])
            wall_emiss = jnp.maximum(inter.lw_emissivity[:, iw, :], 1e-6)
            lw_dn_f = lw_dn_f.at[:, iw].set(
                wall_scaling * (inter.lw_wall_abs_frac[:, ir, :] * lw_abs_g
                                / wall_emiss).sum(-1))
            lw_up_f = lw_up_f.at[:, iw].set(
                lw_dn_f[:, iw]
                + wall_scaling * (inter.lw_total_wall_emission[:, ir, :]
                                  - inter.lw_wall_abs_frac[:, ir, :]
                                  * lw_abs_g).sum(-1))
            lw_abs_c = lw_abs_c.at[:, jtile].set(
                (lw_abs_g * (1.0 - inter.lw_wall_abs_frac[:, ir, :])
                 - inter.lw_total_canopy_emission[:, ir, :]).sum(-1))

    return SurfaceFlux(
        lw_dn_facet=lw_dn_f if do_lw else None,
        lw_up_facet=lw_up_f if do_lw else None,
        lw_abs_canopy=lw_abs_c if do_lw else None,
        sw_dn_facet=sw_dn_f if do_sw else None,
        sw_dn_direct_facet=sw_dn_dir_f if do_sw else None,
        sw_up_facet=sw_up_f if do_sw else None,
        sw_abs_canopy=sw_abs_c if do_sw else None)
