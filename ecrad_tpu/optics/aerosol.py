"""Aerosol optical properties merged into the per-g gas arrays.

Reference parity: radiation/radiation_aerosol_optics.F90:75-344 and the
LUT container radiation_aerosol_optics_data.F90 — user aerosol types map
to hydrophobic (positive indices) or hydrophilic (negative) LUT entries;
hydrophilic properties are looked up by relative-humidity bin; band
properties are delta-Eddington scaled (extensive form) and merged into
the per-g optical depth / single-scattering albedo / asymmetry, with the
LW either fully scattering or reduced to absorption-only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RadiationConfig
from ..constants import ACCEL_DUE_TO_GRAVITY, GAS_INDEX
from ..io.netcdf import NetcdfFile
from .cloud import delta_eddington_extensive


@dataclass
class AerosolOpticsTables:
    """Per-user-type LUT slices, pre-gathered at setup (numpy).

    All arrays are (ntype_used, [nrh,] nband): hydrophobic types have
    their single row broadcast over a dummy rh axis so runtime lookup is
    uniform."""
    mass_ext_sw: np.ndarray   # (ntype, nrh, nbands_sw)
    ssa_sw: np.ndarray
    g_sw: np.ndarray
    mass_ext_lw: np.ndarray   # (ntype, nrh, nbands_lw)
    ssa_lw: np.ndarray
    g_lw: np.ndarray
    rh_lower: np.ndarray      # (nrh,)
    is_active: np.ndarray     # (ntype,) bool


def setup_aerosol_optics(config: RadiationConfig) -> AerosolOpticsTables:
    with NetcdfFile(config.aerosol_optics_file) as f:
        me_sw_phob = f.read("mass_ext_sw_hydrophobic")   # (ntpho, nb)
        ssa_sw_phob = f.read("ssa_sw_hydrophobic")
        g_sw_phob = f.read("asymmetry_sw_hydrophobic")
        me_lw_phob = f.read("mass_ext_lw_hydrophobic")
        ssa_lw_phob = f.read("ssa_lw_hydrophobic")
        g_lw_phob = f.read("asymmetry_lw_hydrophobic")
        me_sw_phil = f.read("mass_ext_sw_hydrophilic")   # (ntphi, nrh, nb)
        ssa_sw_phil = f.read("ssa_sw_hydrophilic")
        g_sw_phil = f.read("asymmetry_sw_hydrophilic")
        me_lw_phil = f.read("mass_ext_lw_hydrophilic")
        ssa_lw_phil = f.read("ssa_lw_hydrophilic")
        g_lw_phil = f.read("asymmetry_lw_hydrophilic")
        rh_lower = f.read("relative_humidity1")

    nrh = me_sw_phil.shape[1]
    type_map = config.i_aerosol_type_map[:config.n_aerosol_types]

    def gather(phob, phil):
        rows = []
        active = []
        for imap in type_map:
            if imap > 0:
                rows.append(np.repeat(phob[imap - 1][None, :], nrh, 0))
                active.append(True)
            elif imap < 0:
                rows.append(phil[-imap - 1])
                active.append(True)
            else:
                rows.append(np.zeros_like(phil[0]))
                active.append(False)
        return np.stack(rows), np.asarray(active)

    me_sw, active = gather(me_sw_phob, me_sw_phil)
    ssa_sw, _ = gather(ssa_sw_phob, ssa_sw_phil)
    g_sw, _ = gather(g_sw_phob, g_sw_phil)
    me_lw, _ = gather(me_lw_phob, me_lw_phil)
    ssa_lw, _ = gather(ssa_lw_phob, ssa_lw_phil)
    g_lw, _ = gather(g_lw_phob, g_lw_phil)
    # inactive types: zero extinction
    me_sw[~active] = 0.0
    me_lw[~active] = 0.0
    return AerosolOpticsTables(
        mass_ext_sw=me_sw, ssa_sw=ssa_sw, g_sw=g_sw,
        mass_ext_lw=me_lw, ssa_lw=ssa_lw, g_lw=g_lw,
        rh_lower=rh_lower, is_active=active)


def add_aerosol_optics(setup, thermodynamics, gas, aerosol,
                       od_lw, ssa_lw, g_lw, od_sw, ssa_sw, g_sw):
    """Merge aerosols into per-g properties
    (radiation_aerosol_optics.F90:75-344)."""
    cfg = setup.config
    ao: AerosolOpticsTables = setup.aerosol_optics
    dtype = od_sw.dtype

    # direct optical-property input bypass
    if aerosol.od_sw is not None:
        return _add_direct(setup, aerosol, od_lw, ssa_lw, g_lw,
                           od_sw, ssa_sw, g_sw)

    thermo = thermodynamics
    if thermo.h2o_sat_liq is None:
        thermo = thermo.calc_saturation_wrt_liquid()
    h2o_mmr = gas.mixing_ratio[:, :, GAS_INDEX["h2o"]]
    rh = h2o_mmr / jnp.maximum(thermo.h2o_sat_liq, 1e-12)
    rh_lower = jnp.asarray(ao.rh_lower, dtype)
    irh = (rh[..., None] > rh_lower[1:]).sum(-1)       # (ncol, nlev) 0-based

    dp = thermo.pressure_hl[:, 1:] - thermo.pressure_hl[:, :-1]
    factor = dp / ACCEL_DUE_TO_GRAVITY                 # (ncol, nlev)
    mmr = aerosol.mixing_ratio                         # (ncol, nlev, ntype)
    # Reconcile the number of aerosol types supplied with the configured
    # type map (the reference zero-fills absent types; inputs without an
    # aerosol_mmr variable arrive as a single zero type).
    ntab = ao.mass_ext_sw.shape[0]
    if mmr.shape[-1] < ntab:
        mmr = jnp.concatenate(
            [mmr, jnp.zeros(mmr.shape[:-1] + (ntab - mmr.shape[-1],),
                            mmr.dtype)], axis=-1)
    elif mmr.shape[-1] > ntab:
        mmr = mmr[..., :ntab]
    mass = factor[..., None] * mmr                     # (ncol, nlev, ntype)

    nrh = ao.mass_ext_sw.shape[1]

    def accumulate(me, ssa_t, g_t):
        """me/ssa/g: (ntype, nrh, nb) -> band sums (ncol, nlev, nb).

        One (cells x ntype) @ (ntype x nband) matmul per rh bin keeps
        intermediates small."""
        me_j = jnp.asarray(me, dtype)
        scat_j = me_j * jnp.asarray(ssa_t, dtype)
        scatg_j = scat_j * jnp.asarray(g_t, dtype)
        od_c = scat_c = scatg_c = 0.0
        # precision=HIGHEST: a reduced-precision default (bf16 or TF32
        # inputs) puts a ~1e-3 relative error on every aerosol od
        mm = lambda a, b: jnp.matmul(
            a, b, precision=jax.lax.Precision.HIGHEST)
        for r in range(nrh):
            m_r = jnp.where((irh == r)[..., None], mass, 0.0)
            od_c = od_c + mm(m_r, me_j[:, r, :])
            scat_c = scat_c + mm(m_r, scat_j[:, r, :])
            scatg_c = scatg_c + mm(m_r, scatg_j[:, r, :])
        return od_c, scat_c, scatg_c

    od_sw_aer, scat_sw_aer, scatg_sw_aer = accumulate(
        ao.mass_ext_sw, ao.ssa_sw, ao.g_sw)
    if not cfg.do_sw_delta_scaling_with_gases:
        od_sw_aer, scat_sw_aer, scatg_sw_aer = delta_eddington_extensive(
            od_sw_aer, scat_sw_aer, scatg_sw_aer)

    band_g_sw = setup.spec.band_from_reordered_g_sw
    od_aer_g = od_sw_aer[:, :, band_g_sw]
    scat_aer_g = scat_sw_aer[:, :, band_g_sw]
    scatg_aer_g = scatg_sw_aer[:, :, band_g_sw]
    has_aer = (od_sw_aer[:, :, :1] > 0.0)
    local_od = od_sw + od_aer_g
    local_scat = ssa_sw * od_sw + scat_aer_g
    g_sw_new = jnp.where(local_scat > 0.0,
                         scatg_aer_g / jnp.maximum(local_scat, 1e-30),
                         0.0)
    ssa_sw_new = jnp.where(local_od > 0.0,
                           local_scat / jnp.maximum(local_od, 1e-30), 0.0)
    od_sw_out = jnp.where(has_aer, local_od, od_sw)
    ssa_sw_out = jnp.where(has_aer, ssa_sw_new, ssa_sw)
    g_sw_out = jnp.where(has_aer, g_sw_new, g_sw)

    band_g_lw = setup.spec.band_from_reordered_g_lw
    if cfg.do_lw_aerosol_scattering:
        od_lw_aer, scat_lw_aer, scatg_lw_aer = accumulate(
            ao.mass_ext_lw, ao.ssa_lw, ao.g_lw)
        od_lw_aer, scat_lw_aer, scatg_lw_aer = delta_eddington_extensive(
            od_lw_aer, scat_lw_aer, scatg_lw_aer)
        od_aer_g = od_lw_aer[:, :, band_g_lw]
        scat_aer_g = scat_lw_aer[:, :, band_g_lw]
        scatg_aer_g = scatg_lw_aer[:, :, band_g_lw]
        has = od_aer_g > 0.0
        g_lw_new = jnp.where(scat_aer_g > 0.0,
                             scatg_aer_g / jnp.maximum(scat_aer_g, 1e-30),
                             0.0)
        local_od = od_lw + od_aer_g
        ssa_lw_new = scat_aer_g / jnp.maximum(local_od, 1e-30)
        od_lw_out = jnp.where(has, local_od, od_lw)
        ssa_lw_out = jnp.where(has, ssa_lw_new, ssa_lw)
        g_lw_out = jnp.where(has, g_lw_new, g_lw)
    else:
        # absorption-only co-albedo trick (:236-243)
        me = jnp.asarray(ao.mass_ext_lw, dtype)
        abs_tab = me * (1.0 - jnp.asarray(ao.ssa_lw, dtype))
        od_lw_aer = 0.0
        mm = lambda a, b: jnp.matmul(
            a, b, precision=jax.lax.Precision.HIGHEST)
        for r in range(nrh):
            m_r = jnp.where((irh == r)[..., None], mass, 0.0)
            od_lw_aer = od_lw_aer + mm(m_r, abs_tab[:, r, :])
        od_lw_out = od_lw + od_lw_aer[:, :, band_g_lw]
        ssa_lw_out = ssa_lw
        g_lw_out = g_lw

    return od_lw_out, ssa_lw_out, g_lw_out, od_sw_out, ssa_sw_out, g_sw_out


def _add_direct(setup, aerosol, od_lw, ssa_lw, g_lw, od_sw, ssa_sw, g_sw):
    """Direct per-band optical-property input
    (radiation_aerosol_optics.F90:350-...)."""
    cfg = setup.config
    band_g_sw = setup.spec.band_from_reordered_g_sw
    band_g_lw = setup.spec.band_from_reordered_g_lw
    od_aer = aerosol.od_sw[:, :, band_g_sw]
    scat_aer = (aerosol.ssa_sw * aerosol.od_sw)[:, :, band_g_sw]
    scatg_aer = (aerosol.g_sw * aerosol.ssa_sw
                 * aerosol.od_sw)[:, :, band_g_sw]
    local_od = od_sw + od_aer
    local_scat = ssa_sw * od_sw + scat_aer
    g_sw_new = jnp.where(local_scat > 0.0,
                         scatg_aer / jnp.maximum(local_scat, 1e-30), 0.0)
    ssa_sw_new = jnp.where(local_od > 0.0,
                           local_scat / jnp.maximum(local_od, 1e-30), 0.0)
    od_lw_new = od_lw
    if aerosol.od_lw is not None:
        abs_lw = (aerosol.od_lw * (1.0 - aerosol.ssa_lw)
                  if aerosol.ssa_lw is not None else aerosol.od_lw)
        od_lw_new = od_lw + abs_lw[:, :, band_g_lw]
    return od_lw_new, ssa_lw, g_lw, local_od, ssa_sw_new, g_sw_new
