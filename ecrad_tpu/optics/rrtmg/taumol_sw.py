"""Shortwave gas + Rayleigh optical depths: the 14 RRTMG-IFS bands.

Semantics mirror ifsrrtm/srtm_taumol{16..29}.F90 and the dispatch in
ifsrrtm/srtm_gas_optical_depth.F90: per band, tau_gas and tau_rayleigh per
g-point plus the top-of-atmosphere solar source (SFLUXZEN) taken at the
layer where the pressure-interpolation index crosses the band's reference
level (LAYREFFR / LAYSOLFR logic).

Implementation: like the longwave (taumol_lw.py), every k-table lookup is
a `Section` (ops/gather_interp.py), with tropopause gating and column
amounts folded into the per-cell weights and intermediates in (g, cell)
orientation. Instead of compressing to daylight columns (the reference
gathers cols with mu0>0) everything is computed and the solver masks
night columns, which keeps every shape static.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ...ops import Section, eval_sections
from .setcoef import Coeffs

ONEMINUS = 1.0 - 1.0e-6


def _take(tab, idx):
    return jnp.take(tab, jnp.clip(idx, 0, tab.shape[0] - 1), axis=0)


def _lin(tab, ind0, frac):
    t0 = _take(tab, ind0)
    t1 = _take(tab, ind0 + 1)
    return t0 + frac[..., None] * (t1 - t0)


def _eta(col1, speccomb, mult):
    specparm = jnp.minimum(col1 / speccomb, ONEMINUS)
    specmult = mult * specparm
    js = jnp.floor(specmult).astype(jnp.int32)
    fs = specmult - js.astype(specmult.dtype)
    return js, fs


def _first_true(mask, default_idx):
    any_ = mask.any(axis=1)
    idx = jnp.argmax(mask, axis=1)
    return jnp.where(any_, idx, default_idx)


def _laysolfr_strat(c: Coeffs, layreffr: int):
    """Strat-referenced bands (16,27,28,29): first strat layer where jp
    crosses layreffr; default = top layer (srtm_taumol16.F90)."""
    jp_prev = jnp.concatenate([c.jp[:, :1], c.jp[:, :-1]], axis=1)
    crossing = (jp_prev < layreffr) & (c.jp >= layreffr) & (~c.tropo)
    nlev = c.jp.shape[1]
    return _first_true(crossing, nlev - 1)


def _laysolfr_tropo(c: Coeffs, layreffr: int):
    """Tropo-referenced bands (18-25): laysolfr = min(lay+1, laytrop) at
    the tropo layer where jp crosses layreffr; default = laytrop."""
    laytrop_idx = c.tropo.sum(axis=1) - 1
    jp_next = jnp.concatenate([c.jp[:, 1:], c.jp[:, -1:]], axis=1)
    crossing = (c.jp < layreffr) & (jp_next >= layreffr) & c.tropo
    lay = _first_true(crossing, laytrop_idx)
    found = crossing.any(axis=1)
    return jnp.where(found, jnp.minimum(lay + 1, laytrop_idx), laytrop_idx)


def _at_layer(arr2d, lay):
    return jnp.take_along_axis(arr2d, lay[:, None], axis=1)[:, 0]


def _sflux_1d(sfluxref, ncol, dtype):
    return jnp.broadcast_to(jnp.asarray(sfluxref, dtype),
                            (ncol, len(sfluxref)))


def _sflux_eta(sfluxref, js_lay, fs_lay):
    tabt = jnp.asarray(sfluxref).T  # (neta, ng)
    return _lin(tabt, js_lay, fs_lay)


def taumol_sw(c2: Coeffs, t: dict, toa_first=False):
    """All 14 SW bands. Returns (taug, taur, sfluxzen):
    taug/taur (ncol, nlev, 112) surface-first (or TOA-first),
    sfluxzen (ncol, 112)."""
    if toa_first:
        taug, taur, sflux = taumol_sw(c2, t)
        return taug[:, ::-1], taur[:, ::-1], sflux

    dtype = c2.colh2o.dtype
    ncol, nlev = c2.colh2o.shape
    n = ncol * nlev

    # flattened per-cell fields for section building
    fl = lambda x: x.reshape(-1)
    trop2 = c2.tropo
    trop = fl(trop2)
    tropf = trop.astype(dtype)
    stratf = 1.0 - tropf
    jp, jt, jt1 = fl(c2.jp), fl(c2.jt), fl(c2.jt1)
    f00, f10 = fl(c2.fac00_sw), fl(c2.fac10_sw)
    f01, f11 = fl(c2.fac01_sw), fl(c2.fac11_sw)
    colmol = fl(c2.colmol)

    def ev(secs):
        return eval_sections(secs, dtype=dtype)

    def self_for_sections(band, gate_for_strat):
        """Self (tropo) + foreign continuum sections for a band."""
        selfref = np.asarray(t[f"sw{band}_selfref"])
        forref = np.asarray(t[f"sw{band}_forref"])
        sf = tropf * fl(c2.selffac)
        ff = fl(c2.forfac) * (1.0 if gate_for_strat else tropf)
        indself, selffrac = fl(c2.indself), fl(c2.selffrac)
        indfor, forfrac = fl(c2.indfor), fl(c2.forfrac)
        return [
            Section(selfref, [indself - 1, indself],
                    [sf * (1.0 - selffrac), sf * selffrac]),
            Section(forref, [indfor - 1, indfor],
                    [ff * (1.0 - forfrac), ff * forfrac]),
        ]

    def eta_tropo_section(absa, col1_2d, col2_2d, strrat):
        """Tropospheric 9-eta major lookup as a separable Section
        (grid x eta; see ops/gather_interp.py). Note +9 on the
        flattened row = jt+1, i.e. a grid offset, and +1 an eta offset —
        the (fac corner) x (eta weight) product is exactly separable.
        Also returns 2D (js, fs) for the solar-source logic."""
        from ...ops.gather_interp import separable_section
        speccomb2 = col1_2d + strrat * col2_2d
        js2, fs2 = _eta(col1_2d, speccomb2, 8.0)
        js, fs = fl(js2), fl(fs2)
        sc = fl(speccomb2) * tropf
        grid0 = (jp - 1) * 5 + (jt - 1)
        grid1 = jp * 5 + (jt1 - 1)
        ng_band = np.asarray(absa).shape[-1]
        sec = separable_section(
            np.asarray(absa).reshape(-1, 9, ng_band),
            grids=[jnp.where(trop, grid0, 0), jnp.where(trop, grid1, 0)],
            grid_terms=[[(0, sc * f00), (1, sc * f10)],
                        [(0, sc * f01), (1, sc * f11)]],
            etas=[js, js],
            eta_terms=[[(0, 1.0 - fs), (1, fs)],
                       [(0, 1.0 - fs), (1, fs)]],
        )
        return sec, js2, fs2

    def eta_strat_section(absb, col1_2d, col2_2d, strrat):
        from ...ops.gather_interp import separable_section
        speccomb2 = col1_2d + strrat * col2_2d
        js2, fs2 = _eta(col1_2d, speccomb2, 4.0)
        js, fs = fl(js2), fl(fs2)
        sc = fl(speccomb2) * stratf
        grid0 = (jp - 13) * 5 + (jt - 1)
        grid1 = (jp - 12) * 5 + (jt1 - 1)
        ng_band = np.asarray(absb).shape[-1]
        sec = separable_section(
            np.asarray(absb).reshape(-1, 5, ng_band),
            grids=[jnp.where(trop, 0, grid0), jnp.where(trop, 0, grid1)],
            grid_terms=[[(0, sc * f00), (1, sc * f10)],
                        [(0, sc * f01), (1, sc * f11)]],
            etas=[js, js],
            eta_terms=[[(0, 1.0 - fs), (1, fs)],
                       [(0, 1.0 - fs), (1, fs)]],
        )
        return sec, js2, fs2

    def noeta_tropo_section(absa, col_2d):
        w = fl(col_2d) * tropf
        r0 = jnp.where(trop, (jp - 1) * 5 + (jt - 1), 0)
        r1 = jnp.where(trop, jp * 5 + (jt1 - 1), 0)
        return Section(np.asarray(absa), [r0, r0 + 1, r1, r1 + 1],
                       [w * f00, w * f10, w * f01, w * f11])

    def noeta_strat_section(absb, col_2d):
        w = fl(col_2d) * stratf
        r0 = jnp.where(trop, 0, (jp - 13) * 5 + (jt - 1))
        r1 = jnp.where(trop, 0, (jp - 12) * 5 + (jt1 - 1))
        return Section(np.asarray(absb), [r0, r0 + 1, r1, r1 + 1],
                       [w * f00, w * f10, w * f01, w * f11])

    def const_section(vec, weight):
        tab = np.asarray(vec, np.float32)[None, :]
        z = jnp.zeros_like(weight, dtype=jnp.int32)
        return Section(tab, [z], [weight])

    def rayl_const(band, ng_band):
        """taur for a scalar rayleigh coefficient: (ng, N)."""
        r = float(t[f"sw{band}_rayl"])
        return jnp.broadcast_to((colmol * r)[None, :], (ng_band, n))

    def rayl_per_g(raylc):
        rc = jnp.asarray(raylc, dtype)
        return rc[:, None] * colmol[None, :]

    taugs, taurs, sfluxes = [], [], []

    # ====================== band 16: h2o+ch4 / ch4 ========================
    sec_a, js_a, fs_a = eta_tropo_section(t["sw16_absa"], c2.colh2o,
                                          c2.colch4,
                                          float(t["sw16_strrat1"]))
    secs = [sec_a, noeta_strat_section(t["sw16_absb"], c2.colch4)]
    secs += self_for_sections(16, gate_for_strat=False)
    taugs.append(ev(secs))
    ng16 = np.asarray(t["sw16_absa"]).shape[1]
    taurs.append(rayl_const(16, ng16))
    sfluxes.append(_sflux_1d(t["sw16_sfluxref"], ncol, dtype))

    # ====================== band 17: h2o+co2 / h2o+co2 ====================
    strrat = float(t["sw17_strrat"])
    sec_a, _, _ = eta_tropo_section(t["sw17_absa"], c2.colh2o, c2.colco2,
                                    strrat)
    sec_b, js_b, fs_b = eta_strat_section(t["sw17_absb"], c2.colh2o,
                                          c2.colco2, strrat)
    secs = [sec_a, sec_b] + self_for_sections(17, gate_for_strat=True)
    taugs.append(ev(secs))
    taurs.append(rayl_const(17, np.asarray(t["sw17_absa"]).shape[1]))
    lay = _laysolfr_strat(c2, int(t["sw17_layreffr"]))
    sfluxes.append(_sflux_eta(t["sw17_sfluxref"], _at_layer(js_b, lay),
                              _at_layer(fs_b, lay)))

    # ====================== bands 18/19/21 ================================
    for band, col2_name, strat_eta in ((18, "colch4", False),
                                       (19, "colco2", False),
                                       (21, "colco2", True)):
        k = f"sw{band}"
        strrat = float(t[f"{k}_strrat"])
        col2 = getattr(c2, col2_name)
        sec_a, js_a, fs_a = eta_tropo_section(t[f"{k}_absa"], c2.colh2o,
                                              col2, strrat)
        if strat_eta:
            sec_b, _, _ = eta_strat_section(t[f"{k}_absb"], c2.colh2o,
                                            col2, strrat)
            secs = [sec_a, sec_b] + self_for_sections(band, True)
        else:
            secs = [sec_a, noeta_strat_section(t[f"{k}_absb"], col2)]
            secs += self_for_sections(band, False)
        taugs.append(ev(secs))
        taurs.append(rayl_const(band, np.asarray(t[f"{k}_absa"]).shape[1]))
        lay = _laysolfr_tropo(c2, int(t[f"{k}_layreffr"]))
        sfluxes.append(_sflux_eta(t[f"{k}_sfluxref"],
                                  _at_layer(js_a, lay),
                                  _at_layer(fs_a, lay)))

    # ====================== band 20: h2o + ch4 cross-section ==============
    secs = [noeta_tropo_section(t["sw20_absa"], c2.colh2o),
            noeta_strat_section(t["sw20_absb"], c2.colh2o)]
    secs += self_for_sections(20, gate_for_strat=True)
    secs.append(const_section(t["sw20_absch4"], fl(c2.colch4)))
    taugs.append(ev(secs))
    taurs.append(rayl_const(20, np.asarray(t["sw20_absa"]).shape[1]))
    sfluxes.append(_sflux_1d(t["sw20_sfluxref"], ncol, dtype))

    # ====================== band 22: h2o+o2 / o2 ==========================
    o2adj = 1.6
    sec_a, js_a, fs_a = eta_tropo_section(t["sw22_absa"], c2.colh2o,
                                          o2adj * c2.colo2,
                                          float(t["sw22_strrat"]))
    secs = [sec_a, noeta_strat_section(t["sw22_absb"], o2adj * c2.colo2)]
    secs += self_for_sections(22, gate_for_strat=False)
    ng22 = np.asarray(t["sw22_absa"]).shape[1]
    o2cont = fl(4.35e-4 * c2.colo2 / (350.0 * 2.0))
    secs.append(const_section(np.ones(ng22), o2cont))
    taugs.append(ev(secs))
    taurs.append(rayl_const(22, ng22))
    lay = _laysolfr_tropo(c2, int(t["sw22_layreffr"]))
    sfluxes.append(_sflux_eta(t["sw22_sfluxref"], _at_layer(js_a, lay),
                              _at_layer(fs_a, lay)))

    # ====================== band 23: h2o only, per-g rayleigh =============
    givfac = float(t["sw23_givfac"])
    secs = [noeta_tropo_section(t["sw23_absa"], givfac * c2.colh2o)]
    secs += self_for_sections(23, gate_for_strat=False)
    taugs.append(ev(secs))
    taurs.append(rayl_per_g(t["sw23_rayl"]))
    sfluxes.append(_sflux_1d(t["sw23_sfluxref"], ncol, dtype))

    # ====================== band 24: h2o+o2 / o2, o3 & rayleigh eta =======
    strrat = float(t["sw24_strrat"])
    sec_a, js_a, fs_a = eta_tropo_section(t["sw24_absa"], c2.colh2o,
                                          c2.colo2, strrat)
    secs = [sec_a, noeta_strat_section(t["sw24_absb"], c2.colo2)]
    secs += self_for_sections(24, gate_for_strat=False)
    secs.append(const_section(t["sw24_abso3a"], tropf * fl(c2.colo3)))
    secs.append(const_section(t["sw24_abso3b"], stratf * fl(c2.colo3)))
    taugs.append(ev(secs))
    rayla = np.asarray(t["sw24_rayla"], np.float32).T  # (9, ng)
    js_f, fs_f = fl(js_a), fl(fs_a)
    wmol = tropf * colmol
    taur24 = ev([
        Section(rayla, [js_f, js_f + 1],
                [wmol * (1.0 - fs_f), wmol * fs_f]),
        const_section(t["sw24_raylb"], stratf * colmol),
    ])
    taurs.append(taur24)
    lay = _laysolfr_tropo(c2, int(t["sw24_layreffr"]))
    sfluxes.append(_sflux_eta(t["sw24_sfluxref"], _at_layer(js_a, lay),
                              _at_layer(fs_a, lay)))

    # ====================== band 25: h2o + o3 cross-sections ==============
    secs = [noeta_tropo_section(t["sw25_absa"], c2.colh2o),
            const_section(t["sw25_abso3a"], tropf * fl(c2.colo3)),
            const_section(t["sw25_abso3b"], stratf * fl(c2.colo3))]
    taugs.append(ev(secs))
    taurs.append(rayl_per_g(t["sw25_rayl"]))
    sfluxes.append(_sflux_1d(t["sw25_sfluxref"], ncol, dtype))

    # ====================== band 26: pure rayleigh ========================
    ng26 = len(np.asarray(t["sw26_sfluxref"]))
    taugs.append(jnp.zeros((ng26, n), dtype))
    taurs.append(rayl_per_g(t["sw26_rayl"]))
    sfluxes.append(_sflux_1d(t["sw26_sfluxref"], ncol, dtype))

    # ====================== band 27: o3 ===================================
    secs = [noeta_tropo_section(t["sw27_absa"], c2.colo3),
            noeta_strat_section(t["sw27_absb"], c2.colo3)]
    taugs.append(ev(secs))
    taurs.append(rayl_per_g(t["sw27_rayl"]))
    sfluxes.append(float(t["sw27_scalekur"])
                   * _sflux_1d(t["sw27_sfluxref"], ncol, dtype))

    # ====================== band 28: o3+o2 ================================
    strrat = float(t["sw28_strrat"])
    sec_a, _, _ = eta_tropo_section(t["sw28_absa"], c2.colo3, c2.colo2,
                                    strrat)
    sec_b, js_b, fs_b = eta_strat_section(t["sw28_absb"], c2.colo3,
                                          c2.colo2, strrat)
    taugs.append(ev([sec_a, sec_b]))
    taurs.append(rayl_const(28, np.asarray(t["sw28_absa"]).shape[1]))
    lay = _laysolfr_strat(c2, int(t["sw28_layreffr"]))
    sfluxes.append(_sflux_eta(t["sw28_sfluxref"], _at_layer(js_b, lay),
                              _at_layer(fs_b, lay)))

    # ====================== band 29: h2o / co2 + cross-sections ===========
    secs = [noeta_tropo_section(t["sw29_absa"], c2.colh2o),
            noeta_strat_section(t["sw29_absb"], c2.colco2)]
    secs += self_for_sections(29, gate_for_strat=False)
    secs.append(const_section(t["sw29_absco2"], tropf * fl(c2.colco2)))
    secs.append(const_section(t["sw29_absh2o"], stratf * fl(c2.colh2o)))
    taugs.append(ev(secs))
    taurs.append(rayl_const(29, np.asarray(t["sw29_absa"]).shape[1]))
    sfluxes.append(_sflux_1d(t["sw29_sfluxref"], ncol, dtype))

    # Assemble in band order 16..29 (loop appended 21 before 20; reorder)
    order = [0, 1, 2, 3, 5, 4, 6, 7, 8, 9, 10, 11, 12, 13]
    taug = jnp.concatenate([taugs[i] for i in order], axis=0)
    taur = jnp.concatenate([taurs[i] for i in order], axis=0)
    sflux = jnp.concatenate([sfluxes[i] for i in order], axis=-1)
    taug = taug.reshape(112, ncol, nlev).transpose(1, 2, 0)
    taur = taur.reshape(112, ncol, nlev).transpose(1, 2, 0)
    return taug, taur, sflux
