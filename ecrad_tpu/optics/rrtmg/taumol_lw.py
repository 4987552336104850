"""Longwave gas optical depths: the 16 RRTMG-IFS bands, vectorized.

Semantics mirror ifsrrtm/rrtm_taumol{1..16}.F90 (RRTMG_LW v4.85 as used by
the IFS): per-band major-species k-table interpolation (with the 3-point
eta scheme near pure-species limits), self/foreign water continuum, minor
gases with chi-ratio adjustments, CFC/CCl4 cross-sections, and Planck
fractions. Output is (ncol, nlev, 140) optical depth + Planck fraction,
levels surface-first (flipped to ecRad order by the bridge).

Implementation: every k-table lookup is expressed as a `Section` (row
indices + weights into a table; see ops/gather_interp.py) and each
band's optical depth and Planck fraction is one `eval_sections` call
each, with tropopause branching, column amounts and empirical correction
factors folded into the per-cell weights. Intermediates live in
(g, cell) orientation.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ...ops import Section, eval_sections
from .setcoef import Coeffs, chi_rows_at

ONEMINUS = 1.0 - 1.0e-6


def _flat(c: Coeffs) -> Coeffs:
    """Flatten all (ncol, nlev) fields to (N,)."""
    return Coeffs(*[x.reshape(-1) for x in c])


def _eta_index(specparm, mult):
    """js (0-based), fs for an eta interpolation with `mult` intervals."""
    specparm = jnp.minimum(specparm, ONEMINUS)
    specmult = mult * specparm
    js = jnp.floor(specmult).astype(jnp.int32)
    fs = specmult - js.astype(specmult.dtype)
    return specparm, js, fs


def _self_for_sections(c, selfref, forref):
    """Water-vapour self + foreign continuum (tropo self only)."""
    trop = c.tropo.astype(c.selffac.dtype)
    sf = trop * c.selffac
    return [
        Section(selfref, [c.indself - 1, c.indself],
                [sf * (1.0 - c.selffrac), sf * c.selffrac]),
        Section(forref, [c.indfor - 1, c.indfor],
                [c.forfac * (1.0 - c.forfrac), c.forfac * c.forfrac]),
    ]


def _major_noeta_section(c, absa, absb, colgas_a, colgas_b):
    """Major-species lookup for bands without a binary species.

    colgas_a/b: column amounts used below/above the tropopause."""
    tab = np.concatenate([absa, absb], axis=0)
    na = absa.shape[0]
    trop = c.tropo
    r0a = (c.jp - 1) * 5 + (c.jt - 1)
    r1a = c.jp * 5 + (c.jt1 - 1)
    r0b = na + (c.jp - 13) * 5 + (c.jt - 1)
    r1b = na + (c.jp - 12) * 5 + (c.jt1 - 1)
    r0 = jnp.where(trop, r0a, r0b)
    r1 = jnp.where(trop, r1a, r1b)
    w = jnp.where(trop, colgas_a, colgas_b)
    return Section(tab, [r0, r0 + 1, r1, r1 + 1],
                   [w * c.fac00, w * c.fac10, w * c.fac01, w * c.fac11])


def _eta_weights_tropo(specparm, fs):
    """3-point eta weights at offsets (-1, 0, 1, 2)
    (rrtm_taumol3.F90:141-198)."""
    p_lo = fs - 1.0
    p4_lo = p_lo ** 4
    fk0_lo, fk1_lo, fk2_lo = p4_lo, 1.0 - p_lo - 2.0 * p4_lo, p_lo + p4_lo
    p_hi = -fs
    p4_hi = p_hi ** 4
    fk0_hi, fk1_hi, fk2_hi = p4_hi, 1.0 - p_hi - 2.0 * p4_hi, p_hi + p4_hi
    lo = specparm < 0.125
    hi = specparm > 0.875
    zero = jnp.zeros_like(fs)
    wm1 = jnp.where(hi, fk2_hi, zero)
    w0 = jnp.where(lo, fk0_lo, jnp.where(hi, fk1_hi, 1.0 - fs))
    w1 = jnp.where(lo, fk1_lo, jnp.where(hi, fk0_hi, fs))
    w2 = jnp.where(lo, fk2_lo, zero)
    return (wm1, w0, w1, w2)


def _major_eta_sections(c, absa, absb, col1, col2, rat_a, rat_a1,
                        rat_b=None, rat_b1=None, col1_b=None,
                        col2_b=None, has_b=True):
    """Binary-species major term as separable Sections.

    The (jp, jt) corner x eta-offset weights factor exactly as an outer
    product, so each tropo/strat part is one separable_section with two
    families (jt and jt1) (ops/gather_interp.py).
    """
    from ...ops.gather_interp import separable_section
    dtype = col1.dtype
    trop = c.tropo
    tropf = trop.astype(dtype)
    secs = []

    speccomb = col1 + rat_a * col2
    specparm, js, fs = _eta_index(col1 / speccomb, 8.0)
    speccomb1 = col1 + rat_a1 * col2
    specparm1, js1, fs1 = _eta_index(col1 / speccomb1, 8.0)
    grid0 = (c.jp - 1) * 5 + (c.jt - 1)
    grid1 = c.jp * 5 + (c.jt1 - 1)
    w0 = _eta_weights_tropo(specparm, fs)
    w1 = _eta_weights_tropo(specparm1, fs1)
    offs = (-1, 0, 1, 2)
    ng = np.asarray(absa).shape[-1]
    tab_a = np.asarray(absa).reshape(-1, 9, ng)
    secs.append(separable_section(
        tab_a,
        grids=[jnp.where(trop, grid0, 0), jnp.where(trop, grid1, 0)],
        grid_terms=[[(0, tropf * speccomb * c.fac00),
                     (1, tropf * speccomb * c.fac10)],
                    [(0, tropf * speccomb1 * c.fac01),
                     (1, tropf * speccomb1 * c.fac11)]],
        etas=[js, js1],
        eta_terms=[list(zip(offs, w0)), list(zip(offs, w1))],
    ))
    if not has_b:
        return secs

    c1b = col1 if col1_b is None else col1_b
    c2b = col2 if col2_b is None else col2_b
    stratf = 1.0 - tropf
    speccomb_b = c1b + rat_b * c2b
    _, jsb, fsb = _eta_index(c1b / speccomb_b, 4.0)
    speccomb1_b = c1b + rat_b1 * c2b
    _, jsb1, fsb1 = _eta_index(c1b / speccomb1_b, 4.0)
    grid0b = (c.jp - 13) * 5 + (c.jt - 1)
    grid1b = (c.jp - 12) * 5 + (c.jt1 - 1)
    tab_b = np.asarray(absb).reshape(-1, 5, ng)
    secs.append(separable_section(
        tab_b,
        grids=[jnp.where(trop, 0, grid0b), jnp.where(trop, 0, grid1b)],
        grid_terms=[[(0, stratf * speccomb_b * c.fac00),
                     (1, stratf * speccomb_b * c.fac10)],
                    [(0, stratf * speccomb1_b * c.fac01),
                     (1, stratf * speccomb1_b * c.fac11)]],
        etas=[jsb, jsb1],
        eta_terms=[[(0, 1.0 - fsb), (1, fsb)],
                   [(0, 1.0 - fsb1), (1, fsb1)]],
    ))
    return secs


def _minor_eta_section(ktab, jm, fm, indminor, minorfrac, scale):
    """Minor-gas lookup with eta dependence as a separable Section.
    ktab: (neta, 19, ng); weights factor as (eta) x (temperature)."""
    from ...ops.gather_interp import separable_section
    return separable_section(
        np.asarray(ktab),
        grids=[jm],
        grid_terms=[[(0, scale * (1.0 - fm)), (1, scale * fm)]],
        etas=[indminor - 1],
        eta_terms=[[(0, 1.0 - minorfrac), (1, minorfrac)]],
    )


def _minor_noeta_section(ktab, indminor, minorfrac, scale):
    """Minor-gas lookup, no eta. ktab: (19, ng)."""
    return Section(np.asarray(ktab), [indminor - 1, indminor],
                   [scale * (1.0 - minorfrac), scale * minorfrac])


def _const_section(vec, weight):
    """Rank-1 term weight[cell] * vec[g] as a single-row lookup."""
    tab = np.asarray(vec)[None, :]
    z = jnp.zeros_like(weight, dtype=jnp.int32)
    return Section(tab, [z], [weight])


def _switch_section(vec_a, vec_b, tropo, dtype):
    """Per-cell choice between two constant g-rows (fracrefa/b)."""
    tab = np.stack([np.asarray(vec_a), np.asarray(vec_b)])
    rows = [jnp.where(tropo, 0, 1).astype(jnp.int32)]
    return Section(tab, rows, [jnp.ones(tropo.shape, dtype)])


def _pfrac_eta_sections(c, fracrefa, fracrefb, col1, rat_a, col2_a,
                        mult_a, col1_b=None, rat_b=None, col2_b=None,
                        mult_b=4.0):
    """Eta-interpolated Planck fraction sections.

    fracrefa: (ng, neta_a); fracrefb: (ng, neta_b) or (ng,) constant or
    None (A used everywhere with strat weight zero -> caller supplies
    fallback)."""
    dtype = col1.dtype
    trop = c.tropo
    tropf = trop.astype(dtype)
    secs = []
    speccomb = col1 + rat_a * col2_a
    _, jpl, fpl = _eta_index(col1 / speccomb, mult_a)
    ta = np.asarray(fracrefa).T  # (neta, ng)
    secs.append(Section(ta, [jpl, jpl + 1],
                        [tropf * (1.0 - fpl), tropf * fpl]))
    stratf = 1.0 - tropf
    if fracrefb is None:
        return secs, stratf
    fb = np.asarray(fracrefb)
    if fb.ndim == 1:
        secs.append(_const_section(fb, stratf))
    else:
        speccomb_b = col1_b + rat_b * col2_b
        _, jplb, fplb = _eta_index(col1_b / speccomb_b, mult_b)
        tb = fb.T
        secs.append(Section(tb, [jplb, jplb + 1],
                            [stratf * (1.0 - fplb), stratf * fplb]))
    return secs, stratf


def _chi_adjust(col, coldry, ref, thresh, base, expo):
    """Chi-ratio based column adjustment for minor gases
    (e.g. rrtm_taumol3.F90:115-122). ref: reference chi value — a
    scalar constant or the per-cell chi_mls row already evaluated at
    JP+1 (chi_rows_at; avoids per-call serial gathers)."""
    chi = col / coldry
    rat = 1.0e20 * chi / ref
    adjfac = base + jnp.maximum(rat - base, 1e-30) ** expo
    adjcol = adjfac * ref * coldry * 1.0e-20
    return jnp.where(rat > thresh, adjcol, col)


def taumol_lw(c2: Coeffs, t: dict, toa_first=False):
    """All 16 LW bands. Returns (tau, pfrac), each (ncol, nlev, 140),
    levels surface-first (toa_first=False) or TOA-first."""
    if toa_first:
        tau, pfrac = taumol_lw(c2, t)
        return tau[:, ::-1], pfrac[:, ::-1]

    ncol, nlev = c2.tropo.shape
    c = _flat(c2)
    dtype = c.colh2o.dtype
    chi = jnp.asarray(t["chi_mls"], dtype)  # (7, 59)
    # per-cell chi_mls at JP+1 for every gas (reference CHI_MLS(:,JP+1)
    # in the minor-gas adjustments) — one one-hot product, no gathers
    chiv = chi_rows_at(chi, c.jp)
    trop = c.tropo
    tropf = trop.astype(dtype)
    stratf = 1.0 - tropf
    ones = jnp.ones_like(tropf)
    taus, fracs = [], []

    def chi_at(gas_1b, jp_1b):
        return float(np.asarray(t["chi_mls"])[gas_1b - 1, jp_1b - 1])

    def ev(sections):
        return eval_sections(sections, dtype=dtype)

    def ev_band(tau_secs, pfrac_secs):
        """A band's (tau, pfrac), each (ng_band, N)."""
        return ev(tau_secs), ev(pfrac_secs)

    def eta_major_section(band, col1, col2, rat_a, rat_a1, rat_b=None,
                          rat_b1=None, col1_b=None, col2_b=None,
                          has_b=False):
        """Returns a LIST of separable Sections (tropo absa +
        optional strat absb) — see _major_eta_sections."""
        return _major_eta_sections(
            c, t[f"lw{band}_absa"],
            t[f"lw{band}_absb"] if has_b else None,
            col1, col2, rat_a, rat_a1, rat_b, rat_b1,
            col1_b=col1_b, col2_b=col2_b, has_b=has_b)

    # ---------------- band 1: h2o, minor N2 -------------------------------
    secs = [_major_noeta_section(c, t["lw1_absa"], t["lw1_absb"],
                                 c.colh2o, c.colh2o)]
    secs += _self_for_sections(c, t["lw1_selfref"], t["lw1_forref"])
    scalen2 = c.colbrd * c.scaleminorn2
    secs.append(_minor_noeta_section(t["lw1_kao_mn2"], c.indminor,
                                     c.minorfrac, tropf * scalen2))
    secs.append(_minor_noeta_section(t["lw1_kbo_mn2"], c.indminor,
                                     c.minorfrac, stratf * scalen2))
    tau, pf = ev_band(secs, [_switch_section(t["lw1_fracrefa"],
                                         t["lw1_fracrefb"], trop, dtype)])
    corradj = jnp.where(trop,
                        jnp.where(c.pavel < 250.0,
                                  1.0 - 0.15 * (250.0 - c.pavel) / 154.4,
                                  1.0),
                        1.0 - 0.15 * (c.pavel / 95.6))
    taus.append(corradj[None, :] * tau)
    fracs.append(pf)

    # ---------------- band 2: h2o -----------------------------------------
    # tropo: corradj*(major+self+for); strat: major+for. Fold corradj into
    # the tropo weights.
    corradj2 = 1.0 - 0.05 * (c.pavel - 100.0) / 900.0
    wa = jnp.where(trop, corradj2, 1.0)
    sec_major = _major_noeta_section(c, t["lw2_absa"], t["lw2_absb"],
                                     c.colh2o * corradj2, c.colh2o)
    sf = _self_for_sections(c, t["lw2_selfref"], t["lw2_forref"])
    self_sec = Section(sf[0].table, sf[0].rows,
                       [w * corradj2 for w in sf[0].weights])
    for_sec = Section(sf[1].table, sf[1].rows,
                      [w * wa for w in sf[1].weights])
    tau, pf = ev_band([sec_major, self_sec, for_sec],
                  [_switch_section(t["lw2_fracrefa"], t["lw2_fracrefb"],
                                   trop, dtype)])
    taus.append(tau)
    fracs.append(pf)

    # ---------------- band 3: h2o+co2, minor n2o --------------------------
    secs = list(eta_major_section(3, c.colh2o, c.colco2, c.rat_h2oco2,
                              c.rat_h2oco2_1, c.rat_h2oco2, c.rat_h2oco2_1,
                              has_b=True))
    secs += _self_for_sections(c, t["lw3_selfref"], t["lw3_forref"])
    refm_a = chi_at(1, 3) / chi_at(2, 3)
    refm_b = chi_at(1, 13) / chi_at(2, 13)
    _, jm_a, fm_a = _eta_index(c.colh2o / (c.colh2o + refm_a * c.colco2),
                               8.0)
    _, jm_b, fm_b = _eta_index(c.colh2o / (c.colh2o + refm_b * c.colco2),
                               4.0)
    adjcoln2o = _chi_adjust(c.coln2o, c.coldry, chiv[3], 1.5, 0.5, 0.65)
    secs.append(_minor_eta_section(t["lw3_kao_mn2o"], jm_a, fm_a,
                                   c.indminor, c.minorfrac,
                                   tropf * adjcoln2o))
    secs.append(_minor_eta_section(t["lw3_kbo_mn2o"], jm_b, fm_b,
                                   c.indminor, c.minorfrac,
                                   stratf * adjcoln2o))
    pf_secs, _ = _pfrac_eta_sections(
        c, t["lw3_fracrefa"], t["lw3_fracrefb"],
        c.colh2o, chi_at(1, 9) / chi_at(2, 9), c.colco2, 8.0,
        col1_b=c.colh2o, rat_b=chi_at(1, 13) / chi_at(2, 13),
        col2_b=c.colco2, mult_b=4.0)
    tau, pf = ev_band(secs, pf_secs)
    taus.append(tau)
    fracs.append(pf)

    # ---------------- band 4: h2o+co2 / o3+co2 ----------------------------
    secs = list(eta_major_section(4, c.colh2o, c.colco2, c.rat_h2oco2,
                              c.rat_h2oco2_1, c.rat_o3co2, c.rat_o3co2_1,
                              col1_b=c.colo3, col2_b=c.colco2, has_b=True))
    sf4 = _self_for_sections(c, t["lw4_selfref"], t["lw4_forref"])
    # self/for apply in troposphere only for this band (strat tau has no
    # continuum): gate the foreign term (self is already tropo-gated)
    secs.append(sf4[0])
    secs.append(Section(sf4[1].table, sf4[1].rows,
                        [w * tropf for w in sf4[1].weights]))
    pf_secs, _ = _pfrac_eta_sections(
        c, t["lw4_fracrefa"], t["lw4_fracrefb"],
        c.colh2o, chi_at(1, 11) / chi_at(2, 11), c.colco2, 8.0,
        col1_b=c.colo3, rat_b=chi_at(3, 13) / chi_at(2, 13),
        col2_b=c.colco2, mult_b=4.0)
    tau4, pf = ev_band(secs, pf_secs)
    ng4 = tau4.shape[0]
    scale = np.ones(ng4, np.float32)
    for g_1b, f in zip(range(8, 15), (0.92, 0.88, 1.07, 1.1, 0.99,
                                      0.88, 0.943)):
        if g_1b <= ng4:
            scale[g_1b - 1] = f
    scale_cell = (jnp.asarray(scale, dtype)[:, None] * stratf[None, :]
                  + tropf[None, :])
    taus.append(tau4 * scale_cell)
    fracs.append(pf)

    # ---------------- band 5: h2o+co2 / o3+co2, minor o3, ccl4 ------------
    secs = list(eta_major_section(5, c.colh2o, c.colco2, c.rat_h2oco2,
                              c.rat_h2oco2_1, c.rat_o3co2, c.rat_o3co2_1,
                              col1_b=c.colo3, col2_b=c.colco2, has_b=True))
    sf = _self_for_sections(c, t["lw5_selfref"], t["lw5_forref"])
    secs.append(sf[0])
    secs.append(Section(sf[1].table, sf[1].rows,
                        [w * tropf for w in sf[1].weights]))
    refm_a = chi_at(1, 7) / chi_at(2, 7)
    _, jmo3, fmo3 = _eta_index(c.colh2o / (c.colh2o + refm_a * c.colco2),
                               8.0)
    secs.append(_minor_eta_section(t["lw5_kao_mo3"], jmo3, fmo3,
                                   c.indminor, c.minorfrac,
                                   tropf * c.colo3))
    secs.append(_const_section(t["lw5_ccl4"], c.wx_ccl4))
    pf_secs, _ = _pfrac_eta_sections(
        c, t["lw5_fracrefa"], t["lw5_fracrefb"],
        c.colh2o, chi_at(1, 5) / chi_at(2, 5), c.colco2, 8.0,
        col1_b=c.colo3, rat_b=chi_at(3, 43) / chi_at(2, 43),
        col2_b=c.colco2, mult_b=4.0)
    tau, pf = ev_band(secs, pf_secs)
    taus.append(tau)
    fracs.append(pf)

    # ---------------- band 6: h2o; minor co2; cfc11, cfc12 ----------------
    absa6 = np.asarray(t["lw6_absa"])
    r0a = (c.jp - 1) * 5 + (c.jt - 1)
    r1a = c.jp * 5 + (c.jt1 - 1)
    wh = tropf * c.colh2o
    secs = [Section(absa6,
                    [jnp.where(trop, r0a, 0), jnp.where(trop, r0a + 1, 0),
                     jnp.where(trop, r1a, 0), jnp.where(trop, r1a + 1, 0)],
                    [wh * c.fac00, wh * c.fac10, wh * c.fac01,
                     wh * c.fac11])]
    sf = _self_for_sections(c, t["lw6_selfref"], t["lw6_forref"])
    secs.append(sf[0])
    secs.append(Section(sf[1].table, sf[1].rows,
                        [w * tropf for w in sf[1].weights]))
    adjcolco2 = _chi_adjust(c.colco2, c.coldry, chiv[1], 3.0, 2.0, 0.77)
    secs.append(_minor_noeta_section(t["lw6_kao_mco2"], c.indminor,
                                     c.minorfrac, tropf * adjcolco2))
    secs.append(_const_section(t["lw6_cfc11adj"], c.wx_cfc11))
    secs.append(_const_section(t["lw6_cfc12"], c.wx_cfc12))
    tau, pf = ev_band(secs, [_const_section(t["lw6_fracrefa"], ones)])
    taus.append(tau)
    fracs.append(pf)

    # ---------------- band 7: h2o+o3; minor co2 ---------------------------
    secs = list(eta_major_section(7, c.colh2o, c.colo3, c.rat_h2oo3,
                              c.rat_h2oo3_1, has_b=False))
    # strat major: o3 against absb, no eta
    secs.append(_major_noeta_section(
        c, np.zeros_like(np.asarray(t["lw7_absa"])[:1]), t["lw7_absb"],
        jnp.zeros_like(c.colo3), c.colo3))
    secs += _self_for_sections(c, t["lw7_selfref"], t["lw7_forref"])
    secs[3] = Section(secs[3].table, secs[3].rows,
                      [w * tropf for w in secs[3].weights])
    refm_a = chi_at(1, 3) / chi_at(3, 3)
    _, jmco2, fmco2 = _eta_index(c.colh2o / (c.colh2o + refm_a * c.colo3),
                                 8.0)
    adj_a = _chi_adjust(c.colco2, c.coldry, chiv[1], 3.0, 3.0, 0.79)
    adj_b = _chi_adjust(c.colco2, c.coldry, chiv[1], 3.0, 2.0, 0.79)
    secs.append(_minor_eta_section(t["lw7_kao_mco2"], jmco2, fmco2,
                                   c.indminor, c.minorfrac, tropf * adj_a))
    secs.append(_minor_noeta_section(t["lw7_kbo_mco2"], c.indminor,
                                     c.minorfrac, stratf * adj_b))
    pf_secs, _ = _pfrac_eta_sections(
        c, t["lw7_fracrefa"], np.asarray(t["lw7_fracrefb"]),
        c.colh2o, chi_at(1, 3) / chi_at(3, 3), c.colo3, 8.0)
    tau7, pf = ev_band(secs, pf_secs)
    ng7 = tau7.shape[0]
    scale = np.ones(ng7, np.float32)
    for g_1b, f in zip(range(6, 12), (0.92, 0.88, 1.07, 1.1, 0.99, 0.855)):
        scale[g_1b - 1] = f
    scale_cell = (jnp.asarray(scale, dtype)[:, None] * stratf[None, :]
                  + tropf[None, :])
    taus.append(tau7 * scale_cell)
    fracs.append(pf)

    # ---------------- band 8: h2o / o3; minors co2,o3,n2o; cfc12,cfc22 ----
    secs = [_major_noeta_section(c, t["lw8_absa"], t["lw8_absb"],
                                 c.colh2o, c.colo3)]
    sf = _self_for_sections(c, t["lw8_selfref"], t["lw8_forref"])
    secs.append(sf[0])
    secs.append(Section(sf[1].table, sf[1].rows,
                        [w * tropf for w in sf[1].weights]))
    adjco2 = _chi_adjust(c.colco2, c.coldry, chiv[1], 3.0, 2.0, 0.65)
    secs.append(_minor_noeta_section(t["lw8_kao_mco2"], c.indminor,
                                     c.minorfrac, tropf * adjco2))
    secs.append(_minor_noeta_section(t["lw8_kbo_mco2"], c.indminor,
                                     c.minorfrac, stratf * adjco2))
    secs.append(_minor_noeta_section(t["lw8_kao_mo3"], c.indminor,
                                     c.minorfrac, tropf * c.colo3))
    secs.append(_minor_noeta_section(t["lw8_kao_mn2o"], c.indminor,
                                     c.minorfrac, tropf * c.coln2o))
    secs.append(_minor_noeta_section(t["lw8_kbo_mn2o"], c.indminor,
                                     c.minorfrac, stratf * c.coln2o))
    secs.append(_const_section(t["lw8_cfc12"], c.wx_cfc12))
    secs.append(_const_section(t["lw8_cfc22adj"], c.wx_cfc22))
    tau, pf = ev_band(secs, [_switch_section(t["lw8_fracrefa"], t["lw8_fracrefb"],
                                     trop, dtype)])
    taus.append(tau)
    fracs.append(pf)

    # ---------------- band 9: h2o+ch4; minor n2o --------------------------
    secs = list(eta_major_section(9, c.colh2o, c.colch4, c.rat_h2och4,
                              c.rat_h2och4_1, has_b=False))
    secs.append(_major_noeta_section(
        c, np.zeros_like(np.asarray(t["lw9_absa"])[:1]), t["lw9_absb"],
        jnp.zeros_like(c.colch4), c.colch4))
    sf = _self_for_sections(c, t["lw9_selfref"], t["lw9_forref"])
    secs.append(sf[0])
    secs.append(Section(sf[1].table, sf[1].rows,
                        [w * tropf for w in sf[1].weights]))
    refm_a = chi_at(1, 3) / chi_at(6, 3)
    _, jmn2o, fmn2o = _eta_index(
        c.colh2o / (c.colh2o + refm_a * c.colch4), 8.0)
    adjn2o = _chi_adjust(c.coln2o, c.coldry, chiv[3], 1.5, 0.5, 0.65)
    secs.append(_minor_eta_section(t["lw9_kao_mn2o"], jmn2o, fmn2o,
                                   c.indminor, c.minorfrac,
                                   tropf * adjn2o))
    secs.append(_minor_noeta_section(t["lw9_kbo_mn2o"], c.indminor,
                                     c.minorfrac, stratf * adjn2o))
    pf_secs, _ = _pfrac_eta_sections(
        c, t["lw9_fracrefa"], np.asarray(t["lw9_fracrefb"]),
        c.colh2o, chi_at(1, 9) / chi_at(6, 9), c.colch4, 8.0)
    tau, pf = ev_band(secs, pf_secs)
    taus.append(tau)
    fracs.append(pf)

    # ---------------- band 10: h2o ----------------------------------------
    secs = [_major_noeta_section(c, t["lw10_absa"], t["lw10_absb"],
                                 c.colh2o, c.colh2o)]
    sf = _self_for_sections(c, t["lw10_selfref"], t["lw10_forref"])
    secs.append(sf[0])
    secs.append(sf[1])
    tau, pf = ev_band(secs, [_switch_section(t["lw10_fracrefa"],
                                     t["lw10_fracrefb"], trop, dtype)])
    taus.append(tau)
    fracs.append(pf)

    # ---------------- band 11: h2o; minor o2 ------------------------------
    secs = [_major_noeta_section(c, t["lw11_absa"], t["lw11_absb"],
                                 c.colh2o, c.colh2o)]
    sf = _self_for_sections(c, t["lw11_selfref"], t["lw11_forref"])
    secs.append(sf[0])
    secs.append(sf[1])
    scaleo2 = c.colo2 * c.scaleminor
    secs.append(_minor_noeta_section(t["lw11_kao_mo2"], c.indminor,
                                     c.minorfrac, tropf * scaleo2))
    secs.append(_minor_noeta_section(t["lw11_kbo_mo2"], c.indminor,
                                     c.minorfrac, stratf * scaleo2))
    tau, pf = ev_band(secs, [_switch_section(t["lw11_fracrefa"],
                                     t["lw11_fracrefb"], trop, dtype)])
    taus.append(tau)
    fracs.append(pf)

    # ---------------- band 12: h2o+co2 (A only) ---------------------------
    secs = list(eta_major_section(12, c.colh2o, c.colco2, c.rat_h2oco2,
                              c.rat_h2oco2_1, has_b=False))
    sf = _self_for_sections(c, t["lw12_selfref"], t["lw12_forref"])
    secs.append(sf[0])
    secs.append(Section(sf[1].table, sf[1].rows,
                        [w * tropf for w in sf[1].weights]))
    pf_secs, _ = _pfrac_eta_sections(
        c, t["lw12_fracrefa"], None,
        c.colh2o, chi_at(1, 10) / chi_at(2, 10), c.colco2, 8.0)
    tau, pf = ev_band(secs, pf_secs)
    taus.append(tau)
    fracs.append(pf)

    # ---------------- band 13: h2o+n2o; minors co2, co; strat o3 ----------
    secs = list(eta_major_section(13, c.colh2o, c.coln2o, c.rat_h2on2o,
                              c.rat_h2on2o_1, has_b=False))
    sf = _self_for_sections(c, t["lw13_selfref"], t["lw13_forref"])
    secs.append(sf[0])
    secs.append(Section(sf[1].table, sf[1].rows,
                        [w * tropf for w in sf[1].weights]))
    refm_a = chi_at(1, 1) / chi_at(4, 1)
    _, jmco2, fmco2 = _eta_index(
        c.colh2o / (c.colh2o + refm_a * c.coln2o), 8.0)
    adjco2 = _chi_adjust(c.colco2, c.coldry, 3.55e-4, 3.0, 2.0, 0.68)
    secs.append(_minor_eta_section(t["lw13_kao_mco2"], jmco2, fmco2,
                                   c.indminor, c.minorfrac,
                                   tropf * adjco2))
    # CO column: IFS supplies no CO (prepare_gases leaves it zero), so the
    # CO term vanishes; kept out for parity.
    secs.append(_minor_noeta_section(t["lw13_kbo_mo3"], c.indminor,
                                     c.minorfrac, stratf * c.colo3))
    pf_secs, _ = _pfrac_eta_sections(
        c, t["lw13_fracrefa"], np.asarray(t["lw13_fracrefb"]),
        c.colh2o, chi_at(1, 5) / chi_at(4, 5), c.coln2o, 8.0)
    tau, pf = ev_band(secs, pf_secs)
    taus.append(tau)
    fracs.append(pf)

    # ---------------- band 14: co2 ----------------------------------------
    secs = [_major_noeta_section(c, t["lw14_absa"], t["lw14_absb"],
                                 c.colco2, c.colco2)]
    sf = _self_for_sections(c, t["lw14_selfref"], t["lw14_forref"])
    secs.append(sf[0])
    secs.append(Section(sf[1].table, sf[1].rows,
                        [w * tropf for w in sf[1].weights]))
    tau, pf = ev_band(secs, [_switch_section(t["lw14_fracrefa"],
                                     t["lw14_fracrefb"], trop, dtype)])
    taus.append(tau)
    fracs.append(pf)

    # ---------------- band 15: n2o+co2; minor n2 (A only) -----------------
    secs = list(eta_major_section(15, c.coln2o, c.colco2, c.rat_n2oco2,
                              c.rat_n2oco2_1, has_b=False))
    sf = _self_for_sections(c, t["lw15_selfref"], t["lw15_forref"])
    secs.append(sf[0])
    secs.append(Section(sf[1].table, sf[1].rows,
                        [w * tropf for w in sf[1].weights]))
    refm_a = chi_at(4, 1) / chi_at(2, 1)
    _, jmn2, fmn2 = _eta_index(
        c.coln2o / (c.coln2o + refm_a * c.colco2), 8.0)
    scalen2 = c.colbrd * c.scaleminor
    secs.append(_minor_eta_section(t["lw15_kao_mn2"], jmn2, fmn2,
                                   c.indminor, c.minorfrac,
                                   tropf * scalen2))
    pf_secs, _ = _pfrac_eta_sections(
        c, t["lw15_fracrefa"], None,
        c.coln2o, chi_at(4, 1) / chi_at(2, 1), c.colco2, 8.0)
    tau, pf = ev_band(secs, pf_secs)
    taus.append(tau)
    fracs.append(pf)

    # ---------------- band 16: h2o+ch4 / ch4 ------------------------------
    secs = list(eta_major_section(16, c.colh2o, c.colch4, c.rat_h2och4,
                              c.rat_h2och4_1, has_b=False))
    secs.append(_major_noeta_section(
        c, np.zeros_like(np.asarray(t["lw16_absa"])[:1]), t["lw16_absb"],
        jnp.zeros_like(c.colch4), c.colch4))
    sf = _self_for_sections(c, t["lw16_selfref"], t["lw16_forref"])
    secs.append(sf[0])
    secs.append(Section(sf[1].table, sf[1].rows,
                        [w * tropf for w in sf[1].weights]))
    pf_secs, _ = _pfrac_eta_sections(
        c, t["lw16_fracrefa"], np.asarray(t["lw16_fracrefb"]),
        c.colh2o, chi_at(1, 6) / chi_at(6, 6), c.colch4, 8.0)
    tau, pf = ev_band(secs, pf_secs)
    taus.append(tau)
    fracs.append(pf)

    tau = jnp.concatenate(taus, axis=0)      # (140, N)
    pfrac = jnp.concatenate(fracs, axis=0)
    tau = tau.reshape(140, ncol, nlev).transpose(1, 2, 0)
    pfrac = pfrac.reshape(140, ncol, nlev).transpose(1, 2, 0)
    return tau, pfrac
