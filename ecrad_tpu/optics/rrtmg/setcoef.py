"""Gas preparation + interpolation coefficients for RRTMG-IFS gas optics.

Vectorized JAX reimplementation of the reference semantics:
  - rrtm_prepare_gases: ifsrrtm/rrtm_prepare_gases.F90 (column densities)
  - rrtm_setcoef_140gp: ifsrrtm/rrtm_setcoef_140gp.F90 (JP/JT/FAC/continuum)
  - srtm_setcoef:       ifsrrtm/srtm_setcoef.F90 (SW subset)

All arrays are (ncol, nlev) with the level axis in RRTMG orientation
(index 0 = surface). The tropopause split is a per-cell mask (log p > 4.56)
instead of a per-column layer count — identical semantics since pressure
decreases monotonically with height, but branch-free.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def chi_rows_at(chi, idx0):
    """All-gas chi_mls values at a per-cell pressure index.

    chi (ngas, 59); idx0 int32 (any shape, 0-based). Returns
    (ngas,) + idx0.shape. One exact (HIGHEST) one-hot product instead
    of per-gas dynamic takes."""
    nrow = chi.shape[1]
    flat = jnp.clip(idx0.reshape(-1), 0, nrow - 1)
    onehot = (flat[None, :] == jnp.arange(nrow)[:, None]).astype(chi.dtype)
    vals = jnp.dot(chi, onehot, precision=jax.lax.Precision.HIGHEST)
    return vals.reshape((chi.shape[0],) + idx0.shape)

# Molar masses as hard-coded in rrtm_prepare_gases.F90 (DATA statements)
_AMD = 28.970
_AMW = 18.0154
_AMCO2 = 44.011
_AMO = 47.9982
_AMCH4 = 16.043
_AMN2O = 44.013
_AMC11 = 137.3686
_AMC12 = 120.9140
_AMC22 = 86.4690
_AMCL4 = 153.8230
_AVGDRO = 6.02214e23
_GRAV_CGS = 9.80665e2  # RG * 1e2 (cm s-2)


class GasColumns(NamedTuple):
    """Column densities (molecules/cm^2 scaled) per rrtm_prepare_gases."""
    pavel: jnp.ndarray      # layer pressure (hPa), surface-first
    tavel: jnp.ndarray      # layer temperature (K)
    coldry: jnp.ndarray     # dry air column density
    wbrodl: jnp.ndarray     # broadening gas column
    colh2o_raw: jnp.ndarray  # WKL(1) molecules/cm2 (unscaled)
    colco2_raw: jnp.ndarray
    colo3_raw: jnp.ndarray
    coln2o_raw: jnp.ndarray
    colch4_raw: jnp.ndarray
    colo2_raw: jnp.ndarray
    wx_ccl4: jnp.ndarray    # trace cross-section amounts (scaled 1e-20)
    wx_cfc11: jnp.ndarray
    wx_cfc12: jnp.ndarray
    wx_cfc22: jnp.ndarray


class Coeffs(NamedTuple):
    """Everything taumol needs, all (ncol, nlev) surface-first."""
    tropo: jnp.ndarray          # bool: log(pavel) > 4.56 (troposphere)
    jp: jnp.ndarray             # 1..58 (1-based, as in Fortran)
    jt: jnp.ndarray             # 1..4
    jt1: jnp.ndarray
    fac00: jnp.ndarray
    fac01: jnp.ndarray
    fac10: jnp.ndarray
    fac11: jnp.ndarray
    indself: jnp.ndarray        # 1..9
    selffac: jnp.ndarray
    selffrac: jnp.ndarray
    indfor: jnp.ndarray         # 1..3
    forfac: jnp.ndarray
    forfrac: jnp.ndarray
    indminor: jnp.ndarray       # 1..18
    minorfrac: jnp.ndarray
    # SW pressure-interpolation factors (no fp clamp: srtm_setcoef.F90
    # recomputes these without the Ukkonen LW stability clamp)
    fac00_sw: jnp.ndarray
    fac01_sw: jnp.ndarray
    fac10_sw: jnp.ndarray
    fac11_sw: jnp.ndarray
    scaleminor: jnp.ndarray
    scaleminorn2: jnp.ndarray
    colh2o: jnp.ndarray         # 1e-20-scaled column amounts
    colco2: jnp.ndarray
    colo3: jnp.ndarray
    coln2o: jnp.ndarray
    colch4: jnp.ndarray
    colo2: jnp.ndarray
    colbrd: jnp.ndarray
    colmol: jnp.ndarray
    coldry: jnp.ndarray
    rat_h2oco2: jnp.ndarray
    rat_h2oco2_1: jnp.ndarray
    rat_h2oo3: jnp.ndarray
    rat_h2oo3_1: jnp.ndarray
    rat_h2on2o: jnp.ndarray
    rat_h2on2o_1: jnp.ndarray
    rat_h2och4: jnp.ndarray
    rat_h2och4_1: jnp.ndarray
    rat_n2oco2: jnp.ndarray
    rat_n2oco2_1: jnp.ndarray
    rat_o3co2: jnp.ndarray
    rat_o3co2_1: jnp.ndarray
    pavel: jnp.ndarray
    wx_ccl4: jnp.ndarray
    wx_cfc11: jnp.ndarray
    wx_cfc12: jnp.ndarray
    wx_cfc22: jnp.ndarray


def prepare_gases(pressure_hl, pressure_fl, temperature_fl,
                  q, co2, ch4, n2o, cfc11, cfc12, hcfc22, ccl4, o3,
                  dtype=jnp.float32) -> GasColumns:
    """Column densities. Inputs are (ncol, nlev[+1]) in ecRad orientation
    (TOA first); outputs are surface-first like the reference
    (rrtm_prepare_gases.F90: PAVEL(JK) = PAP(KLEV-JK+1))."""
    flip = lambda x: x[:, ::-1].astype(dtype)

    pavel = flip(pressure_fl) / 100.0          # hPa
    tavel = flip(temperature_fl)
    # half-level pressure, surface-first: PZ(0)=surface, PZ(nlev)=TOA
    pz = pressure_hl[:, ::-1].astype(dtype) / 100.0  # (ncol, nlev+1)

    wkl1 = flip(q) * (_AMD / _AMW)       # VMR-like ratios
    wkl2 = flip(co2) * (_AMD / _AMCO2)
    wkl3 = flip(o3) * (_AMD / _AMO)
    wkl4 = flip(n2o) * (_AMD / _AMN2O)
    wkl6 = flip(ch4) * (_AMD / _AMCH4)
    wkl7 = jnp.full_like(wkl1, 0.209488)  # O2 hard-coded (reference :132)

    amm = (1.0 - wkl1) * _AMD + wkl1 * _AMW
    dp = pz[:, :-1] - pz[:, 1:]           # positive, surface-first
    coldry = dp * 1.0e3 * _AVGDRO / (_GRAV_CGS * amm * (1.0 + wkl1))

    wx1 = coldry * flip(ccl4) * (_AMD / _AMCL4) * 1.0e-20
    wx2 = coldry * flip(cfc11) * (_AMD / _AMC11) * 1.0e-20
    wx3 = coldry * flip(cfc12) * (_AMD / _AMC12) * 1.0e-20
    wx4 = coldry * flip(hcfc22) * (_AMD / _AMC22) * 1.0e-20

    summol = wkl2 + wkl3 + wkl4 + wkl6 + wkl7
    wbrodl = coldry * (1.0 - summol)

    return GasColumns(
        pavel=pavel, tavel=tavel, coldry=coldry, wbrodl=wbrodl,
        colh2o_raw=coldry * wkl1, colco2_raw=coldry * wkl2,
        colo3_raw=coldry * wkl3, coln2o_raw=coldry * wkl4,
        colch4_raw=coldry * wkl6, colo2_raw=coldry * wkl7,
        wx_ccl4=wx1, wx_cfc11=wx2, wx_cfc12=wx3, wx_cfc22=wx4,
    )


def setcoef(gc: GasColumns, preflog: np.ndarray, tref: np.ndarray,
            chi_mls: np.ndarray) -> Coeffs:
    """Interpolation indices & factors (rrtm_setcoef_140gp.F90:86-278).

    preflog/tref: (59,) reference profiles; chi_mls: (7, 59).
    """
    preflog = jnp.asarray(preflog, gc.pavel.dtype)
    tref = jnp.asarray(tref, gc.pavel.dtype)
    chi = jnp.asarray(chi_mls, gc.pavel.dtype)

    plog = jnp.log(gc.pavel)
    jp = jnp.clip(jnp.floor(36.0 - 5.0 * (plog + 0.04)).astype(jnp.int32),
                  1, 58)
    jp1 = jp + 1
    fp_raw = 5.0 * (preflog[jp - 1] - plog)
    # Ukkonen fork stability clamp, LW only (rrtm_setcoef_140gp.F90:110)
    fp = jnp.clip(fp_raw, -1.0, 1.0)

    def t_index(jref):
        raw = 3.0 + (gc.tavel - tref[jref - 1]) / 15.0
        idx = jnp.clip(jnp.floor(raw).astype(jnp.int32), 1, 4)
        frac = (gc.tavel - tref[jref - 1]) / 15.0 - (idx - 3).astype(
            gc.tavel.dtype)
        return idx, frac

    jt, ft = t_index(jp)
    jt1, ft1 = t_index(jp1)

    water = gc.colh2o_raw / gc.coldry
    scalefac = gc.pavel * (296.0 / 1013.0) / gc.tavel
    tropo = plog > 4.56

    forfac = scalefac / (1.0 + water)
    # foreign continuum: tropo vs strat index/fraction
    factor_t = (332.0 - gc.tavel) / 36.0
    indfor_t = jnp.clip(jnp.floor(factor_t).astype(jnp.int32), 1, 2)
    forfrac_t = factor_t - indfor_t.astype(gc.tavel.dtype)
    factor_s = (gc.tavel - 188.0) / 36.0
    indfor = jnp.where(tropo, indfor_t, 3)
    forfrac = jnp.where(tropo, forfrac_t, factor_s - 1.0)

    # self continuum (troposphere only; strat values unused by taumol)
    selffac = water * forfac
    factor_self = (gc.tavel - 188.0) / 7.2
    indself = jnp.clip(jnp.floor(factor_self).astype(jnp.int32) - 7, 1, 9)
    selffrac = factor_self - (indself + 7).astype(gc.tavel.dtype)

    scaleminor = gc.pavel / gc.tavel
    scaleminorn2 = scaleminor * (
        gc.wbrodl / (gc.coldry + gc.colh2o_raw))
    factor_m = (gc.tavel - 180.8) / 7.2
    indminor = jnp.clip(jnp.floor(factor_m).astype(jnp.int32), 1, 18)
    minorfrac = factor_m - indminor.astype(gc.tavel.dtype)

    # binary species ratios from climatology at jp and jp+1; all gases
    # in two one-hot products rather than 10+ serial gathers
    chi_jp = chi_rows_at(chi, jp - 1)
    chi_jp1 = chi_rows_at(chi, jp1 - 1)

    def rat(i, j, at):
        return at[i - 1] / at[j - 1]

    colh2o = 1.0e-20 * gc.colh2o_raw
    colco2 = 1.0e-20 * gc.colco2_raw
    colo3 = 1.0e-20 * gc.colo3_raw
    coln2o = 1.0e-20 * gc.coln2o_raw
    colch4 = 1.0e-20 * gc.colch4_raw
    colo2 = 1.0e-20 * gc.colo2_raw
    colbrd = 1.0e-20 * gc.wbrodl
    zerofloor = 1.0e-32 * gc.coldry
    colco2 = jnp.where(colco2 == 0.0, zerofloor, colco2)
    coln2o = jnp.where(coln2o == 0.0, zerofloor, coln2o)
    colch4 = jnp.where(colch4 == 0.0, zerofloor, colch4)
    colo2 = jnp.where(colo2 == 0.0, zerofloor, colo2)  # SW (srtm_setcoef)
    colmol = 1.0e-20 * gc.coldry + colh2o              # SW

    compfp = 1.0 - fp
    compfp_sw = 1.0 - fp_raw
    return Coeffs(
        tropo=tropo, jp=jp, jt=jt, jt1=jt1,
        fac00=compfp * (1.0 - ft), fac10=compfp * ft,
        fac01=fp * (1.0 - ft1), fac11=fp * ft1,
        indself=indself, selffac=colh2o * selffac, selffrac=selffrac,
        indfor=indfor, forfac=colh2o * forfac, forfrac=forfrac,
        indminor=indminor, minorfrac=minorfrac,
        fac00_sw=compfp_sw * (1.0 - ft), fac10_sw=compfp_sw * ft,
        fac01_sw=fp_raw * (1.0 - ft1), fac11_sw=fp_raw * ft1,
        scaleminor=scaleminor, scaleminorn2=scaleminorn2,
        colh2o=colh2o, colco2=colco2, colo3=colo3, coln2o=coln2o,
        colch4=colch4, colo2=colo2, colbrd=colbrd, colmol=colmol,
        coldry=gc.coldry,
        rat_h2oco2=rat(1, 2, chi_jp), rat_h2oco2_1=rat(1, 2, chi_jp1),
        rat_h2oo3=rat(1, 3, chi_jp), rat_h2oo3_1=rat(1, 3, chi_jp1),
        rat_h2on2o=rat(1, 4, chi_jp), rat_h2on2o_1=rat(1, 4, chi_jp1),
        rat_h2och4=rat(1, 6, chi_jp), rat_h2och4_1=rat(1, 6, chi_jp1),
        rat_n2oco2=rat(4, 2, chi_jp), rat_n2oco2_1=rat(4, 2, chi_jp1),
        rat_o3co2=rat(3, 2, chi_jp), rat_o3co2_1=rat(3, 2, chi_jp1),
        pavel=gc.pavel,
        wx_ccl4=gc.wx_ccl4, wx_cfc11=gc.wx_cfc11, wx_cfc12=gc.wx_cfc12,
        wx_cfc22=gc.wx_cfc22,
    )
