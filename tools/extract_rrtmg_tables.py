#!/usr/bin/env python
"""Extract RRTMG-IFS spectral coefficient tables into a .npz artifact.

The reference distribution ships the large absorption-coefficient tables as
big-endian Fortran unformatted binaries (data/RADRRTM for longwave,
data/RADSRTM for shortwave) and the smaller coefficient tables (Planck
fractions, continuum tables, minor-gas tables, solar source, g-point maps)
as numeric literals inside its Fortran source. This tool reads both,
performs the 256->140 (LW) and 224->112 (SW) g-point reductions, and stores
everything the gas-optics code needs in one compressed npz.

Data provenance (reference files, for parity checking):
  - binary layout: ifsrrtm/rrtm_kgb*.F90 READ statements + yoerrto* dims
  - coefficient literals: ifsrrtm/{rrtm_kgb*,srtm_kgb*,surrtpk,surrtrf,
    surrtftr,susrtm}.F90
  - reduction algorithm: ifsrrtm/rrtm_init_140gp.F90:106-150 (RWGT) and
    ifsrrtm/rrtm_cmbgb*.F90 / srtm_cmbgb*.F90 (weighted combination)
  - fixed Planck fractions: radiation/radiation_ifs_rrtm.F90:809-849

Usage: python tools/extract_rrtmg_tables.py [--reference DIR] [--out FILE]
"""
from __future__ import annotations

import argparse
import os
import re
import sys

import numpy as np

# ---------------------------------------------------------------------------
# Fortran numeric-literal parsing
# ---------------------------------------------------------------------------

_NUM_RE = re.compile(
    r"[+-]?(?:\d+\.?\d*|\.\d+)(?:[eEdD][+-]?\d+)?(?:_\w+)?")


def _parse_num(tok: str) -> float:
    tok = re.sub(r"_\w+$", "", tok)
    return float(tok.replace("d", "e").replace("D", "E"))


def _strip_fortran(text: str) -> str:
    """Remove comments and join continuation lines."""
    lines = []
    for line in text.splitlines():
        # strip trailing comment (no string literals in these data files
        # matter here)
        idx = line.find("!")
        if idx >= 0:
            line = line[:idx]
        lines.append(line)
    text = "\n".join(lines)
    # join continuations: trailing & [newline] leading &
    text = re.sub(r"&\s*\n\s*&?", " ", text)
    return text


_ASSIGN_RE = re.compile(
    r"^\s*(\w+)\s*(\(([^)]*)\))?\s*=\s*(.+?)\s*$", re.MULTILINE)


class FortranData:
    """Collect array assignments from a preprocessed Fortran source."""

    def __init__(self, path: str):
        with open(path) as f:
            self.text = _strip_fortran(f.read())
        # name(lower) -> list of (section_string_or_None, [values])
        self.assigns: dict = {}
        for m in _ASSIGN_RE.finditer(self.text):
            name = m.group(1).lower()
            section = m.group(3)
            rhs = m.group(4)
            if rhs.startswith("(/"):
                body = rhs[2:]
                end = body.find("/)")
                if end >= 0:
                    body = body[:end]
                vals = [_parse_num(t) for t in _NUM_RE.findall(body)]
            else:
                # scalar: plain number, or simple ratio a/b (e.g. SCALEKUR)
                toks = _NUM_RE.findall(rhs)
                clean = rhs.strip()
                if len(toks) == 1 and clean == toks[0]:
                    vals = [_parse_num(toks[0])]
                elif (len(toks) == 2
                      and re.fullmatch(r"\s*".join(
                          [re.escape(toks[0]), "/", re.escape(toks[1])]),
                          clean)):
                    vals = [_parse_num(toks[0]) / _parse_num(toks[1])]
                else:
                    continue  # not a pure numeric assignment
            self.assigns.setdefault(name, []).append((section, vals))

    def scalar(self, name: str) -> float:
        entries = self.assigns[name.lower()]
        assert len(entries) == 1 and len(entries[0][1]) == 1, name
        return entries[0][1][0]

    def array(self, name: str, shape: tuple, lower=None) -> np.ndarray:
        """Reconstruct a Fortran array of given shape (Fortran dim order).

        lower: per-dim lower bounds (default 1). Handles full-array
        assignments `x(:) = (//)`, and sections with one free dim like
        `x(3, :, 2) = (//)` or ranges `x(1:50, 2) = (//)`.
        """
        entries = self.assigns.get(name.lower())
        if entries is None:
            raise KeyError(f"{name} not found")
        lower = lower or (1,) * len(shape)
        out = np.full(shape, np.nan, dtype=np.float64, order="F")
        filled = np.zeros(shape, dtype=bool, order="F")
        for section, vals in entries:
            vals = np.asarray(vals)
            if section is None or section.strip() == ":" * 1 and \
                    len(shape) == 1:
                idx = [slice(None)] * len(shape)
            else:
                parts = [p.strip() for p in section.split(",")]
                assert len(parts) == len(shape), (name, section, shape)
                idx = []
                for d, p in enumerate(parts):
                    if p == ":":
                        idx.append(slice(None))
                    elif ":" in p:
                        a, b = p.split(":")
                        idx.append(slice(int(a) - lower[d],
                                         int(b) - lower[d] + 1))
                    else:
                        idx.append(int(p) - lower[d])
            target = out[tuple(idx)]
            out[tuple(idx)] = vals.reshape(target.shape, order="F")
            filled[tuple(idx)] = True
        assert filled.all(), f"{name}: incomplete assignment coverage"
        return out

    def int_array(self, name: str, n: int) -> np.ndarray:
        return self.array(name, (n,)).astype(np.int64)


# ---------------------------------------------------------------------------
# Binary k-table reading (big-endian Fortran sequential records)
# ---------------------------------------------------------------------------

def read_fortran_records(path: str):
    """Read all sequential records as float64 arrays.

    Uses the native loader (native/fortread.cc via
    ecrad_tpu.utils.native.FortranFile) when built; pure-Python
    otherwise. Both implement the same framing the reference's Fortran
    READ relies on (4-byte big-endian record markers)."""
    try:
        from ecrad_tpu.utils.native import FortranFile
        records = []
        with FortranFile(path) as f:
            while True:
                try:
                    records.append(f.read_f64())
                except EOFError:
                    break
        return records
    except ImportError:
        pass
    records = []
    with open(path, "rb") as f:
        while True:
            head = f.read(4)
            if len(head) < 4:
                break
            n = int.from_bytes(head, "big")
            payload = f.read(n)
            tail = f.read(4)
            assert int.from_bytes(tail, "big") == n, "record marker mismatch"
            records.append(np.frombuffer(payload, dtype=">f8"))
    return records


# Per-band binary record contents: (ka_shape, kb_shape) in Fortran dim order,
# None if absent. From yoerrto*/yoesrta* declarations + READ statements.
LW_BIN = {
    1: ((5, 13, 16), (5, 47, 16)),
    2: ((5, 13, 16), (5, 47, 16)),
    3: ((9, 5, 13, 16), (5, 5, 47, 16)),
    4: ((9, 5, 13, 16), (5, 5, 47, 16)),
    5: ((9, 5, 13, 16), (5, 5, 47, 16)),
    6: ((5, 13, 16), None),
    7: ((9, 5, 13, 16), (5, 47, 16)),
    8: ((5, 13, 16), (5, 47, 16)),
    9: ((9, 5, 13, 16), (5, 47, 16)),
    10: ((5, 13, 16), (5, 47, 16)),
    11: ((5, 13, 16), (5, 47, 16)),
    12: ((9, 5, 13, 16), None),
    13: ((9, 5, 13, 16), None),
    14: ((5, 13, 16), (5, 47, 16)),
    15: ((9, 5, 13, 16), None),
    16: ((9, 5, 13, 16), (5, 47, 16)),
}
SW_BIN = {
    16: ((9, 5, 13, 16), (5, 47, 16)),
    17: ((9, 5, 13, 16), (5, 5, 47, 16)),
    18: ((9, 5, 13, 16), (5, 47, 16)),
    19: ((9, 5, 13, 16), (5, 47, 16)),
    20: ((5, 13, 16), (5, 47, 16)),
    21: ((9, 5, 13, 16), (5, 5, 47, 16)),
    22: ((9, 5, 13, 16), (5, 47, 16)),
    23: ((5, 13, 16), None),
    24: ((9, 5, 13, 16), (5, 47, 16)),
    25: ((5, 13, 16), None),
    # band 26 has no binary record
    27: ((5, 13, 16), (5, 47, 16)),
    28: ((9, 5, 13, 16), (5, 5, 47, 16)),
    29: ((5, 13, 16), (5, 47, 16)),
}

# Small tables in each LW kgb source: name -> Fortran shape
LW_SRC = {
    1: {"fracrefao": (16,), "fracrefbo": (16,), "kao_mn2": (19, 16),
        "kbo_mn2": (19, 16), "selfrefo": (10, 16), "forrefo": (4, 16)},
    2: {"fracrefao": (16,), "fracrefbo": (16,), "selfrefo": (10, 16),
        "forrefo": (4, 16)},
    3: {"fracrefao": (16, 9), "fracrefbo": (16, 5),
        "kao_mn2o": (9, 19, 16), "kbo_mn2o": (5, 19, 16),
        "selfrefo": (10, 16), "forrefo": (4, 16)},
    4: {"fracrefao": (16, 9), "fracrefbo": (16, 5), "selfrefo": (10, 16),
        "forrefo": (4, 16)},
    5: {"fracrefao": (16, 9), "fracrefbo": (16, 5),
        "kao_mo3": (9, 19, 16), "ccl4o": (16,), "selfrefo": (10, 16),
        "forrefo": (4, 16)},
    6: {"fracrefao": (16,), "kao_mco2": (19, 16), "cfc11adjo": (16,),
        "cfc12o": (16,), "selfrefo": (10, 16), "forrefo": (4, 16)},
    7: {"fracrefao": (16, 9), "fracrefbo": (16,),
        "kao_mco2": (9, 19, 16), "kbo_mco2": (19, 16),
        "selfrefo": (10, 16), "forrefo": (4, 16)},
    8: {"fracrefao": (16,), "fracrefbo": (16,), "kao_mco2": (19, 16),
        "kao_mn2o": (19, 16), "kao_mo3": (19, 16), "kbo_mco2": (19, 16),
        "kbo_mn2o": (19, 16), "cfc12o": (16,), "cfc22adjo": (16,),
        "selfrefo": (10, 16), "forrefo": (4, 16)},
    9: {"fracrefao": (16, 9), "fracrefbo": (16,),
        "kao_mn2o": (9, 19, 16), "kbo_mn2o": (19, 16),
        "selfrefo": (10, 16), "forrefo": (4, 16)},
    10: {"fracrefao": (16,), "fracrefbo": (16,), "selfrefo": (10, 16),
         "forrefo": (4, 16)},
    11: {"fracrefao": (16,), "fracrefbo": (16,), "kao_mo2": (19, 16),
         "kbo_mo2": (19, 16), "selfrefo": (10, 16), "forrefo": (4, 16)},
    12: {"fracrefao": (16, 9), "selfrefo": (10, 16), "forrefo": (4, 16)},
    13: {"fracrefao": (16, 9), "fracrefbo": (16,),
         "kao_mco2": (9, 19, 16), "kao_mco": (9, 19, 16),
         "kbo_mo3": (19, 16), "selfrefo": (10, 16), "forrefo": (4, 16)},
    14: {"fracrefao": (16,), "fracrefbo": (16,), "selfrefo": (10, 16),
         "forrefo": (4, 16)},
    15: {"fracrefao": (16, 9), "kao_mn2": (9, 19, 16),
         "selfrefo": (10, 16), "forrefo": (4, 16)},
    16: {"fracrefao": (16, 9), "fracrefbo": (16,), "selfrefo": (10, 16),
         "forrefo": (4, 16)},
}

# SW source tables per band (names as in srtm_kgb*/yoesrta*)
SW_SRC = {
    16: {"sfluxref": (16,), "selfref": (10, 16), "forref": (3, 16),
         "rayl": (), "strrat1": (), "layreffr": ()},
    17: {"sfluxref": (16, 5), "selfref": (10, 16), "forref": (4, 16),
         "rayl": (), "strrat": (), "layreffr": ()},
    18: {"sfluxref": (16, 9), "selfref": (10, 16), "forref": (3, 16),
         "rayl": (), "strrat": (), "layreffr": ()},
    19: {"sfluxref": (16, 9), "selfref": (10, 16), "forref": (3, 16),
         "rayl": (), "strrat": (), "layreffr": ()},
    20: {"sfluxref": (16,), "absch4": (16,), "selfref": (10, 16),
         "forref": (4, 16), "rayl": (), "layreffr": ()},
    21: {"sfluxref": (16, 9), "selfref": (10, 16), "forref": (4, 16),
         "rayl": (), "strrat": (), "layreffr": ()},
    22: {"sfluxref": (16, 9), "selfref": (10, 16), "forref": (3, 16),
         "rayl": (), "strrat": (), "layreffr": ()},
    23: {"sfluxref": (16,), "rayl": (16,), "selfref": (10, 16),
         "forref": (3, 16), "givfac": (), "layreffr": ()},
    24: {"sfluxref": (16, 9), "abso3a": (16,), "abso3b": (16,),
         "rayla": (16, 9), "raylb": (16,), "selfref": (10, 16),
         "forref": (3, 16), "strrat": (), "layreffr": ()},
    25: {"sfluxref": (16,), "rayl": (16,), "abso3a": (16,),
         "abso3b": (16,), "layreffr": ()},
    26: {"sfluxref": (16,), "rayl": (16,)},
    27: {"sfluxref": (16,), "rayl": (16,), "scalekur": (),
         "layreffr": ()},
    28: {"sfluxref": (16, 5), "rayl": (), "strrat": (), "layreffr": ()},
    29: {"sfluxref": (16,), "absh2o": (16,), "absco2": (16,),
         "selfref": (10, 16), "forref": (4, 16), "rayl": (),
         "layreffr": ()},
}

# Arrays reduced with plain (unweighted) sums; everything else uses RWGT.
PLAIN_SUM = {"fracrefao", "fracrefbo", "sfluxref"}


def reduce_g(arr: np.ndarray, band0: int, ngn: np.ndarray,
             igc_start: int, ngc: int, rwgt: np.ndarray,
             weighted: bool, g_axis: int) -> np.ndarray:
    """Combine 16 raw g-points into ngc groups along g_axis.

    band0: 0-based band index within its spectrum (for rwgt offset).
    ngn: group sizes for this band (len ngc). rwgt: flat per-raw-g weights.
    """
    out_slices = []
    ipr = 0
    for igc in range(ngc):
        n = int(ngn[igc])
        sl = [slice(None)] * arr.ndim
        sl[g_axis] = slice(ipr, ipr + n)
        chunk = np.take(arr, range(ipr, ipr + n), axis=g_axis)
        if weighted:
            w = rwgt[band0 * 16 + ipr: band0 * 16 + ipr + n]
            shape = [1] * arr.ndim
            shape[g_axis] = n
            chunk = chunk * w.reshape(shape)
        out_slices.append(chunk.sum(axis=g_axis, keepdims=True))
        ipr += n
    assert ipr == 16, f"group sizes sum to {ipr}"
    return np.concatenate(out_slices, axis=g_axis)


def compute_rwgt(wt: np.ndarray, ngc: np.ndarray, ngn_flat: np.ndarray,
                 nbands: int) -> np.ndarray:
    """RWGT per rrtm_init_140gp.F90:106-150 / srtm_init.F90."""
    rwgt = np.ones(nbands * 16)
    igcsm = 0
    for ib in range(nbands):
        if ngc[ib] < 16:
            wtsm = np.zeros(int(ngc[ib]))
            iprsm = 0
            for igc in range(int(ngc[ib])):
                n = int(ngn_flat[igcsm])
                igcsm += 1
                wtsm[igc] = wt[iprsm:iprsm + n].sum()
                iprsm += n
            # map raw g -> its group for this band
            iprsm = 0
            gmap = np.zeros(16, dtype=int)
            k = 0
            igcsm2 = igcsm - int(ngc[ib])
            for igc in range(int(ngc[ib])):
                n = int(ngn_flat[igcsm2 + igc])
                gmap[k:k + n] = igc
                k += n
            for ig in range(16):
                rwgt[ib * 16 + ig] = wt[ig] / wtsm[gmap[ig]]
        else:
            igcsm += 16
    return rwgt


def flatten_major(arr: np.ndarray) -> np.ndarray:
    """Reduced k-table (Fortran dims [neta,]njt,njp,ng) -> (nrows, ng) with
    row = ((jp*njt)+jt)*neta + eta, matching the reference's flattened
    ABSA/ABSB index arithmetic (IND0 = ((JP-1)*5+(JT-1))*NSP + JS)."""
    if arr.ndim == 3:  # (jt, jp, g)
        njt, njp, ng = arr.shape
        return arr.transpose(1, 0, 2).reshape(njp * njt, ng)
    elif arr.ndim == 4:  # (eta, jt, jp, g)
        neta, njt, njp, ng = arr.shape
        return arr.transpose(2, 1, 0, 3).reshape(njp * njt * neta, ng)
    raise ValueError(arr.shape)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", default=os.environ.get(
        "ECRAD_REFERENCE_DIR", "/root/reference"))
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "..", "ecrad_tpu", "data",
        "rrtmg_tables.npz"))
    args = ap.parse_args()
    ref = args.reference
    ifsrrtm = os.path.join(ref, "ifsrrtm")

    out: dict = {}

    # ---- g-point maps & weights -----------------------------------------
    ftr = FortranData(os.path.join(ifsrrtm, "surrtftr.F90"))
    ngc_lw = ftr.int_array("igc140", 16)
    ngn_lw = ftr.int_array("ign140", 140)
    ngb_lw = ftr.int_array("igb140", 140)
    wt_lw = ftr.array("wt", (16,))
    out["lw_ngc"] = ngc_lw
    out["lw_ngn"] = ngn_lw
    out["lw_band_from_g"] = ngb_lw  # 1-based band index per reduced g
    rwgt_lw = compute_rwgt(wt_lw, ngc_lw, ngn_lw, 16)

    sus = FortranData(os.path.join(ifsrrtm, "susrtm.F90"))
    ngc_sw = sus.int_array("igc112", 14)
    ngn_sw = sus.int_array("ign112", 112)
    ngb_sw = sus.int_array("igb112", 112)
    wt_sw = sus.array("wt", (16,))
    out["sw_ngc"] = ngc_sw
    out["sw_ngn"] = ngn_sw
    out["sw_band_from_g"] = ngb_sw - 15  # 1-based within SW (16..29 -> 1..14)
    rwgt_sw = compute_rwgt(wt_sw, ngc_sw, ngn_sw, 14)

    # ---- reference pressure/temperature/composition profiles ------------
    rf = FortranData(os.path.join(ifsrrtm, "surrtrf.F90"))
    out["preflog"] = rf.array("preflog", (59,))
    out["tref"] = rf.array("tref", (59,))
    out["chi_mls"] = rf.array("chi_mls", (7, 59))  # (gas, jp)

    # ---- Planck tables ----------------------------------------------------
    pk = FortranData(os.path.join(ifsrrtm, "surrtpk.F90"))
    out["totplnk"] = pk.array("totplnk", (181, 16))
    out["delwave"] = pk.array("delwave", (16,))
    out["lw_nspa"] = pk.int_array("nspa", 16)
    out["lw_nspb"] = pk.int_array("nspb", 16)
    out["sw_nspa"] = sus.int_array("nspa", 14)
    out["sw_nspb"] = sus.int_array("nspb", 14)

    # ---- LW binary + per-band tables --------------------------------------
    lw_records = read_fortran_records(os.path.join(ref, "data", "RADRRTM"))
    assert len(lw_records) == 16
    for band in range(1, 17):
        b0 = band - 1
        ngc = int(ngc_lw[b0])
        grp_off = int(ngc_lw[:b0].sum())
        ngn_band = ngn_lw[grp_off:grp_off + ngc]
        src = FortranData(os.path.join(ifsrrtm, f"rrtm_kgb{band}.F90"))

        ka_shape, kb_shape = LW_BIN[band]
        rec = lw_records[b0]
        n_ka = int(np.prod(ka_shape))
        ka = rec[:n_ka].reshape(ka_shape, order="F")
        red = reduce_g(ka, b0, ngn_band, grp_off, ngc, rwgt_lw,
                       True, ka.ndim - 1)
        out[f"lw{band}_absa"] = flatten_major(red).astype(np.float64)
        if kb_shape is not None:
            kb = rec[n_ka:n_ka + int(np.prod(kb_shape))].reshape(
                kb_shape, order="F")
            red = reduce_g(kb, b0, ngn_band, grp_off, ngc, rwgt_lw,
                           True, kb.ndim - 1)
            out[f"lw{band}_absb"] = flatten_major(red).astype(np.float64)

        # raw module names (yoerrto*) -> canonical output names
        lw_renames = {
            "fracrefao": "fracrefa", "fracrefbo": "fracrefb",
            "selfrefo": "selfref", "forrefo": "forref",
            "ccl4o": "ccl4", "cfc11adjo": "cfc11adj",
            "cfc12o": "cfc12", "cfc22adjo": "cfc22adj",
        }
        for name, shape in LW_SRC[band].items():
            arr = src.array(name, shape)
            weighted = name not in PLAIN_SUM
            # g axis: first dim for fracref (16,...) and 1-D tables,
            # else last
            if name.startswith("fracref") or shape == (16,):
                g_axis = 0
            else:
                g_axis = len(shape) - 1
            red = reduce_g(arr, b0, ngn_band, grp_off, ngc, rwgt_lw,
                           weighted, g_axis)
            out[f"lw{band}_{lw_renames.get(name, name)}"] = red

    # ---- SW binary + per-band tables --------------------------------------
    sw_records = read_fortran_records(os.path.join(ref, "data", "RADSRTM"))
    sw_bands_with_bin = [b for b in range(16, 30) if b in SW_BIN]
    assert len(sw_records) == len(sw_bands_with_bin), (
        len(sw_records), len(sw_bands_with_bin))
    rec_of_band = dict(zip(sw_bands_with_bin, sw_records))
    for band in range(16, 30):
        b0 = band - 16
        ngc = int(ngc_sw[b0])
        grp_off = int(ngc_sw[:b0].sum())
        ngn_band = ngn_sw[grp_off:grp_off + ngc]
        src = FortranData(os.path.join(ifsrrtm, f"srtm_kgb{band}.F90"))

        if band in SW_BIN:
            ka_shape, kb_shape = SW_BIN[band]
            rec = rec_of_band[band]
            n_ka = int(np.prod(ka_shape))
            ka = rec[:n_ka].reshape(ka_shape, order="F")
            red = reduce_g(ka, b0, ngn_band, grp_off, ngc, rwgt_sw,
                           True, ka.ndim - 1)
            out[f"sw{band}_absa"] = flatten_major(red)
            if kb_shape is not None:
                kb = rec[n_ka:n_ka + int(np.prod(kb_shape))].reshape(
                    kb_shape, order="F")
                red = reduce_g(kb, b0, ngn_band, grp_off, ngc, rwgt_sw,
                               True, kb.ndim - 1)
                out[f"sw{band}_absb"] = flatten_major(red)

        for name, shape in SW_SRC[band].items():
            if shape == ():
                val = src.scalar(name)
                out[f"sw{band}_{name}"] = np.float64(val)
                continue
            arr = src.array(name, shape)
            weighted = name not in PLAIN_SUM
            g_axis = 0 if shape[0] == 16 else len(shape) - 1
            red = reduce_g(arr, b0, ngn_band, grp_off, ngc, rwgt_sw,
                           weighted, g_axis)
            out[f"sw{band}_{name}"] = red

    # ---- fixed Planck fractions (radiation_ifs_rrtm.F90 planck_function) --
    bridge = FortranData(os.path.join(ref, "radiation",
                                      "radiation_ifs_rrtm.F90"))
    # the 'frac' parameter is a reshape literal; grab its 140 values
    m = re.search(r"frac\s*=\s*reshape\s*\(\s*\(/(.*?)/\)",
                  bridge.text, re.DOTALL)
    assert m, "fixed PFRAC table not found"
    vals = [_parse_num(t) for t in _NUM_RE.findall(m.group(1))]
    # trailing shape (/ 1,140 /) values excluded by the /) cut above
    assert len(vals) == 140, len(vals)
    out["lw_fixed_pfrac"] = np.asarray(vals)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **{k: np.asarray(v) for k, v in
                                     out.items()})
    total = sum(np.asarray(v).nbytes for v in out.values())
    print(f"Wrote {len(out)} arrays ({total/1e6:.1f} MB raw) to {args.out}")
    # quick sanity report
    for key in ("lw_ngc", "sw_ngc"):
        print(key, out[key], "sum", out[key].sum())


if __name__ == "__main__":
    sys.exit(main())
